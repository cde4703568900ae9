"""Progress estimation for long computations.

Host-side analogue of the reference's dask ``EstimatingProgressBar``
(``africanus/util/dask_util.py:151``): wraps an iterable of work items
(e.g. channel bands, row blocks, solver iterations driven from the host)
and reports an estimated total runtime from completed-item times.

A copy of ``africanus_tpu/utils/progress.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys
import time

__all__ = ["EstimatingProgressBar", "progress"]


def _fmt_time(seconds):
    m, s = divmod(int(seconds), 60)
    h, m = divmod(m, 60)
    return f"{h:d}:{m:02d}:{s:02d}"


class EstimatingProgressBar:
    """Tracks per-item completion times and estimates total runtime.

    Usage::

        bar = EstimatingProgressBar(total=nblocks)
        for block in blocks:
            process(block)
            bar.update()
    """

    def __init__(self, total, out=sys.stderr, minimum=0.5, width=40):
        self.total = total
        self.done = 0
        self.out = out
        self.minimum = minimum
        self.width = width
        self.start = time.time()
        self._last_draw = 0.0

    def update(self, n=1):
        self.done += n
        now = time.time()
        if now - self._last_draw < self.minimum and self.done < self.total:
            return
        self._last_draw = now
        elapsed = now - self.start
        rate = self.done / elapsed if elapsed > 0 else 0.0
        estimate = self.total / rate if rate > 0 else float("inf")
        frac = self.done / self.total if self.total else 1.0
        filled = int(self.width * frac)
        bar = "#" * filled + "-" * (self.width - filled)
        self.out.write(
            f"\r[{bar}] {self.done}/{self.total} "
            f"elapsed {_fmt_time(elapsed)} "
            f"/ estimated {_fmt_time(estimate)}"
        )
        if self.done >= self.total:
            self.out.write("\n")
        self.out.flush()


def progress(iterable, total=None, **kwargs):
    """Wrap an iterable with an :class:`EstimatingProgressBar`
    (remaining-time estimate from completed-item durations, the
    reference's dask callback re-imagined for plain loops —
    ``util/dask_util.py:151``). ``total`` defaults to ``len(list)``.
    """
    items = list(iterable) if total is None else iterable
    total = len(items) if total is None else total
    bar = EstimatingProgressBar(total, **kwargs)
    for item in items:
        yield item
        bar.update()
