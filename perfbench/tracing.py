"""The traced sub-window of a ``--trace 1`` run, read into a
:class:`Record` that the per-layer metrics read.

``torch.profiler`` traces a few calls after the measured window, in the
same closed loop; its Chrome trace is read back for the device's
operations (kernels, copies, fills) and the host's (torch operations and
CUDA runtime calls), all on the profiler's one clock, within the
``perfbench.window`` annotation that brackets the calls.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import tempfile

import torch

__all__ = ["Record", "traced_window", "read_trace"]

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def short_name(name):
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):  # the '(' of the arguments, not a template's
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut]


def base_name(name):
    """A kernel's own name: no namespace, no template arguments."""
    return short_name(name).split("<", 1)[0].rsplit("::", 1)[-1]


def _union(intervals):
    """Disjoint, sorted (start, end) covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Record:
    """What a traced sub-window holds. Times in seconds.

    ``device_ops``: (name, start, duration) of each device operation in
    the window, ``kernels`` those of kernels alone; ``host_ops``: (name,
    start, duration) of the host's torch operations and runtime calls;
    ``calls`` in the window; ``window_s``, ``busy_s`` (the union of the
    device operations). The run adds ``issue_s`` (each call's host time
    to return, from the measured window), ``peak_bytes`` and ``shapes``
    (the entry's problem sizes, from which ``perfbench/work/`` takes each
    kernel's)."""

    def __init__(self, device_ops, kernels, host_ops, calls, w0, w1):
        self.device_ops, self.kernels, self.host_ops = device_ops, kernels, host_ops
        self.calls, self.w0, self.w1 = calls, w0, w1
        self.window_s = w1 - w0
        self.busy_spans = _union((s, s + d) for _, s, d in device_ops)
        self.busy_s = sum(e - s for s, e in self.busy_spans)
        self.issue_s, self.peak_bytes, self.shapes = [], 0, {}

    def kernel_seconds(self, match):
        """Device seconds of the kernels whose own name (:func:`base_name`)
        ``match`` accepts."""
        return sum(d for n, _, d in self.kernels if match(base_name(n)))

    def gaps(self):
        """(start, end) of each stretch of the window with no device
        operation running."""
        out, t = [], self.w0
        for s, e in self.busy_spans:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def breakdown(self):
        """The ten device operations that took most time, and the idle
        time by what the host was doing (the innermost host operation at
        each gap's middle), the ten largest."""
        ops = {}
        for n, _, d in self.device_ops:
            ops[short_name(n)] = ops.get(short_name(n), 0.0) + d
        idle = {}
        # the innermost host operation at each gap's middle: of those begun
        # by then and not yet ended, the latest begun (host operations nest)
        host = sorted(self.host_ops, key=lambda op: op[1])
        live, k = [], 0
        for s, e in self.gaps():
            mid = (s + e) / 2
            while k < len(host) and host[k][1] <= mid:
                n, hs, d = host[k]
                heapq.heappush(live, (-hs, hs + d, n))
                k += 1
            while live and live[0][1] < mid:
                heapq.heappop(live)
            what = live[0][2] if live else "host: no traced operation"
            idle[what] = idle.get(what, 0.0) + (e - s)

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(ops), "idle_gaps": top(idle)}


def read_trace(events, calls):
    """A :class:`Record` of the Chrome-trace ``events`` within the
    window's annotation."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w0 = float(win[0]["ts"]) * 1e-6
    w1 = w0 + float(win[0]["dur"]) * 1e-6

    def spans(cats):
        out = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in cats:
                s, d = float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
                if s < w1 and s + d > w0:
                    out.append((e["name"], s, d))
        return out

    device_ops = spans(DEVICE_CATS)
    kernels = spans(("kernel",))
    return Record(device_ops, kernels, spans(HOST_CATS), calls, w0, w1)


def traced_window(entry, first, calls, sync, on_card):
    """Profile ``calls`` calls of ``entry`` from call ``first`` on."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(first, first + calls):
                out = entry.call(i)
                sync()
                del out
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return read_trace(events, calls)
