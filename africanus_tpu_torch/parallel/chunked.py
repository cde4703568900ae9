"""Host-streamed chunked execution over the row dimension.

Port of ``africanus_tpu/parallel/chunked.py``. The reference scales past
memory limits with dask: ``da.blockwise`` over row chunks plus reduction
layers (rime/dask_predict.py LinearReduction, nifty
GridStreamReduction). Here the out-of-core pattern is host-side
streaming: slice row chunks on the host, pad each to the same row count,
move it to the device, call ``fn`` on it eagerly (there is nothing to
compile once), and either concatenate the per-chunk outputs on the host
or accumulate a reduction on the device. This module is for data larger
than device memory.

Pytrees are nests of dicts, tuples and lists; every other object is a
leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.ops._build import plan_device

__all__ = ["stream_rows"]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the matching leaves of the
    trees in ``rest`` (which share its structure) as further arguments."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        items = [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return items
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree, *rest)


def _host(x):
    """A leaf as a host numpy array (a tensor on the card is copied)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stream_rows(fn, arrays, chunk=65536, combine="concat", row_axes=None,
                device="cuda"):
    """Apply ``fn`` over row chunks of ``arrays``.

    Parameters
    ----------
    fn : callable(chunk_tree, valid) -> pytree of tensors
        Called once per chunk, eagerly. ``chunk_tree`` holds tensors on
        ``device``; ``valid`` is a (chunk,) bool tensor marking real rows
        (False on the zero-padded tail of the last chunk); reductions
        must zero masked rows' contributions.
    arrays : pytree of arrays (numpy or tensors) sharing a leading row
        dimension; converted to host numpy once, up front.
    chunk : rows per chunk (every chunk is padded to exactly this).
    combine : "concat" — stitch per-chunk outputs (leading dim = chunk)
        back to full rows on the host; "sum" — accumulate ``fn`` outputs
        on the device.
    row_axes : for "concat", optional pytree (matching fn's output) of
        leading-axis flags; True (default) trims the padded tail.
    device : where ``fn`` runs (default the card; raises without one).

    Returns
    -------
    Combined pytree: host numpy for "concat", tensors on ``device`` for
    "sum".
    """
    leaves = _leaves(arrays)
    if not leaves:
        raise ValueError("arrays must contain at least one array")
    nrow = leaves[0].shape[0]
    if any(leaf.shape[0] != nrow for leaf in leaves[1:]):
        raise ValueError("all arrays must share the leading row dim")
    if combine not in ("concat", "sum"):
        raise ValueError(f"unknown combine {combine!r}")
    device = plan_device(device)

    # one host conversion up front, not one per chunk and leaf
    arrays = _map(_host, arrays)
    out = None
    pieces = []
    for start in range(0, max(nrow, 1), chunk):
        stop = min(start + chunk, nrow)
        n = stop - start

        def slice_pad(x):
            part = x[start:stop]
            if n < chunk:
                part = np.pad(part, [(0, chunk - n)] + [(0, 0)] * (x.ndim - 1))
            return torch.from_numpy(np.ascontiguousarray(part)).to(device)

        result = fn(_map(slice_pad, arrays),
                    torch.arange(chunk, device=device) < n)
        if combine == "sum":
            out = result if out is None else _map(torch.add, out, result)
        else:
            pieces.append((n, _map(_host, result)))

    if combine == "sum":
        return out

    first = pieces[0][1]
    if row_axes is None:
        row_axes = _map(lambda _: True, first)

    def stitch(is_row, *parts):
        if is_row:
            return np.concatenate([p[:n] for (n, _), p in zip(pieces, parts)],
                                  axis=0)
        return parts[0]

    return _map(stitch, row_axes, *[p for _, p in pieces])
