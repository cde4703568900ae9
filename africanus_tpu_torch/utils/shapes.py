"""Shape/chunk utilities (reference ``africanus/util/shapes.py``).

A copy of ``africanus_tpu/utils/shapes.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

__all__ = ["aggregate_chunks", "corr_shape"]


def aggregate_chunks(chunks, max_chunks):
    """Merge consecutive chunks so no aggregate exceeds ``max_chunks``
    (reference shapes.py:4-70). Accepts a single tuple or a sequence of
    parallel chunk tuples.

    >>> aggregate_chunks(((3,4,6,3,6,7), (1,1,1,1,1,1)), (10,3))
    ((7, 9, 6, 7), (2, 2, 1, 1))
    """
    if isinstance(max_chunks, int):
        chunks = (chunks,)
        max_chunks = (max_chunks,)
    singleton = len(max_chunks) == 1

    if len(chunks) != len(max_chunks):
        raise ValueError("chunks and max_chunks differ in length")
    if not all(len(chunks[0]) == len(c) for c in chunks):
        raise ValueError("chunk tuple lengths differ")

    agg = [[] for _ in max_chunks]
    counts = [0] * len(max_chunks)
    ndim = len(chunks[0])

    for di in range(ndim):
        proposed = [counts[ci] + c[di] for ci, c in enumerate(chunks)]
        if any(p > m for p, m in zip(proposed, max_chunks)):
            for ci, c in enumerate(chunks):
                agg[ci].append(counts[ci])
                counts[ci] = c[di]
        else:
            counts = proposed

    for ci in range(len(chunks)):
        agg[ci].append(counts[ci])

    out = tuple(tuple(a) for a in agg)
    return out[0] if singleton else out


def corr_shape(ncorr, corr_shape):
    """Shape of the correlation dimensions (reference shapes.py:72):
    "flat" -> (ncorr,), "matrix" -> (1,), (2,) or (2, 2)."""
    if corr_shape == "flat":
        return (ncorr,)
    if corr_shape == "matrix":
        if ncorr == 1:
            return (1,)
        if ncorr == 2:
            return (2,)
        if ncorr == 4:
            return (2, 2)
        raise ValueError(f"ncorr {ncorr} not in (1, 2, 4)")
    raise ValueError(f"corr_shape {corr_shape} not in ('flat', 'matrix')")
