"""The work of one call's w-stack degridding, counted from the map
V = Σ_p Σ_u Σ_v wsc_p · ψ_u · ψ_v · G[p, u, v] over each sample's W × W × W
taps, whatever computes it and in however many blocks of planes: the
adjoint of ``grid_wstack``'s map, with its sizes.

- Operations: W³ taps a sample, each a complex-by-real multiply-accumulate
  (2 multiplies, 2 adds): 4·W³.
- Bytes: the grid's cells that some sample's window holds read once
  (complex64: the map reads no other cell, so a whole plane is more than
  it needs), uvw read once a row (3 float32) and the frequencies once
  (float32); the samples' values written once (complex64).
"""

from perfbench import peaks

KEYS = {"rows", "chan", "wstack_samples", "wstack_support", "wstack_cells"}


def shape(shapes):
    """The map's sizes from an entry's problem sizes, or None where it has
    no w-stack."""
    if not KEYS <= set(shapes):
        return None
    return dict(N=shapes["wstack_samples"], R=shapes["rows"], F=shapes["chan"],
                W=shapes["wstack_support"], C=shapes["wstack_cells"])


def count(N, R, F, W, C):
    """(operations, bytes) of one call: ``N`` samples of ``R`` rows and
    ``F`` channels, support ``W``, ``C`` grid cells within the samples'
    windows."""
    ops = 4.0 * W ** 3 * N
    nbytes = 8.0 * C + 12.0 * R + 4.0 * F + 8.0 * N
    return ops, nbytes


def least_seconds(**sizes):
    """(seconds, which bound) the card needs at least for one call."""
    ops, nbytes = count(**sizes)
    t_ops, t_bytes = ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
