"""The work of the flagship's source contraction, counted from the map:
V[r, f, c] = Σ_s P[s, r, f] · B[s, f, c], whatever computes it.

- Operations: each of the S·R·F terms' complex multiply-accumulate into
  each of the C correlations, 8 real operations (4 multiplies, 4 adds).
- Bytes: each input read once and each output written once: the
  two-float delay (hi, lo) and the envelope's (u', v') per (source, row),
  4 float32 each; the frequencies and their envelope scale per channel;
  B as complex64 per (source, channel, correlation); V as complex64 per
  (row, channel, correlation).
"""

from perfbench import peaks


def shape(shapes):
    """The kernel's sizes from an entry's problem sizes (``sources``,
    ``rows``, ``chan``, ``corr``), or None where it has none of them."""
    if not {"sources", "rows", "chan", "corr"} <= set(shapes):
        return None
    return dict(S=shapes["sources"], R=shapes["rows"], F=shapes["chan"],
                C=shapes["corr"])


def count(S, R, F, C):
    """(operations, bytes) of one call."""
    ops = 8.0 * C * S * R * F
    nbytes = 4.0 * 4 * S * R + 4.0 * 2 * F + 8.0 * S * F * C + 8.0 * R * F * C
    return ops, nbytes


def least_seconds(S, R, F, C):
    """(seconds, which bound) the card needs at least for one call."""
    ops, nbytes = count(S, R, F, C)
    t_ops, t_bytes = ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
