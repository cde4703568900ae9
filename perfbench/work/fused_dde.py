"""The work of one call of the direction-dependent predict, counted from
the map V_pq = Σ_s E_ps L_p K_ps G_ps B_s L_qᴴ E_qsᴴ, whatever computes
it.

- Operations per (source, row, channel): K·G (a complex by a real, 2),
  that times B's four terms (4 complex products, 24), the sandwich's two
  2×2 complex products (8 complex products and 4 complex sums each,
  56 + 56) and the accumulation into V's four correlations (8): 146. Per
  (source, time, antenna, channel): E·L, a 2×2 complex by a 2×2 real
  (8 products of 2, 4 sums of 2): 24. Sampling E from the cube is not
  counted.
- Bytes: each input read once and the output written once: the cube
  (2×2 complex64 a pixel and plane), its extents and frequencies; the
  sky (lm, Stokes, spectral indices, reference frequency, shape; float32);
  uvw (float32), time (float64) and both antennas (int64) a row; the
  pointing errors (time, antenna, channel, 2) and beam scalings
  (antenna, channel, 2) as the call passes them, float32; the
  parallactic angles (time, antenna) and the feed table (time, antenna,
  2, 2), float32; the frequencies; V as complex64 a row, channel and
  correlation.
"""

from perfbench import peaks

KEYS = {"sources", "rows", "chan", "corr", "dde_times", "dde_antennas",
        "dde_spi", "beam_cube"}


def shape(shapes):
    """The map's sizes from an entry's problem sizes, or None where it
    has none of the direction-dependent ones."""
    if not KEYS <= set(shapes):
        return None
    return dict(S=shapes["sources"], R=shapes["rows"], F=shapes["chan"],
                C=shapes["corr"], T=shapes["dde_times"], A=shapes["dde_antennas"],
                P=shapes["dde_spi"], cube=tuple(shapes["beam_cube"]))


def count(S, R, F, C, T, A, P, cube):
    """(operations, bytes) of one call."""
    ops = 146.0 * S * R * F + 24.0 * S * T * A * F
    lw, mh, nud = cube
    nbytes = (8.0 * 4 * lw * mh * nud + 4.0 * 4 + 4.0 * nud
              + 4.0 * S * (2 + 4 + 4 * P + 1 + 3)
              + R * (4.0 * 3 + 8 + 8 + 8)
              + 4.0 * T * A * F * 2 + 4.0 * A * F * 2
              + 4.0 * T * A * (1 + 4) + 4.0 * F
              + 8.0 * R * F * C)
    return ops, nbytes


def least_seconds(**sizes):
    """(seconds, which bound) the card needs at least for one call."""
    ops, nbytes = count(**sizes)
    t_ops, t_bytes = ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
