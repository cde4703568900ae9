"""The work of the adjoint DFT (the residual image), counted from the map:
I[p, f, c] = Σ_r Re(exp(iφ[p, r, f]) · V[r, f, c]), whatever computes it.

- Operations: each of the P·R·F terms' multiply-accumulate into each of
  the C correlations. The sum keeps the real part only, so a term is
  Re(e^{iφ})·Re(V) − Im(e^{iφ})·Im(V) added in: 4 real operations
  (2 multiplies, 2 adds).
- Bytes: each input read once and each output written once: uvw per row
  (3 float32), lm per pixel (2 float32), the frequencies (float32), the
  visibilities (complex64) and their flags (1 byte) per (row, channel,
  correlation), and the image (float32) per (pixel, channel, correlation).
"""

from perfbench import peaks


def shape(shapes):
    """The kernel's sizes from an entry's problem sizes (``pixels`` of
    the image, ``rows``, ``chan``, ``image_corr``: the correlations the
    image is made of), or None where the entry makes no image."""
    if not {"pixels", "rows", "chan", "image_corr"} <= set(shapes):
        return None
    return dict(P=shapes["pixels"], R=shapes["rows"], F=shapes["chan"],
                C=shapes["image_corr"])


def count(P, R, F, C):
    """(operations, bytes) of one call."""
    ops = 4.0 * C * P * R * F
    nbytes = (12.0 * R + 8.0 * P + 4.0 * F + 9.0 * R * F * C
              + 4.0 * P * F * C)
    return ops, nbytes


def least_seconds(P, R, F, C):
    """(seconds, which bound) the card needs at least for one call."""
    ops, nbytes = count(P, R, F, C)
    t_ops, t_bytes = ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
