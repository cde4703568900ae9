"""Plain reference of the flagship predict, row by row.

V[r, f, c] = g[t, p, f, c] · Σ_s K[s, r, f] · E[s, r, f] · B[s, f, c] · conj(g[t, q, f, c])

with the standard spectral model I_s(ν) = I_s · (ν/ν_ref)^(Σα), the
Stokes → linear-feed brightness [I+Q, U+iV, U−iV, I−Q], the phase
K = exp(−2πi·(u·l + v·m + w·(n−1))·ν/c), the gaussian envelope
E = exp(−((u'·s)² + (v'·s)²)), s = ν·√2·π/(FWHM·c), of the source's
rotated and scaled uv coordinates, and diagonal DIE gains
g = exp(i·phase). The formulas are those of codex-africanus (spectral
model, `convert`, `phase_delay`, `gaussian`, `predict_vis`), written out
plainly in one precision: no two-float delay, no channel recurrence.
"""

from __future__ import annotations

import math

import torch

__all__ = ["LIGHTSPEED", "GAUSS_SCALE", "flagship_rows"]

LIGHTSPEED = 2.99792458e8
GAUSS_SCALE = math.sqrt(2.0) * math.pi / (
    2.0 * math.sqrt(2.0 * math.log(2.0)) * LIGHTSPEED)


def _brightness(sky, freq, p):
    """(src, chan, 4) complex brightness [XX, XY, YX, YY]."""
    ratio = freq[None, :] / p.real_t(sky["ref_freq"])[:, None]
    alpha = p.real_t(sky["spi"]).sum(dim=1)                 # (src, 4)
    flux = p.mul(p.real_t(sky["stokes"])[:, None, :],
                 ratio[:, :, None] ** alpha[:, None, :])    # (src, chan, 4)
    i, q, u, v = flux.unbind(-1)
    zero = torch.zeros_like(i)
    return torch.stack([torch.complex(i + q, zero), torch.complex(u, v),
                        torch.complex(u, -v), torch.complex(i - q, zero)],
                       dim=-1)


def _source_sum(sky, uvw, freq, b, p):
    """(row, chan, 4) Σ_s K·E·B for the given rows."""
    lm = p.real_t(sky["lm"])
    l, m = lm[:, 0], lm[:, 1]  # noqa: E741
    u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    # the phase in the precision's own dtype, unrounded (Arith's docstring)
    n1 = torch.sqrt(torch.clamp(1 - l * l - m * m, min=0)) - 1
    delay = l[:, None] * u[None, :] + m[:, None] * v[None, :] + n1[:, None] * w[None, :]
    phase = (delay * (-2 * math.pi / LIGHTSPEED))[:, :, None] * freq[None, None, :]

    shape = p.real_t(sky["gauss_shape"])
    emaj, emin, angle = shape[:, 0], shape[:, 1], shape[:, 2]
    el, em = p.mul(emaj, torch.sin(angle)), p.mul(emaj, torch.cos(angle))
    er = emin / torch.where(emaj == 0, torch.ones_like(emaj), emaj)
    u1 = p.mul(p.mul(u[None, :], em[:, None]) - p.mul(v[None, :], el[:, None]),
               er[:, None])
    v1 = p.mul(u[None, :], el[:, None]) + p.mul(v[None, :], em[:, None])
    sf = p.mul(freq, GAUSS_SCALE)
    us = p.mul(u1[:, :, None], sf[None, None, :])
    vs = p.mul(v1[:, :, None], sf[None, None, :])
    env = torch.exp(-(p.mul(us, us) + p.mul(vs, vs)))
    k = torch.polar(env, phase)                            # (src, row, chan)
    return p.einsum("srf,sfc->rfc", k, b)


def flagship_rows(sky, rows, freq, p, block=8):
    """The reference visibilities of some rows of one chunk.

    ``sky``: dict of the sky model's tensors (``lm`` (src, 2), ``stokes``
    (src, 4), ``spi`` (src, spi, 4), ``ref_freq`` (src,), ``gauss_shape``
    (src, 3)); ``rows``: dict of ``uvw`` (row, 3), ``time`` (row,) index
    into ``gain_phase``'s first axis, ``antenna1``, ``antenna2`` (row,),
    and ``gain_phase`` (time, ant, chan, 4); ``freq`` (chan,). ``p`` is
    the :class:`~perfbench.reference.arith.Arith` to compute in. Rows are
    taken ``block`` at a time so that (src, block, chan) fits.
    Returns (row, chan, 4) in ``p.cplx``.
    """
    freq = p.real_t(freq)
    b = _brightness(sky, freq, p)
    uvw = p.real_t(rows["uvw"])
    gph = p.real_t(rows["gain_phase"])
    t, a1, a2 = rows["time"], rows["antenna1"], rows["antenna2"]
    out = []
    for r0 in range(0, uvw.shape[0], block):
        sl = slice(r0, r0 + block)
        vis = _source_sum(sky, uvw[sl], freq, b, p)
        gp = torch.polar(torch.ones_like(gph[t[sl], a1[sl]]), gph[t[sl], a1[sl]])
        gq = torch.polar(torch.ones_like(gph[t[sl], a2[sl]]), gph[t[sl], a2[sl]])
        out.append(p.mul(p.mul(gp, vis), gq.conj()))
    return torch.cat(out, dim=0)
