"""Plain reference of the direction-dependent predict, row by row.

V_pq(ν) = Σ_s E_ps(ν) L_p K_ps(ν) G_ps(ν) B_s(ν) L_qᴴ E_qs(ν)ᴴ

the fused RIME ``[Ep, Lp, Kpq, Gpq, Bpq, Lq, Eq]: [I,Q,U,V] ->
[XX,XY,YX,YY]`` written out piece by piece, in one precision (a copy of
``africanus_tpu_torch/testing/dde_reference.py`` on :class:`Arith`,
with the brightness of :mod:`perfbench.reference.rime`):

- E: the beam cube's trilinear interpolation (l, m, frequency) at each
  source's position scaled by the channel's frequency beyond the cube's,
  offset by the antenna's pointing error, rotated by the beam
  parallactic angle and scaled by the antenna's beam scaling, clamped to
  the cube; each correlation normalised as codex-africanus does,
  e = acc · Σw|v| / |acc| (0 where acc is);
- L: the linear feed rotation [[cos a, sin a], [−sin a, cos a]];
- K = exp(−2πi·(u·l + v·m + w·(n−1))·ν/c) and the gaussian envelope G,
  as :mod:`perfbench.reference.rime` writes them, and B the linear-feed
  brightness of the standard spectral model.

``leakage=False`` zeroes E's off-diagonal terms and ``pointing=False``
leaves the pointing errors out: the two omission controls, which
``correct`` has to reject as it rejects the TF32 control.

:func:`analytic_beam` makes the configuration's analytic 2×2 beam.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.rime import GAUSS_SCALE, LIGHTSPEED, _brightness

__all__ = ["analytic_beam", "dde_rows"]

# a float32 product on the card may otherwise run in TF32, a lower precision
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def analytic_beam(npix, extent, freqs, hpbw_rad, hpbw_hz, elongation,
                  leakage, device):
    """(npix, npix, nfreq, 2, 2) complex128 beam over l, m in ±``extent``
    at the frequencies ``freqs``: the diagonals cos³(k·r), clamped at
    the first null, with cos⁶ = ½ at r = HPBW/2, HPBW = ``hpbw_rad`` ×
    ``hpbw_hz`` / ν; r = |(l/(1+ε), m/(1−ε))| for XX and |(l/(1−ε),
    m/(1+ε))| for YY, ε = ``elongation``; XY = YX ∝ l·m·cos³(k·|l, m|),
    its largest magnitude a plane ``leakage`` of the diagonals' peak (1).
    """
    f64 = torch.float64
    ax = torch.linspace(-extent, extent, npix, dtype=f64, device=device)
    l, m = torch.meshgrid(ax, ax, indexing="ij")  # noqa: E741
    l, m = l[:, :, None], m[:, :, None]  # noqa: E741
    nu = torch.as_tensor(freqs, dtype=f64, device=device)
    k = 2.0 * math.acos(2.0 ** (-1.0 / 6.0)) / (hpbw_rad * hpbw_hz / nu)

    def taper(r):
        return torch.cos(torch.clamp(k * r, max=math.pi / 2)) ** 3

    e = elongation
    xx = taper(torch.hypot(l / (1 + e), m / (1 - e)))
    yy = taper(torch.hypot(l / (1 - e), m / (1 + e)))
    lobes = l * m * taper(torch.hypot(l, m))
    xy = leakage * lobes / lobes.abs().amax(dim=(0, 1), keepdim=True)
    beam = torch.stack([torch.stack([xx, xy], -1), torch.stack([xy, yy], -1)], -2)
    return beam.to(torch.complex128)


def _freq_interp(fmap, freq):
    """(lm scale, lower slab, its weight) per channel: beyond the cube's
    frequencies the lm coordinates scale and the nearest slab is taken."""
    n = fmap.shape[0]
    g0 = torch.searchsorted(fmap, freq, right=True).clamp(1, n - 1) - 1
    wlo = (fmap[g0 + 1] - freq) / (fmap[g0 + 1] - fmap[g0])
    below, above = freq < fmap[0], freq > fmap[-1]
    scale = torch.where(below, freq / fmap[0],
                        torch.where(above, freq / fmap[-1], torch.ones_like(freq)))
    wlo = torch.where(below, 1.0, torch.where(above, 0.0, wlo))
    g0 = torch.where(below, 0, torch.where(above, n - 2, g0))
    return scale, g0, wlo


def _beam_jones(beam, pa, pe, asc, lm, freq, p):
    """(src, row, chan, 2, 2) E at each row's antenna: ``pa`` (row,),
    ``pe`` and ``asc`` (row, chan, 2) taken at its time and antenna."""
    cube = p.cplx_t(beam["beam"])
    lw, mh, nud = cube.shape[:3]
    flat = cube.reshape(lw, mh, nud, 4)
    ext = p.real_t(beam["extents"])
    scale, g0, wlo = _freq_interp(p.real_t(beam["freq_map"]), freq)
    lm = p.real_t(lm)
    tl = p.mul(lm[:, 0, None, None], scale) + pe[None, ..., 0]
    tm = p.mul(lm[:, 1, None, None], scale) + pe[None, ..., 1]
    cp, sp = torch.cos(pa)[None, :, None], torch.sin(pa)[None, :, None]
    vl = p.mul(p.mul(tl, cp) - p.mul(tm, sp), asc[None, ..., 0])
    vm = p.mul(p.mul(tl, sp) + p.mul(tm, cp), asc[None, ..., 1])
    vl = torch.clamp(p.mul((lw - 1) / (ext[0, 1] - ext[0, 0]), vl - ext[0, 0]), 0, lw - 1)
    vm = torch.clamp(p.mul((mh - 1) / (ext[1, 1] - ext[1, 0]), vm - ext[1, 0]), 0, mh - 1)
    gl0, gm0 = torch.floor(vl).long(), torch.floor(vm).long()
    ld, md = vl - gl0, vm - gm0
    gc0, wc0 = g0.expand_as(gl0), wlo.expand_as(ld)
    acc = torch.zeros(vl.shape + (4,), dtype=p.cplx, device=vl.device)
    absc = torch.zeros(vl.shape + (4,), dtype=p.real, device=vl.device)
    for gl, wl in ((gl0, 1 - ld), ((gl0 + 1).clamp(max=lw - 1), ld)):
        for gm, wm in ((gm0, 1 - md), ((gm0 + 1).clamp(max=mh - 1), md)):
            for gc, wc in ((gc0, wc0), (gc0 + 1, 1 - wc0)):
                w = p.mul(p.mul(wl, wm), wc)[..., None]
                v = flat[gl, gm, gc]
                acc = acc + p.mul(w, v)
                absc = absc + p.mul(w, v.abs())
    div = acc.abs()
    norm = torch.where(div == 0, absc, absc / torch.where(div == 0, 1.0, div))
    return p.mul(acc, norm).reshape(vl.shape + (2, 2))


def _feed(angle, p):
    c, s = torch.cos(angle), torch.sin(angle)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                       -2).to(p.cplx)


def _mm(a, b, p):
    """2×2 products over the last two axes, each product rounded as the
    precision rounds its operands."""
    return p.mul(a[..., :, :, None], b[..., None, :, :]).sum(dim=-2)


def _phase_envelope(lm, uvw, shape, freq, p):
    """(src, row, chan) K·G of :mod:`perfbench.reference.rime`."""
    lm = p.real_t(lm)
    l, m = lm[:, 0], lm[:, 1]  # noqa: E741
    u, v, w = uvw[:, 0], uvw[:, 1], uvw[:, 2]
    # the phase in the precision's own dtype, unrounded (Arith's docstring)
    n1 = torch.sqrt(torch.clamp(1 - l * l - m * m, min=0)) - 1
    delay = l[:, None] * u[None, :] + m[:, None] * v[None, :] + n1[:, None] * w[None, :]
    phase = (delay * (-2 * math.pi / LIGHTSPEED))[:, :, None] * freq[None, None, :]

    shape = p.real_t(shape)
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
    return torch.polar(env, phase)


def dde_rows(sky, rows, freq, beam, p, leakage=True, pointing=True, block=4):
    """The reference visibilities of some rows of one chunk.

    ``sky``: dict of the sky model's tensors (``lm`` (src, 2), ``stokes``
    (src, 4), ``spi`` (src, spi, 4), ``ref_freq`` (src,), ``gauss_shape``
    (src, 3)); ``rows``: dict of ``uvw`` (row, 3), ``time`` (row,) index
    into the time axes below, ``antenna1``, ``antenna2`` (row,);
    ``freq`` (chan,); ``beam``: dict of ``beam`` (lw, mh, nud, 2, 2),
    ``extents`` (2, 2), ``freq_map`` (nud,), ``parangle`` (time, ant)
    beam parallactic angles, ``feed_angle`` (time, ant) feed rotation
    angles, ``point_errors`` (time, ant, chan, 2), ``antenna_scaling``
    (ant, chan, 2). ``p`` is the :class:`~perfbench.reference.arith.Arith`
    to compute in. Rows are taken ``block`` at a time so that (src,
    block, chan, 2, 2) fits. Returns (row, chan, 4) in ``p.cplx``.
    """
    freq = p.real_t(freq)
    b = _brightness(sky, freq, p)
    b = b.reshape(b.shape[:2] + (2, 2))
    uvw = p.real_t(rows["uvw"])
    pa, feed = p.real_t(beam["parangle"]), p.real_t(beam["feed_angle"])
    pe, asc = p.real_t(beam["point_errors"]), p.real_t(beam["antenna_scaling"])
    if not pointing:
        pe = torch.zeros_like(pe)
    t, a1, a2 = rows["time"], rows["antenna1"], rows["antenna2"]
    out = []
    for r0 in range(0, uvw.shape[0], block):
        sl = slice(r0, r0 + block)

        def e_l(ant):
            e = _beam_jones(beam, pa[t[sl], ant], pe[t[sl], ant], asc[ant],
                            sky["lm"], freq, p)
            if not leakage:
                e = e * torch.eye(2, dtype=p.real, device=e.device)
            return _mm(e, _feed(feed[t[sl], ant], p)[None, :, None], p)

        left, right = e_l(a1[sl]), e_l(a2[sl])
        kg = _phase_envelope(sky["lm"], uvw[sl], sky["gauss_shape"], freq, p)
        x = p.mul(kg[..., None, None], b[:, None])
        v = _mm(_mm(left, x, p), right.conj().transpose(-1, -2), p).sum(dim=0)
        out.append(v.reshape(v.shape[:2] + (4,)))
    return torch.cat(out, dim=0)
