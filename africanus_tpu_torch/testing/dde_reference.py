"""Plain float64 reference of the direction-dependent predict.

V_pq(ν) = Σ_s E_ps(ν) L_p K_ps(ν) G_ps(ν) B_s(ν) L_qᴴ E_qs(ν)ᴴ

— the fused RIME ``[Ep, Lp, Kpq, Gpq, Bpq, Lq, Eq]: [I,Q,U,V] ->
[XX,XY,YX,YY]`` written out piece by piece, row by row, in float64
torch, importing nothing of the port:

- E: the beam cube's trilinear interpolation (l, m, frequency) at each
  source's position scaled by the channel's frequency beyond the cube's
  (codex-africanus ``freq_grid_interp``), offset by the antenna's
  pointing error, rotated by the beam parallactic angle and scaled by
  the antenna's beam scaling, clamped to the cube; each correlation
  normalised as codex-africanus does, e = acc · Σw|v| / |acc| (0 where
  acc is), the formula of ``beam_chain.beam_oracle_f64``;
- L: the linear feed rotation [[cos a, sin a], [−sin a, cos a]];
- K = exp(−2πi·(u·l + v·m + w·(n−1))·ν/c), G the gaussian envelope
  exp(−((u'·s)² + (v'·s)²)), s = ν·√2·π/(FWHM·c), of the source's rotated
  and scaled uv, B the linear-feed brightness [[I+Q, U+iV], [U−iV, I−Q]]
  of the spectral model I_s(ν) = I_s·(ν/ν_ref)^(Σα).

:func:`analytic_beam` makes the analytic 2×2 beam the MeerKAT L-band
configuration states: a cos³ voltage taper of the given half-power width
scaling as 1/ν, XX and YY elongated in opposite directions, and
off-diagonal leakage with the four-lobed l·m pattern of linear feeds.
"""

from __future__ import annotations

import math

import torch

__all__ = ["LIGHTSPEED", "GAUSS_SCALE", "analytic_beam", "beam_jones",
           "feed_rotation", "brightness", "phase_envelope", "dde_predict"]

LIGHTSPEED = 2.99792458e8
GAUSS_SCALE = math.sqrt(2.0) * math.pi / (
    2.0 * math.sqrt(2.0 * math.log(2.0)) * LIGHTSPEED)
F64, C128 = torch.float64, torch.complex128

# a float32 product on the card may otherwise run in TF32, a lower precision
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def analytic_beam(npix, extent, freqs, hpbw_rad, hpbw_hz, elongation,
                  leakage, device="cpu"):
    """(npix, npix, nfreq, 2, 2) complex128 beam over l, m in ±``extent``
    at the frequencies ``freqs``: the diagonals cos³(k·r), clamped at
    the first null, with cos⁶ = ½ at r = HPBW/2, HPBW = ``hpbw_rad`` ×
    ``hpbw_hz`` / ν; r = |(l/(1+ε), m/(1−ε))| for XX and |(l/(1−ε),
    m/(1+ε))| for YY, ε = ``elongation``; XY = YX ∝ l·m·cos³(k·|l, m|),
    its largest magnitude a plane ``leakage`` of the diagonals' peak (1).
    """
    ax = torch.linspace(-extent, extent, npix, dtype=F64, device=device)
    l, m = torch.meshgrid(ax, ax, indexing="ij")  # noqa: E741
    l, m = l[:, :, None], m[:, :, None]  # noqa: E741
    nu = torch.as_tensor(freqs, dtype=F64, device=device)
    k = 2.0 * math.acos(2.0 ** (-1.0 / 6.0)) / (hpbw_rad * hpbw_hz / nu)

    def taper(r):
        return torch.cos(torch.clamp(k * r, max=math.pi / 2)) ** 3

    e = elongation
    xx = taper(torch.hypot(l / (1 + e), m / (1 - e)))
    yy = taper(torch.hypot(l / (1 - e), m / (1 + e)))
    lobes = l * m * taper(torch.hypot(l, m))
    xy = leakage * lobes / lobes.abs().amax(dim=(0, 1), keepdim=True)
    beam = torch.stack([torch.stack([xx, xy], -1), torch.stack([xy, yy], -1)], -2)
    return beam.to(C128)


def _freq_interp(fmap, freq):
    """(lm scale, lower slab, its weight) per channel: beyond the cube's
    frequencies the lm coordinates scale and the nearest slab is taken."""
    n = fmap.shape[0]
    g0 = (torch.searchsorted(fmap, freq, right=True).clamp(1, n - 1) - 1)
    wlo = (fmap[g0 + 1] - freq) / (fmap[g0 + 1] - fmap[g0])
    scale = torch.ones_like(freq)
    below, above = freq < fmap[0], freq > fmap[-1]
    scale = torch.where(below, freq / fmap[0], torch.where(above, freq / fmap[-1], scale))
    wlo = torch.where(below, 1.0, torch.where(above, 0.0, wlo))
    g0 = torch.where(below, 0, torch.where(above, n - 2, g0))
    return scale, g0, wlo


def beam_jones(beam, extents, freq_map, lm, parangle, point_errors,
               antenna_scaling, freq):
    """(src, row, chan, 2, 2) E of each source at each row's antenna:
    ``parangle`` (row,), ``point_errors`` and ``antenna_scaling`` (row,
    chan, 2) taken at the row's time and antenna."""
    beam = beam.to(C128)
    lw, mh, nud = beam.shape[:3]
    flat = beam.reshape(lw, mh, nud, 4)
    ext = extents.to(F64)
    scale, g0, wlo = _freq_interp(freq_map.to(F64), freq.to(F64))
    lm, pa = lm.to(F64), parangle.to(F64)
    pe, asc = point_errors.to(F64), antenna_scaling.to(F64)

    tl = lm[:, 0, None, None] * scale + pe[None, ..., 0]  # (src, row, chan)
    tm = lm[:, 1, None, None] * scale + pe[None, ..., 1]
    cp, sp = torch.cos(pa)[None, :, None], torch.sin(pa)[None, :, None]
    vl = (tl * cp - tm * sp) * asc[None, ..., 0]
    vm = (tl * sp + tm * cp) * asc[None, ..., 1]
    vl = torch.clamp((lw - 1) / (ext[0, 1] - ext[0, 0]) * (vl - ext[0, 0]), 0, lw - 1)
    vm = torch.clamp((mh - 1) / (ext[1, 1] - ext[1, 0]) * (vm - ext[1, 0]), 0, mh - 1)
    gl0, gm0 = torch.floor(vl).long(), torch.floor(vm).long()
    ld, md = vl - gl0, vm - gm0
    gc0 = g0.expand_as(gl0)
    wc0 = wlo.expand_as(ld)
    acc = torch.zeros(vl.shape + (4,), dtype=C128, device=vl.device)
    absc = torch.zeros(vl.shape + (4,), dtype=F64, device=vl.device)
    for gl, wl in ((gl0, 1 - ld), ((gl0 + 1).clamp(max=lw - 1), ld)):
        for gm, wm in ((gm0, 1 - md), ((gm0 + 1).clamp(max=mh - 1), md)):
            for gc, wc in ((gc0, wc0), (gc0 + 1, 1 - wc0)):
                w = (wl * wm * wc)[..., None]
                v = flat[gl, gm, gc]
                acc = acc + w * v
                absc = absc + w * v.abs()
    div = acc.abs()
    e = acc * torch.where(div == 0, absc, absc / torch.where(div == 0, 1.0, div))
    return e.reshape(vl.shape + (2, 2))


def feed_rotation(angle):
    """(..., 2, 2) linear feed rotation of the angles ``angle``."""
    c, s = torch.cos(angle.to(F64)), torch.sin(angle.to(F64))
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2).to(C128)


def brightness(stokes, spi, ref_freq, freq):
    """(src, chan, 2, 2) linear-feed brightness of the standard spectral
    model; ``spi`` (src, nspi, 4)."""
    ratio = freq.to(F64)[None, :] / ref_freq.to(F64)[:, None]
    alpha = spi.to(F64).sum(dim=1)
    flux = stokes.to(F64)[:, None, :] * ratio[:, :, None] ** alpha[:, None, :]
    i, q, u, v = flux.to(C128).unbind(-1)
    return torch.stack([torch.stack([i + q, u + 1j * v], -1),
                        torch.stack([u - 1j * v, i - q], -1)], -2)


def phase_envelope(lm, uvw, gauss_shape, freq):
    """(src, row, chan) K·G: the phase delay (fourier convention) and
    the gaussian envelope."""
    lm, uvw, freq = lm.to(F64), uvw.to(F64), freq.to(F64)
    l, m = lm[:, 0:1], lm[:, 1:2]  # noqa: E741
    n1 = torch.sqrt(torch.clamp(1 - l * l - m * m, min=0)) - 1
    delay = l * uvw[:, 0] + m * uvw[:, 1] + n1 * uvw[:, 2]  # (src, row)
    phase = (-2 * math.pi / LIGHTSPEED) * delay[:, :, None] * freq
    emaj, emin, angle = gauss_shape.to(F64).unbind(-1)
    el, em = emaj * torch.sin(angle), emaj * torch.cos(angle)
    er = emin / torch.where(emaj == 0, torch.ones_like(emaj), emaj)
    u, v = uvw[:, 0], uvw[:, 1]
    u1 = (u * em[:, None] - v * el[:, None]) * er[:, None]
    v1 = u * el[:, None] + v * em[:, None]
    sf = freq * GAUSS_SCALE
    env = torch.exp(-((u1[:, :, None] * sf) ** 2 + (v1[:, :, None] * sf) ** 2))
    return torch.polar(env, phase)


def dde_predict(sky, rows, freq, beam, block=4):
    """(row, chan, 4) visibilities [XX, XY, YX, YY], complex128.

    ``sky``: ``lm`` (src, 2), ``stokes`` (src, 4), ``spi`` (src, nspi,
    4), ``ref_freq`` (src,), ``gauss_shape`` (src, 3). ``rows``: ``uvw``
    (row, 3), ``time`` (row,) index into the time axes below,
    ``antenna1`` and ``antenna2`` (row,). ``beam``: ``beam`` (lw, mh,
    nud, 2, 2), ``extents`` (2, 2), ``freq_map`` (nud,), ``parangle``
    (time, ant) beam parallactic angles, ``feed_angle`` (time, ant) feed
    rotation angles, ``point_errors`` (time, ant, chan, 2),
    ``antenna_scaling`` (ant, chan, 2). Rows are taken ``block`` at a
    time.
    """
    freq = freq.to(F64)
    b = brightness(sky["stokes"], sky["spi"], sky["ref_freq"], freq)
    out = []
    for r0 in range(0, rows["uvw"].shape[0], block):
        sl = slice(r0, r0 + block)
        t = rows["time"][sl]

        def e_l(ant):
            e = beam_jones(beam["beam"], beam["extents"], beam["freq_map"],
                           sky["lm"], beam["parangle"][t, ant],
                           beam["point_errors"][t, ant],
                           beam["antenna_scaling"][ant], freq)
            return e @ feed_rotation(beam["feed_angle"][t, ant])[None, :, None]

        left, right = e_l(rows["antenna1"][sl]), e_l(rows["antenna2"][sl])
        kg = phase_envelope(sky["lm"], rows["uvw"][sl], sky["gauss_shape"], freq)
        x = kg[..., None, None] * b[:, None]
        v = (left @ x @ right.conj().transpose(-1, -2)).sum(dim=0)
        out.append(v.reshape(v.shape[:2] + (4,)))
    return torch.cat(out, dim=0)
