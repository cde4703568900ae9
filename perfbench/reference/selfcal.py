"""Plain reference of one phase-only selfcal step (codex-africanus
`phase_only.gauss_newton`, `corrupt_vis`, `dft.vis_to_im` / `im_to_vis`
and `hogbom_clean`, written out plainly in one precision).

- The solve: DIAG_DIAG phase-only Gauss-Newton from unit gains, unit
  weights, no flags, one direction: each iteration forms
  J = g_p·M·conj(g_q) and R = V − J, and moves the phase of gain (t, a, f, c)
  by ½·Σ ±Im(conj(J)·R) / Σ |J|² over the rows of time t where a is the
  first (+) or second (−) antenna.
- The residual R = V − g_p·M·conj(g_q), summed over correlations.
- The dirty image: D[x] = Σ_f Σ_r Re(exp(+2πi·(u·l + v·m + w·(n−1))·ν/c)·R[r, f])
  / (rows · channels) at pixel x's (l, m).
- CLEAN: Högbom with a delta PSF, the peak taken as the first argmax, up
  to niter + 1 components of gain γ while the peak stays above
  threshold · |first peak|.
- The re-predict: V[r, f, c] = Σ_s exp(−2πi·(u·l + v·m + w·(n−1))·ν/c)·I[s, f, c].
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.rime import LIGHTSPEED

__all__ = ["solve", "residual", "dirty_pixels", "clean", "predict",
           "grid_lm"]


def grid_lm(npx, extent, dtype=torch.float64, device=None):
    """(npx², 2) lm of an npx × npx grid over ±extent, l slowest."""
    x = torch.linspace(-extent, extent, npx, dtype=torch.float64, device=device)
    lg, mg = torch.meshgrid(x, x, indexing="ij")
    return torch.stack([lg, mg], dim=-1).reshape(-1, 2).to(dtype)


def _gather(g, t, a):
    """(row, chan, corr) gains of each row's antenna ``a``."""
    return g[t, a]


def solve(data, model, time, a1, a2, ntime, nant, iters, p):
    """Gains (time, ant, chan, corr) after ``iters`` Gauss-Newton steps.

    data, model: (row, chan, corr) complex; time: (row,) time index."""
    v, m = p.cplx_t(data), p.cplx_t(model)
    nrow, nchan, ncorr = v.shape
    phase = torch.zeros((ntime, nant, nchan, ncorr), dtype=p.real,
                        device=v.device)
    bin_p = time * nant + a1
    bin_q = time * nant + a2

    def bins(xp, xq):
        out = torch.zeros((ntime * nant, nchan, ncorr), dtype=p.real,
                          device=v.device)
        out.index_add_(0, bin_p, xp)
        out.index_add_(0, bin_q, xq)
        return out.reshape(ntime, nant, nchan, ncorr)

    m2 = p.mul(m.real, m.real) + p.mul(m.imag, m.imag)
    jhj = bins(m2, m2)  # |g_p M conj(g_q)|² = |M|² for unit gains
    safe = torch.where(jhj == 0, torch.ones_like(jhj), jhj)
    for _ in range(iters):
        g = torch.polar(torch.ones_like(phase), phase)
        jac = p.mul(p.mul(_gather(g, time, a1), m), _gather(g, time, a2).conj())
        r = v - jac
        im = p.mul(jac.conj(), r).imag
        jhr = bins(im, -im)
        phase = phase + torch.where(jhj == 0, torch.zeros_like(jhj),
                                    p.mul(0.5, jhr) / safe)
    return torch.polar(torch.ones_like(phase), phase)


def residual(data, model, gains, time, a1, a2, p):
    """(row, chan) V − g_p·M·conj(g_q), summed over correlations."""
    v, m = p.cplx_t(data), p.cplx_t(model)
    g = p.cplx_t(gains)
    pred = p.mul(p.mul(_gather(g, time, a1), m), _gather(g, time, a2).conj())
    return (v - pred).sum(dim=-1)


def _phase(lm, uvw, freq, sign):
    """(direction, row, chan) ±2π·(u·l + v·m + w·(n−1))·ν/c, in the
    inputs' dtype, unrounded (Arith's docstring)."""
    l, m = lm[:, 0], lm[:, 1]  # noqa: E741
    n1 = torch.sqrt(torch.clamp(1 - l * l - m * m, min=0)) - 1
    delay = (l[:, None] * uvw[None, :, 0] + m[:, None] * uvw[None, :, 1]
             + n1[:, None] * uvw[None, :, 2])
    return (delay * (sign * 2 * math.pi / LIGHTSPEED))[:, :, None] * freq[None, None, :]


def dirty_pixels(resid, uvw, lm, freq, p, block=32):
    """The dirty image at the pixels ``lm`` (pixel, 2) of the (row, chan)
    residual: Σ over rows and channels / (rows · channels)."""
    resid = p.cplx_t(resid)
    uvw, lm, freq = p.real_t(uvw), p.real_t(lm), p.real_t(freq)
    out = []
    for x0 in range(0, lm.shape[0], block):
        phase = _phase(lm[x0:x0 + block], uvw, freq, 1)
        acc = p.mul(torch.cos(phase), resid.real) - p.mul(torch.sin(phase),
                                                          resid.imag)
        out.append(acc.sum(dim=(1, 2)))
    return torch.cat(out) / (resid.shape[0] * resid.shape[1])


def clean(dirty, gamma, threshold, niter, p):
    """Högbom CLEAN of an (npx, npx) image with a delta PSF at the image's
    own pixel: returns (model image, residual image)."""
    res = p.real_t(dirty).clone()
    npx = res.shape[0]
    psf = torch.zeros((2 * npx, 2 * npx), dtype=p.real, device=res.device)
    psf[npx - 1, npx - 1] = 1.0
    model = torch.zeros_like(res)
    flat = int(torch.argmax(res))
    peak = res.reshape(-1)[flat]
    limit = threshold * abs(float(peak))
    for _ in range(niter + 1):
        if not abs(float(peak)) > limit:
            break
        i, j = divmod(flat, npx)
        step = p.mul(gamma, peak)
        model[i, j] += step
        window = psf[npx - 1 - i: 2 * npx - 1 - i, npx - 1 - j: 2 * npx - 1 - j]
        res = res - p.mul(step, window)
        flat = int(torch.argmax(res))
        peak = res.reshape(-1)[flat]
    return model, res


def predict(image, uvw, lm, freq, p, block=4):
    """(row, chan, corr) visibilities of the point sources ``lm`` with
    spectra ``image`` (src, chan, corr)."""
    uvw, lm, freq = p.real_t(uvw), p.real_t(lm), p.real_t(freq)
    img = p.cplx_t(image)
    out = 0
    for s0 in range(0, lm.shape[0], block):
        phase = _phase(lm[s0:s0 + block], uvw, freq, -1)
        k = torch.polar(torch.ones_like(phase), phase)
        out = out + p.einsum("srf,sfc->rfc", k, img[s0:s0 + block])
    return out
