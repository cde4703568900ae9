"""One step of the DFT selfcal loop: phase-only Gauss-Newton gain solve,
residual image, Hogbom CLEAN and re-predict.

Twin of the JAX package's ``bench.py`` config 5 (``config5_selfcal``:
the data at :1104-1143, the step at :1145-1179), with the step's outputs
returned instead of the bench's scalar:

1. :func:`~africanus_tpu_torch.calibration.phase_only.gauss_newton`
   (tol 0, ``gn_iters`` iterations);
2. :func:`~africanus_tpu_torch.calibration.utils.corrupt_vis` with the
   solved gains, and the residual;
3. the residual summed over correlations (exact: Σ_c Re(e^{iφ}V_c) =
   Re(e^{iφ}Σ_c V_c)), then :func:`~africanus_tpu_torch.dft.vis_to_im`
   onto an npx² lm grid — the adjoint DFT kernel on the card;
4. the image summed over channels and correlations, divided by nvis;
5. :func:`~africanus_tpu_torch.deconv.hogbom.hogbom_clean` with a delta
   PSF at (npx−1, npx−1), gamma 0.1, threshold 0.2, 50 iterations;
6. :func:`~africanus_tpu_torch.dft.im_to_vis` re-predict of the sky —
   the forward DFT kernel on the card (the predict kernel at ≥ 128
   channels).

:func:`selfcal_inputs` makes the bench's seeded numpy data;
:func:`make_data` predicts and corrupts it with the port;
:func:`from_numpy` builds the module; the ``*_oracle_f64`` functions are
float64 numpy oracles of the two DFTs, and :func:`gain_product_error` is
the bench's accuracy check of a solve.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.calibration.phase_only import (
    ant_gather_table, gauss_newton,
)
from africanus_tpu_torch.calibration.utils import corrupt_vis
from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.deconv.hogbom import hogbom_clean
from africanus_tpu_torch.dft import dft_plan, im_to_vis, vis_to_im

__all__ = ["SelfcalStep", "selfcal_inputs", "make_data", "from_numpy",
           "grid_lm", "im_to_vis_oracle_f64", "vis_to_im_oracle_f64",
           "gain_product_error"]

# the bench's CLEAN settings (bench.py:1170-1174)
_GAMMA, _THRESHOLD, _CLEAN_NITER = 0.1, 0.2, 50
# the residual image's lm extent (bench.py:1156-1163)
_GRID_EXTENT = 0.01


def grid_lm(npx):
    """(npx², 2) float32 lm grid over ±0.01 rad, l slowest."""
    x = np.linspace(-_GRID_EXTENT, _GRID_EXTENT, npx)
    return np.stack(np.meshgrid(x, x, indexing="ij"), axis=-1).reshape(
        -1, 2).astype(np.float32)


class SelfcalStep(nn.Module):
    """One selfcal step at fixed geometry, sky and model.

    Buffers: the time-bin and antenna metadata and the planned
    Gauss-Newton gather table (int64), ``uvw``, ``lm``, ``frequency``,
    ``image`` (src, chan, corr) float32, ``model`` (row, chan, 1, corr)
    complex64, ``flag``, ``weight``, ``jones0`` (time, ant, chan, 1,
    corr) complex64, the npx² ``grid_lm`` and the delta ``psf``.
    Submodules: ``forward_plan`` and ``adjoint_plan``, the DFT plans of
    the re-predict and of the residual image.
    """

    def __init__(self, time_bin_indices, time_bin_counts, antenna1, antenna2,
                 uvw, lm, frequency, image, model, flag, weight, jones0,
                 npx=64, gn_iters=10):
        super().__init__()
        self.npx, self.gn_iters = int(npx), int(gn_iters)

        def buf(name, x, dtype):
            self.register_buffer(name, torch.as_tensor(x).to(dtype))

        for name, x in (("time_bin_indices", time_bin_indices),
                        ("time_bin_counts", time_bin_counts),
                        ("antenna1", antenna1), ("antenna2", antenna2)):
            buf(name, np.asarray(x, np.int64), torch.int64)
        for name, x in (("uvw", uvw), ("lm", lm), ("frequency", frequency),
                        ("image", image), ("weight", weight)):
            buf(name, np.asarray(x, np.float32), torch.float32)
        buf("model", model, torch.complex64)
        buf("jones0", jones0, torch.complex64)
        buf("flag", np.asarray(flag, bool), torch.bool)
        buf("grid_lm", grid_lm(npx), torch.float32)
        psf = torch.zeros((2 * npx, 2 * npx), dtype=torch.float32)
        psf[npx - 1, npx - 1] = 1.0
        self.register_buffer("psf", psf)
        # host planning, once: the gather table of the normal equations
        # and the two DFTs' plans, so that a step reads nothing back from
        # the card and sends nothing up to it
        sel, valid = ant_gather_table(time_bin_indices, time_bin_counts,
                                      antenna1, antenna2, self.jones0.shape[0],
                                      self.jones0.shape[1])
        self.register_buffer("gather_sel", sel)
        self.register_buffer("gather_valid", valid)
        freq = np.asarray(frequency, np.float32)
        self.forward_plan = dft_plan(self.uvw, self.lm, freq,
                                     self.image.shape[2])
        self.adjoint_plan = dft_plan(self.uvw, self.grid_lm, freq, 1,
                                     adjoint=True)

    def forward(self, data):
        """One step on ``data``, the (row, chan, corr) complex64 observed
        visibilities.

        Returns (gains, jhj, jhr, dirty, clean, residual_image, re_model):
        the solved (time, ant, chan, 1, corr) gains and their normal
        equations, the (npx, npx) dirty image of the residual, CLEAN's
        model and residual images, and the (row, chan, corr) re-predict.
        """
        meta = (self.time_bin_indices, self.time_bin_counts, self.antenna1,
                self.antenna2)
        gains, jhj, jhr, _ = gauss_newton(
            *meta, self.jones0, data, self.flag, self.model, self.weight,
            tol=0.0, maxiter=self.gn_iters,
            table=(self.gather_sel, self.gather_valid))
        resid = data - corrupt_vis(*meta, gains, self.model)
        im = vis_to_im(resid.sum(dim=-1, keepdim=True), self.uvw,
                       self.grid_lm, self.frequency, self.flag[..., :1],
                       plan=self.adjoint_plan)
        nvis = data.shape[0] * data.shape[1]
        dirty = im.sum(dim=(1, 2)).reshape(self.npx, self.npx) / nvis
        clean, residual_image = hogbom_clean(dirty, self.psf, gamma=_GAMMA,
                                             threshold=_THRESHOLD,
                                             niter=_CLEAN_NITER)
        re_model = im_to_vis(self.image, self.uvw, self.lm, self.frequency,
                             plan=self.forward_plan)
        return gains, jhj, jhr, dirty, clean, residual_image, re_model


def selfcal_inputs(nant, ntime, nchan, nsrc, ncorr, seed):
    """Seeded numpy inputs, equal to ``bench.py:1104-1143`` with
    ``default_rng(seed)``: a dict of time_bin_indices, time_bin_counts,
    antenna1, antenna2 (int32), lm, uvw, frequency, image, true_phase,
    weight (float32), flag (bool) and jones0, an (re, im) pair of
    (time, ant, chan, 1, corr) float32 arrays. The observed data come
    from :func:`make_data` (or the JAX package, in the tests)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    a1u, a2u = np.triu_indices(nant, 1)
    nrow = a1u.size * ntime
    gshape = (ntime, nant, nchan, 1, ncorr)
    return {
        "time_bin_indices": (np.arange(ntime) * a1u.size).astype(np.int32),
        "time_bin_counts": np.full(ntime, a1u.size, np.int32),
        "antenna1": np.tile(a1u, ntime).astype(np.int32),
        "antenna2": np.tile(a2u, ntime).astype(np.int32),
        "lm": rng.uniform(-0.01, 0.01, (nsrc, 2)).astype(f32),
        "uvw": rng.uniform(-4000, 4000, (nrow, 3)).astype(f32),
        "frequency": np.linspace(0.856e9, 1.712e9, nchan).astype(f32),
        "image": rng.uniform(0.1, 1.0, (nsrc, nchan, ncorr)).astype(f32),
        "true_phase": rng.uniform(-0.5, 0.5, gshape).astype(f32),
        "flag": np.zeros((nrow, nchan, ncorr), bool),
        "weight": np.ones((nrow, nchan, ncorr), f32),
        "jones0": (np.ones(gshape, f32), np.zeros(gshape, f32)),
    }


def _pair(z):
    z = z.cpu()
    return z.real.numpy().copy(), z.imag.numpy().copy()


def make_data(inputs, device):
    """The model and observed data of ``inputs``, made by the port on
    ``device`` as ``bench.py:1130-1137`` makes them: the model is
    :func:`im_to_vis` of the sky, the data the model corrupted by the
    true gain phases. Returns {"model": (re, im) of (row, chan, 1, corr),
    "data": (re, im) of (row, chan, corr)} float32 numpy pairs."""

    def t(x):
        return torch.as_tensor(x, device=device)

    model = im_to_vis(t(inputs["image"]), t(inputs["uvw"]), t(inputs["lm"]),
                      t(inputs["frequency"]))[:, :, None, :]
    phase = t(inputs["true_phase"])
    gains = torch.polar(torch.ones_like(phase), phase)
    data = corrupt_vis(inputs["time_bin_indices"], inputs["time_bin_counts"],
                       inputs["antenna1"], inputs["antenna2"], gains, model)
    return {"model": _pair(model), "data": _pair(data)}


def from_numpy(args, device, npx=64, gn_iters=10):
    """Carry a selfcal problem over to the port.

    ``args`` is a :func:`selfcal_inputs` dict with "model" and "data"
    entries added — (re, im) numpy pairs, as :func:`make_data` or the
    JAX package's ``Cplx`` pairs give them. Returns ``(step, data)``:
    the :class:`SelfcalStep` on ``device`` and the complex64 data tensor
    it takes.
    """
    def cplx(pair):
        re, im = (torch.from_numpy(np.array(x, np.float32)) for x in pair)
        return torch.complex(re, im)

    step = SelfcalStep(
        args["time_bin_indices"], args["time_bin_counts"], args["antenna1"],
        args["antenna2"], args["uvw"], args["lm"], args["frequency"],
        args["image"], cplx(args["model"]), args["flag"], args["weight"],
        cplx(args["jones0"]), npx=npx, gn_iters=gn_iters).to(device)
    return step, cplx(args["data"]).to(device)


def _delay_f64(uvw, lm):
    """(direction, row) u·l + v·m + w·(n−1) in float64."""
    uvw = np.asarray(uvw, np.float64)
    l, m = np.asarray(lm, np.float64).T  # noqa: E741
    n1 = np.sqrt(np.maximum(1 - l * l - m * m, 0)) - 1
    return (l[:, None] * uvw[None, :, 0] + m[:, None] * uvw[None, :, 1]
            + n1[:, None] * uvw[None, :, 2])


def im_to_vis_oracle_f64(image, uvw, lm, frequency):
    """Float64 numpy oracle of :func:`im_to_vis` (fourier convention):
    the plain formula, no two-float tricks. O(src·row·chan)."""
    p = (-2 * np.pi / lightspeed) * _delay_f64(uvw, lm)[:, :, None] * \
        np.asarray(frequency, np.float64)
    return np.einsum("srf,sfc->rfc", np.exp(1j * p),
                     np.asarray(image).astype(np.complex128))


def vis_to_im_oracle_f64(vis, uvw, lm, frequency):
    """Float64 numpy oracle of :func:`vis_to_im` (fourier convention, no
    flags). O(pixel·row·chan)."""
    p = (2 * np.pi / lightspeed) * _delay_f64(uvw, lm)[:, :, None] * \
        np.asarray(frequency, np.float64)
    vis = np.asarray(vis).astype(np.complex128)
    return (np.einsum("srf,rfc->sfc", np.cos(p), vis.real)
            - np.einsum("srf,rfc->sfc", np.sin(p), vis.imag))


def gain_product_error(gains, true_phase):
    """max over times, baselines, channels and correlations of
    |g_p·conj(g_q) − g_p,true·conj(g_q,true)|: the accuracy of a solve
    (``bench.py:1257-1266``), free of the phase's global ambiguity."""
    g = (gains.cpu().numpy() if isinstance(gains, torch.Tensor)
         else np.asarray(gains))[:, :, :, 0]
    gt = np.exp(1j * np.asarray(true_phase)[:, :, :, 0])
    a1u, a2u = np.triu_indices(g.shape[1], 1)
    prod = g[:, a1u] * np.conj(g[:, a2u])
    prod_t = gt[:, a1u] * np.conj(gt[:, a2u])
    return float(np.abs(prod - prod_t).max())
