"""End-to-end selfcal loop (BASELINE config 5): simulate gain-corrupted
data → phase-only Gauss-Newton solve → correct → image → Hogbom CLEAN.

Port of ``examples/selfcal.py`` (the reference's calibration and deconv
example workflows). The model visibilities come from
:func:`africanus_tpu_torch.dft.im_to_vis` (the ``dft_forward`` kernel on
the card at the example's 16 channels), the images from
:func:`~africanus_tpu_torch.gridding.wgridder.core.grid_adjoint`
(``grid_wstack``).

    python -m africanus_tpu_torch.examples.selfcal [--device cuda|cpu]

Float32 throughout, as the JAX example.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from africanus_tpu_torch.calibration import (
    chunkify_rows, correct_vis, corrupt_vis, gauss_newton,
)
from africanus_tpu_torch.constants import c as C
from africanus_tpu_torch.deconv.hogbom import hogbom_clean
from africanus_tpu_torch.dft import im_to_vis
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.gridding.wgridder.core import grid_adjoint
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["NPIX", "Observation", "observation", "SelfcalRun", "selfcal", "main"]

NPIX = 64


class Observation(NamedTuple):
    """The JAX example's synthetic observation (host arrays): baselines,
    time bins, uvw (float32), frequencies, the two-source sky (lm,
    image) and the true per-(time, antenna, channel, correlation)
    phases."""

    ant1: np.ndarray
    ant2: np.ndarray
    tbi: np.ndarray
    tbc: np.ndarray
    uvw: np.ndarray
    freq: np.ndarray
    cell: float
    lm: np.ndarray
    image: np.ndarray
    true_phase: np.ndarray


def observation(nant=16, ntime=8, nchan=16, seed=7):
    """The JAX example's draws from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    a1u, a2u = np.triu_indices(nant, 1)
    ant1 = np.tile(a1u, ntime).astype(np.int32)
    ant2 = np.tile(a2u, ntime).astype(np.int32)
    time_col = np.repeat(np.arange(ntime, dtype=np.float64), a1u.size)
    _, tbi, tbc = chunkify_rows(time_col, 1)
    nrow = ant1.size
    cell = 2.0 * np.pi / 180 / NPIX
    freq = np.linspace(1.0e9, 1.2e9, nchan)
    uvw = ((rng.uniform(size=(nrow, 3)) - 0.5) / (cell * freq[-1] / C)).astype(f32)
    lm = np.array([[0.0, 0.0], [0.003, -0.002]], f32)
    image = np.array([[1.0], [0.6]], f32)[:, None, :].repeat(nchan, 1)
    true_phase = rng.uniform(-0.5, 0.5, (ntime, nant, nchan, 1, 2)).astype(f32)
    return Observation(ant1, ant2, tbi, tbc, uvw, freq, cell, lm, image, true_phase)


class SelfcalRun(NamedTuple):
    """What :func:`selfcal` computed (tensors on its device): the solved
    gains and the iterations taken, the dirty image of the corrected
    data, the CLEAN components and residual, and the host-clock seconds
    of each stage (``simulate``, ``solve``, ``image``, ``clean``; each
    ends on an idle device)."""

    gains: torch.Tensor
    iterations: int
    dirty: torch.Tensor
    clean: torch.Tensor
    residual: torch.Tensor
    stage_seconds: dict


def selfcal(obs, device="cuda"):
    """Run the JAX example's pipeline on :class:`Observation` ``obs`` on
    ``device`` (the card by default; raises without one)."""
    device = plan_device(device)
    f32 = np.float32
    nrow, nchan = obs.uvw.shape[0], obs.freq.shape[0]
    freq32 = obs.freq.astype(f32)
    idx = [torch.as_tensor(x, device=device) for x in
           (obs.tbi, obs.tbc, obs.ant1, obs.ant2)]
    stages = {}

    t0 = time.perf_counter()
    model = im_to_vis(torch.as_tensor(obs.image, device=device),
                      torch.as_tensor(obs.uvw, device=device),
                      torch.as_tensor(obs.lm, device=device), freq32)
    model4 = model[..., 0, None, None].expand(nrow, nchan, 1, 2).contiguous()
    true_g = torch.polar(torch.ones(obs.true_phase.shape, device=device),
                         torch.as_tensor(obs.true_phase, device=device))
    data = corrupt_vis(*idx, true_g, model4)
    sync(device)
    stages["simulate"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flag = torch.zeros((nrow, nchan, 2), dtype=torch.bool, device=device)
    weight = torch.ones((nrow, nchan, 2), dtype=torch.float32, device=device)
    g0 = torch.ones(obs.true_phase.shape, dtype=torch.complex64, device=device)
    gains, _, _, iters = gauss_newton(*idx, g0, data, flag, model4, weight,
                                      tol=1e-6, maxiter=60)
    sync(device)
    stages["solve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    corrected = correct_vis(*idx, gains, data, flag)
    dirty = grid_adjoint(obs.uvw, freq32, corrected[..., 0], None, NPIX, NPIX,
                         obs.cell, obs.cell, 1e-4, False)
    ones = torch.ones((nrow, nchan), dtype=torch.complex64, device=device)
    psf = grid_adjoint(obs.uvw, freq32, ones, None, 2 * NPIX, 2 * NPIX,
                       obs.cell, obs.cell, 1e-4, False)
    sync(device)
    stages["image"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # hogbom_clean expects the PSF peak at pixel (npix-1, npix-1) of the
    # (2npix, 2npix) array; the FFT-centred gridder peaks at (npix, npix)
    psf = torch.roll(psf, (-1, -1), dims=(0, 1))
    psf = psf / psf.max()
    clean, resid = hogbom_clean(dirty, psf, gamma=0.2, threshold=0.1, niter=200)
    sync(device)
    stages["clean"] = time.perf_counter() - t0
    return SelfcalRun(gains, int(iters), dirty, clean, resid, stages)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    obs = observation()
    before = counts()
    run = selfcal(obs, args.device)
    dirty = run.dirty.cpu().numpy()
    clean = run.clean.cpu().numpy()
    print(f"device: {device_name(run.dirty.device)} (float32); "
          f"{describe(since(before))}")
    print("simulated corrupted data:", (obs.uvw.shape[0], obs.freq.shape[0], 2))
    print(f"gauss-newton converged in {run.iterations} iterations "
          f"({run.stage_seconds['solve']:.2f}s)")
    peak = np.unravel_index(np.argmax(clean), clean.shape)
    print(f"CLEAN peak at pixel {peak} (image centre = ({NPIX//2}, {NPIX//2}))")
    print(f"residual max: {float(run.residual.max()):.4f} "
          f"(dirty max was {dirty.max():.4f})")


if __name__ == "__main__":
    main()
