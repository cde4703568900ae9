"""Selfcal against an MS-shaped column store: the full L4 pipeline.

Port of ``examples/selfcal_ms_store.py``. It fabricates a store whose
DATA column carries gain-corrupted model visibilities, then — reading
every input through :class:`africanus_tpu_torch.io.MSStore` — solves
phase-only gains (Gauss-Newton), writes CORRECTED_DATA back in place,
images the corrected data with the w-stacking gridder and CLEANs the
result. The reference's equivalents are the calibration example
workflows plus the MS write-back of rime/examples/predict.py:583-587.

    python -m africanus_tpu_torch.examples.selfcal_ms_store [store_dir]
        [--device cuda|cpu]

Float32, as the JAX example: the model is predicted by ``dft_forward``
on the card below 128 channels and by ``predict_kb`` from 128, the images
by ``grid_wstack``.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from africanus_tpu_torch.calibration import (
    chunkify_rows, correct_vis, corrupt_vis, gauss_newton,
)
from africanus_tpu_torch.deconv.hogbom import hogbom_clean
from africanus_tpu_torch.dft import im_to_vis
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.examples.predict_to_ms_store import chunk_digest
from africanus_tpu_torch.gridding.wgridder.core import grid_adjoint
from africanus_tpu_torch.io import MSStore
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["NX", "make_corrupted_store", "StoreSelfcal", "gain_product_error",
           "selfcal_ms_store", "main"]

NX = 64
GAIN_BOUND = 5e-4  # the JAX example's bound on the gain products


def make_corrupted_store(path, rng, nant=12, ntime=6, nchan=8, nsrc=4,
                         device="cuda"):
    """Store with DATA = gains · (DFT of a point-source sky) · gainsᴴ and
    MODEL_DATA the uncorrupted DFT, the JAX example's draws from ``rng``;
    the predict and the corruption run on ``device`` in float32. Returns
    the true (time, ant, chan, 1, 1) phases."""
    device = plan_device(device)
    a1u, a2u = np.triu_indices(nant, 1)
    nbl = a1u.size
    nrow = nbl * ntime
    time_col = np.repeat(5.03e9 + np.arange(ntime) * 8.0, nbl)
    a1 = np.tile(a1u, ntime).astype(np.int32)
    a2 = np.tile(a2u, ntime).astype(np.int32)
    ant_pos = rng.uniform(-1500, 1500, (nant, 3))
    ant_pos[:, 2] *= 0.02
    uvw = (ant_pos[a1] - ant_pos[a2]).astype(np.float32)
    freq = np.linspace(0.856e9, 1.712e9, nchan)

    fov = 0.02
    lm = rng.uniform(-fov / 3, fov / 3, (nsrc, 2)).astype(np.float32)
    flux = rng.uniform(0.5, 2.0, (nsrc, 1)).astype(np.float32)
    image = np.broadcast_to(flux[:, None, :], (nsrc, nchan, 1)).copy()
    _, tbi, tbc = chunkify_rows(time_col, 1)
    true_phase = rng.uniform(-0.6, 0.6, (ntime, nant, nchan, 1, 1)).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, device=device)

    model = im_to_vis(t(image), t(uvw), t(lm), freq.astype(np.float32))
    gains = torch.polar(torch.ones(true_phase.shape, device=device), t(true_phase))
    data = corrupt_vis(t(tbi), t(tbc), t(a1), t(a2), gains, model[:, :, None, :])
    MSStore.create(path, dict(
        TIME=time_col, ANTENNA1=a1, ANTENNA2=a2, UVW=uvw.astype(np.float64),
        DATA=data.cpu().numpy(),
        CORRECTED_DATA=np.zeros((nrow, nchan, 1), np.complex64),
        MODEL_DATA=model.cpu().numpy(),
    ), dict(
        SPECTRAL_WINDOW=dict(CHAN_FREQ=freq),
        FIELD=dict(PHASE_DIR=[0.0, 0.0]),
        SKY=dict(LM=lm, FLUX=flux[:, 0]),
    ))
    return true_phase


class StoreSelfcal(NamedTuple):
    """What :func:`selfcal_ms_store` did: the Gauss-Newton iterations,
    the largest baseline gain-product error against the truth, the
    :func:`~africanus_tpu_torch.examples.predict_to_ms_store.chunk_digest`
    of the CORRECTED_DATA it wrote, the normalised dirty image, the CLEAN
    components and residual (tensors), and the host-clock seconds of each
    stage (``read``, ``solve``, ``write``, ``image``, ``clean``; each ends
    on an idle device)."""

    iterations: int
    gain_error: float
    corrected_digest: str
    dirty: torch.Tensor
    clean: torch.Tensor
    residual: torch.Tensor
    stage_seconds: dict


def gain_product_error(gains, true_phase, nant):
    """max |g_p g_q* − t_p t_q*| over the baselines p < q, with
    t = exp(i·true_phase): phase-only solutions are fixed only up to a
    phase common to every antenna."""
    a1u, a2u = (torch.as_tensor(x, device=gains.device)
                for x in np.triu_indices(nant, 1))
    truth = torch.polar(torch.ones_like(true_phase), true_phase).to(gains.dtype)
    prod = gains[:, a1u] * gains[:, a2u].conj()
    prod_t = truth[:, a1u] * truth[:, a2u].conj()
    return float((prod - prod_t).abs().max())


def selfcal_ms_store(store_dir, true_phase, device="cuda"):
    """Solve, correct (CORRECTED_DATA written in place), image and CLEAN
    the store at ``store_dir`` on ``device``. Returns a
    :class:`StoreSelfcal`."""
    device = plan_device(device)
    stages = {}
    t0 = time.perf_counter()
    st = MSStore(store_dir)
    time_col = st.read("TIME")
    a1 = st.read("ANTENNA1")
    a2 = st.read("ANTENNA2")
    uvw = st.read("UVW").astype(np.float32)
    freq = np.asarray(st.subtables["SPECTRAL_WINDOW"]["CHAN_FREQ"], np.float32)
    data = torch.as_tensor(st.read("DATA"), device=device)
    model2 = torch.as_tensor(st.read("MODEL_DATA"), device=device)[:, :, None, :]
    _, tbi, tbc = chunkify_rows(time_col, 1)
    ntime, nant = tbi.shape[0], int(max(a1.max(), a2.max())) + 1
    nchan = freq.shape[0]
    idx = [torch.as_tensor(x, device=device) for x in (tbi, tbc, a1, a2)]
    sync(device)
    stages["read"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    flag = torch.zeros(data.shape, dtype=torch.bool, device=device)
    weight = torch.ones(data.shape, dtype=torch.float32, device=device)
    jones0 = torch.ones((ntime, nant, nchan, 1, 1), dtype=torch.complex64, device=device)
    gains, _, _, k = gauss_newton(*idx, jones0, data, flag, model2, weight,
                                  tol=1e-7, maxiter=60)
    corrected = correct_vis(*idx, gains, data, flag)
    sync(device)
    stages["solve"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    host = corrected.cpu().numpy()
    st.write("CORRECTED_DATA", host)
    stages["write"] = time.perf_counter() - t0
    gerr = gain_product_error(gains[..., 0], torch.as_tensor(true_phase[..., 0],
                                                             device=device), nant)

    t0 = time.perf_counter()
    cell = np.float32(0.03 / NX)
    vis = corrected[..., 0]
    dirty = grid_adjoint(uvw, freq, vis, None, NX, NX, cell, cell, 1e-4,
                         do_wstacking=False)
    psf = grid_adjoint(uvw, freq, torch.ones_like(vis), None, 2 * NX, 2 * NX,
                       cell, cell, 1e-4, do_wstacking=False)
    sync(device)
    stages["image"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ndirty = dirty / psf.max()
    # hogbom expects the psf peak at (npix-1, npix-1); the FFT-gridded
    # psf of an even image peaks at (npix, npix) — shift by one
    psf = torch.roll(psf, (-1, -1), dims=(0, 1))
    cleaned, resid = hogbom_clean(ndirty, psf / psf.max(), gamma=0.1,
                                  threshold=0.3, niter=150)
    sync(device)
    stages["clean"] = time.perf_counter() - t0
    return StoreSelfcal(int(k), gerr, chunk_digest(host), ndirty, cleaned, resid,
                        stages)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("store_dir", nargs="?")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    rng = np.random.default_rng(17)
    with tempfile.TemporaryDirectory() as tmp:
        store_dir = Path(args.store_dir or Path(tmp) / "selfcal_ms_store")
        before = counts()
        t0 = time.perf_counter()
        true_phase = make_corrupted_store(store_dir, rng, device=device)
        fabricate = time.perf_counter() - t0
        st = MSStore(store_dir)
        print(f"store: {st.nrow} rows, columns {st.columns()}")
        run = selfcal_ms_store(store_dir, true_phase, device)
        print(f"device: {device_name(device)} (float32); {describe(since(before))}")
        print(f"gauss-newton converged in {run.iterations} iterations")
        print(f"max baseline gain-product error: {run.gain_error:.2e}")
        cleaned = run.clean.cpu().numpy()
        print(f"dirty peak {float(run.dirty.max()):.3f}, cleaned flux "
              f"{cleaned.sum():.3f}, |residual| peak "
              f"{float(run.residual.abs().max()):.3f} (seconds: fabricate "
              f"{fabricate:.2f}, " + ", ".join(
                  f"{k} {v:.2f}" for k, v in run.stage_seconds.items()) + ")")
        # CLEAN must remove the brightest structure it was asked to
        reread = MSStore(store_dir).read_pair("CORRECTED_DATA")
        checks = {"CLEAN found no component": cleaned.max() > 0,
                  "CORRECTED_DATA re-read differs from what was written":
                      chunk_digest(reread) == run.corrected_digest,
                  f"gain products {run.gain_error:.2e} from the truth":
                      run.gain_error < GAIN_BOUND}
        for what, ok in checks.items():
            if not ok:
                raise SystemExit(what)
    print("selfcal pipeline round trip OK")


if __name__ == "__main__":
    main()
