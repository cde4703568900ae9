"""Apply a phase screen to an MS-shaped column store, then calibrate it.

Port of ``examples/apply_phase_screen_ms_store.py`` (the reference's
calibration/utils/examples/apply_phase_screen_to_ms.py): differential-
TEC-like gains as a per-antenna *linear phase screen* over the sky —
φ(l, m) = (α₀ + α₁·l + α₂·m)/ν̄ per (time, antenna, corr) — corrupt
per-direction point-source model visibilities with
:func:`~africanus_tpu_torch.calibration.compute_and_corrupt_vis`, written
to the store's DATA column in row chunks; then the phase-only
Gauss-Newton solver runs on the result and the recovered gain products
are held against the screen (the reference's ``calibrate`` leg and its
assert).

    python -m africanus_tpu_torch.examples.apply_phase_screen_ms_store
        [store_dir] [--device cuda|cpu]

Float64 (complex128), as the JAX example's numpy inputs. Every step is
torch operations: no kernel of the port's own runs.
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
    chunkify_rows, compute_and_corrupt_vis, gauss_newton,
)
from africanus_tpu_torch.constants import minus_two_pi_over_c
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.examples.predict_to_ms_store import chunk_digest
from africanus_tpu_torch.examples.selfcal_ms_store import gain_product_error
from africanus_tpu_torch.io import MSStore
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["UTIMES_PER_CHUNK", "make_screen", "fabricate_store", "ScreenRun",
           "apply_phase_screen", "calibrate", "main"]

UTIMES_PER_CHUNK = 4
SCREEN_BOUND = 1e-3  # the JAX example's bound on the gain products


def make_screen(lm, freq, n_time, n_ant, n_corr, rng):
    """Linear phase screens: φ = basis(l, m)·α per (time, ant, corr),
    scaled by 1/ν_norm (the reference's make_screen). Returns the (time,
    ant, chan, dir, corr) phases and the (time, ant, 3, corr) screen
    coefficients, float64 numpy."""
    n_dir = lm.shape[0]
    basis = np.stack([np.ones(n_dir), lm[:, 0], lm[:, 1]], axis=1)  # (dir, 3)
    alphas = 0.05 * rng.standard_normal((n_time, n_ant, 3, n_corr))
    freq_norm = freq / freq.max()
    screen = np.einsum("dk,takc->tadc", basis, alphas)
    phases = screen[:, :, None, :, :] / freq_norm[None, None, :, None, None]
    return phases, alphas


def fabricate_store(path, rng, nant=10, ntime=8, nchan=12, nsrc=3):
    """The JAX example's store (the same draws from ``rng``): DATA zero,
    FLAG false, the sky as a SKY subtable."""
    a1u, a2u = np.triu_indices(nant, 1)
    nbl = a1u.size
    time_col = np.repeat(5.03e9 + np.arange(ntime) * 8.0, nbl)
    nrow = time_col.size
    ant_pos = rng.uniform(-2000, 2000, (nant, 3))
    ant_pos[:, 2] *= 0.02
    a1 = np.tile(a1u, ntime).astype(np.int32)
    a2 = np.tile(a2u, ntime).astype(np.int32)
    uvw = (ant_pos[a1] - ant_pos[a2]).astype(np.float64)
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    lm = rng.uniform(-0.01, 0.01, (nsrc, 2))
    flux = rng.uniform(0.5, 2.0, nsrc)
    MSStore.create(
        path,
        dict(TIME=time_col, ANTENNA1=a1, ANTENNA2=a2, UVW=uvw,
             DATA=np.zeros((nrow, nchan, 1), np.complex64),
             FLAG=np.zeros((nrow, nchan, 1), bool)),
        dict(SPECTRAL_WINDOW=dict(CHAN_FREQ=freq), FIELD=dict(PHASE_DIR=[0.0, 0.0]),
             SKY=dict(LM=lm, FLUX=flux)),
    )


class ScreenRun(NamedTuple):
    """What :func:`apply_phase_screen` wrote: the (time, ant, chan, dir,
    corr) screen phases and its (time, ant, 3, corr) coefficients, the
    row slices of DATA and the ``chunk_digest`` of each, and the
    host-clock seconds of each chunk's corrupt (to an idle device) and
    write."""

    phases: np.ndarray
    alphas: np.ndarray
    slices: list
    digests: list
    stage_seconds: list


def _store_sky(store):
    time_col = store.read("TIME")
    a1 = store.read("ANTENNA1")
    a2 = store.read("ANTENNA2")
    freq = np.asarray(store.subtables["SPECTRAL_WINDOW"]["CHAN_FREQ"])
    lm = np.asarray(store.subtables["SKY"]["LM"])
    flux = np.asarray(store.subtables["SKY"]["FLUX"])
    return time_col, a1, a2, freq, lm, flux


def apply_phase_screen(store_dir, rng, device="cuda"):
    """Draw the screen from ``rng`` and write DATA = the screen-corrupted
    per-direction flat-spectrum point-source model, ``UTIMES_PER_CHUNK``
    unique times of rows at a time, computed on ``device`` in float64.
    Returns a :class:`ScreenRun`."""
    device = plan_device(device)
    store = MSStore(store_dir)
    time_col, a1, a2, freq, lm, flux = _store_sky(store)
    nant = int(max(a1.max(), a2.max())) + 1
    nchan, nsrc = freq.size, lm.shape[0]
    row_chunks, tbi, tbc = chunkify_rows(time_col, UTIMES_PER_CHUNK)
    n_time = tbi.size
    phases, alphas = make_screen(lm, freq, n_time, nant, 1, rng)

    def t(x):
        return torch.as_tensor(x, device=device)

    model = t(flux).to(torch.complex128)[None, None, :, None].expand(
        n_time, nchan, nsrc, 1)
    lm_t = t(lm)[None].expand(n_time, nsrc, 2)
    jones = torch.polar(torch.ones(phases.shape, dtype=torch.float64, device=device),
                        t(phases))
    freq_d = t(freq)
    slices, digests, stages = [], [], []
    row0 = t0 = 0
    for chunk in row_chunks:
        rows = slice(row0, row0 + chunk)
        tsl = slice(t0, t0 + UTIMES_PER_CHUNK)
        s0 = time.perf_counter()
        out = compute_and_corrupt_vis(
            t(tbi[tsl] - tbi[t0]), t(tbc[tsl]), t(a1[rows]), t(a2[rows]),
            jones[tsl], model[tsl], t(store.read("UVW", rows)), freq_d, lm_t[tsl])
        host = out.cpu().numpy().astype(np.complex64)
        s1 = time.perf_counter()
        store.write("DATA", host, rows)
        stages.append(dict(corrupt=s1 - s0, write=time.perf_counter() - s1))
        slices.append(rows)
        digests.append(chunk_digest(host))
        row0 += chunk
        t0 += min(UTIMES_PER_CHUNK, n_time - t0)
    return ScreenRun(phases, alphas, slices, digests, stages)


def calibrate(store_dir, phases, device="cuda"):
    """The reference's calibrate leg: phase-only Gauss-Newton (a gain per
    (time, ant, chan, dir, corr)) on the store's DATA against the
    uncorrupted per-direction model, on ``device`` in float64. Returns
    (gains, iterations, the largest gain-product error against
    ``phases``)."""
    device = plan_device(device)
    store = MSStore(store_dir)
    time_col, a1, a2, freq, lm, flux = _store_sky(store)
    nant = int(max(a1.max(), a2.max())) + 1
    nchan, nsrc = freq.size, lm.shape[0]
    _, tbi, tbc = chunkify_rows(time_col, UTIMES_PER_CHUNK)

    def t(x):
        return torch.as_tensor(x, device=device)

    data = t(store.read("DATA")).to(torch.complex128)
    uvw = t(store.read("UVW"))
    flag = t(store.read("FLAG"))
    weight = torch.ones(data.shape, dtype=torch.float64, device=device)

    # per-direction model visibilities (uncorrupted K·flux)
    l, m = t(lm[:, 0]), t(lm[:, 1])  # noqa: E741
    n = torch.sqrt(1.0 - l * l - m * m)
    dot = uvw[:, 0, None] * l + uvw[:, 1, None] * m + uvw[:, 2, None] * (n - 1.0)
    p = minus_two_pi_over_c * dot[:, None, :] * t(freq)[None, :, None]
    model_vis = (torch.polar(t(flux) / n, p))[..., None]  # (row, chan, dir, 1)

    jones0 = torch.ones((tbi.size, nant, nchan, nsrc, 1), dtype=torch.complex128,
                        device=device)
    idx = [t(x) for x in (tbi, tbc, a1, a2)]
    gains, _, _, k = gauss_newton(*idx, jones0, data, flag, model_vis, weight,
                                  tol=1e-8, maxiter=120)
    # phase-only solutions have a per-time/chan unitary ambiguity: hold
    # the gain *products* to the screen's
    err = gain_product_error(gains, t(phases), nant)
    return gains, int(k), err


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("store_dir", nargs="?")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    rng = np.random.default_rng(23)
    with tempfile.TemporaryDirectory() as tmp:
        store_dir = Path(args.store_dir or Path(tmp) / "phase_screen_ms_store")
        if not (store_dir / "meta.json").exists():
            fabricate_store(store_dir, rng)
        before = counts()
        run = apply_phase_screen(store_dir, rng, device)
        print(f"screen: {run.alphas.shape} coefficients over {run.alphas.shape[0]} "
              f"times, {run.alphas.shape[1]} antennas")
        print(f"wrote corrupted DATA: {run.slices[-1].stop} rows in "
              f"{len(run.slices)} chunks")
        reread = MSStore(store_dir)
        if not all(chunk_digest(reread.read_pair("DATA", sl)) == d
                   for sl, d in zip(run.slices, run.digests)):
            raise SystemExit("DATA re-read differs from what was written")
        t0 = time.perf_counter()
        _, iterations, err = calibrate(store_dir, run.phases, device)
        sync(device)
        dt = time.perf_counter() - t0
    print(f"device: {device_name(device)} (float64); {describe(since(before))}")
    print(f"gauss-newton converged in {iterations} iterations ({dt:.2f} s)")
    print(f"max gain-product error vs screen: {err:.2e}")
    if not err < SCREEN_BOUND:
        raise SystemExit(f"gain products {err:.2e} from the screen")
    print("phase screen applied and recovered OK")


if __name__ == "__main__":
    main()
