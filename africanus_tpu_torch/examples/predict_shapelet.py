"""Predict visibilities from shapelet sources.

Port of ``examples/predict_shapelet.py`` (the reference's
``africanus/rime/examples/predict_shapelet.py`` CLI): a shapelet sky
model → K phase · shapelet envelope · brightness → the Jones-chain
predict (:func:`africanus_tpu_torch.rime.predict_vis`), on a synthetic
KAT-7-like observation.

    python -m africanus_tpu_torch.examples.predict_shapelet [--device cuda|cpu]

Float32, as the JAX example. Every step is torch operations: no kernel
of the port's own runs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from africanus_tpu_torch.coordinates import radec_to_lm
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.model.coherency import convert
from africanus_tpu_torch.model.shape.shapelets import _shapelet_core
from africanus_tpu_torch.model.spectral import spectral_model
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.rime import phase_delay, predict_vis

__all__ = ["shapelet_inputs", "predict_shapelet", "main"]

DELTA_LM = (1e-6, 1e-6)


def shapelet_inputs(nant=7, ntime=8, nchan=32, seed=0):
    """The JAX example's draws from ``default_rng(seed)`` (float64): three
    shapelet sources of 4×4 coefficients and their Stokes spectra, and
    the observation's baselines, uvw and frequencies."""
    rng = np.random.default_rng(seed)
    nsrc, nmax = 3, 4
    radec = np.deg2rad(np.array([[60.02, -50.5], [60.00, -50.52], [59.98, -50.49]]))
    beta = rng.uniform(1e-3, 3e-3, (nsrc, 2))
    coeffs = rng.normal(size=(nsrc, nmax, nmax)) * 0.2
    coeffs[:, 0, 0] = 1.0  # dominant gaussian-like mode
    stokes = np.stack([rng.uniform(0.5, 2.0, nsrc), rng.uniform(-0.1, 0.1, nsrc),
                       rng.uniform(-0.1, 0.1, nsrc), np.zeros(nsrc)], axis=1)
    spi = rng.uniform(-0.8, -0.5, (nsrc, 1, 4))
    a1u, a2u = np.triu_indices(nant, 1)
    nbl = a1u.size
    time_index = np.repeat(np.arange(ntime), nbl)
    uvw = rng.uniform(-1000, 1000, (time_index.size, 3))
    return dict(radec=radec, beta=beta, coeffs=coeffs, stokes=stokes, spi=spi,
                antenna1=np.tile(a1u, ntime), antenna2=np.tile(a2u, ntime),
                time_index=time_index, uvw=uvw,
                freq=np.linspace(0.856e9, 1.712e9, nchan),
                ref_freq=np.full(nsrc, 1.2e9))


def predict_shapelet(radec, beta, coeffs, stokes, spi, antenna1, antenna2,
                     time_index, uvw, freq, ref_freq, device="cuda",
                     dtype=torch.float32):
    """(row, chan, 4) visibilities of the shapelet sources, on ``device``
    in ``dtype`` (complex64 for float32)."""
    device = plan_device(device)

    def t(x):
        return torch.as_tensor(x, device=device).to(dtype)

    radec = torch.as_tensor(radec)
    lm = t(radec_to_lm(radec, radec.mean(dim=0)))
    uvw, freq = t(uvw), t(freq)
    k = phase_delay(lm, uvw, freq)  # (src, row, chan)
    re, im = _shapelet_core(uvw, freq, t(coeffs), t(beta), DELTA_LM, dtype)
    env = torch.complex(re, im).permute(2, 0, 1)  # (src, row, chan)
    spec = spectral_model(t(stokes), t(spi), t(ref_freq), freq)
    b = convert(spec.to(dtype.to_complex()), ["I", "Q", "U", "V"],
                ["XX", "XY", "YX", "YY"])  # (src, chan, 4)
    coh = (k * env)[..., None] * b[:, None]
    idx = [torch.as_tensor(x, device=device) for x in (time_index, antenna1, antenna2)]
    return predict_vis(*idx, source_coh=coh)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    inputs = shapelet_inputs()
    before = counts()
    t0 = time.perf_counter()
    vis = predict_shapelet(**inputs, device=device)
    sync(device)
    dt = time.perf_counter() - t0
    vis = vis.cpu().numpy()
    print(f"device: {device_name(device)} (float32); {describe(since(before))}")
    print(f"predicted vis: {vis.shape} in {dt:.2f}s")
    print(f"|vis| range: [{np.abs(vis).min():.4f}, {np.abs(vis).max():.4f}]")


if __name__ == "__main__":
    main()
