"""Simple SPI fitter example.

Port of ``examples/fit_spi.py`` (the reference's
``africanus/model/spi/examples/simple_spi_fitter.py`` with the FITS
image IO replaced by a synthetic component spectrum cube): noisy
power-law spectra fitted with
:func:`africanus_tpu_torch.model.spi.fit_spi_components`.

    python -m africanus_tpu_torch.examples.fit_spi [--device cuda|cpu]

Float32, as the JAX example. The fit is torch operations: no kernel of
the port's own runs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.model.spi import fit_spi_components
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["FREQ0", "spectra", "fit_spi", "main"]

FREQ0 = 1.2e9


def spectra(ncomp=512, nchan=64, sigma=0.01, seed=3):
    """The JAX example's draws: (data (ncomp, nchan), weights (nchan,),
    freqs (nchan,), alpha_true, i0_true), float64."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(0.856e9, 1.712e9, nchan)
    alpha_true = rng.uniform(-1.2, -0.2, ncomp)
    i0_true = rng.uniform(0.5, 5.0, ncomp)
    data = i0_true[:, None] * (freqs / FREQ0) ** alpha_true[:, None]
    data = data + rng.normal(scale=sigma, size=data.shape)
    weights = np.full(nchan, 1.0 / sigma**2)
    return data, weights, freqs, alpha_true, i0_true


def fit_spi(data, weights, freqs, device="cuda", dtype=torch.float32, maxiter=100):
    """(4, ncomp) [alpha, alpha_var, I0, I0_var] of the spectra, fitted
    on ``device`` in ``dtype``."""
    device = plan_device(device)
    ops = [torch.as_tensor(x, device=device).to(dtype) for x in (data, weights, freqs)]
    return fit_spi_components(*ops, FREQ0, maxiter=maxiter)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    data, weights, freqs, alpha_true, i0_true = spectra()
    before = counts()
    t0 = time.perf_counter()
    out = fit_spi(data, weights, freqs, device)
    sync(device)
    dt = time.perf_counter() - t0
    alpha, alpha_var, i0, i0_var = out.cpu().double().numpy()
    print(f"device: {device_name(device)} (float32); {describe(since(before))}")
    print(f"fitted {data.shape[0]} components in {dt:.2f}s")
    print(f"alpha error: mean {np.abs(alpha - alpha_true).mean():.4f} "
          f"(typical 1σ {np.sqrt(alpha_var).mean():.4f})")
    print(f"I0 rel error: mean "
          f"{(np.abs(i0 - i0_true) / i0_true).mean():.4f}")


if __name__ == "__main__":
    main()
