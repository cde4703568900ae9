"""Simulate smooth phase-only gains from a Gaussian process.

Port of ``examples/generate_gains.py`` (the reference's
``gps/examples/generate_phase_only_gains.py``): per-antenna phase screens
drawn from a separable GP over (time, frequency, direction) with the
exponential-squared kernel and Kronecker algebra (``kron_cholesky``,
then the factors applied to every antenna's normal draws at once), and
written as a gain table (``.npy``, (time, ant, chan, dir, corr=1)).

    python -m africanus_tpu_torch.examples.generate_gains [out.npy]
        [--device cuda|cpu]

The draws ξ come from ``numpy.random.default_rng(42)`` antenna by
antenna, after the directions, exactly as the JAX example draws them,
so that both write the same table. The covariances are float64 (the JAX
example's numpy arrays), and so are the draws (:func:`gp_phase_gains`
also runs them in float32). No kernel of the port's own runs here: the
products are ``torch.matmul``, as the JAX package's are ``jnp.matmul``.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from africanus_tpu_torch.coordinates import radec_to_lm
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.gps import exponential_squared
from africanus_tpu_torch.linalg import kron_cholesky, kron_matmat
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["GPGains", "gp_phase_gains", "example_coordinates", "main"]

# the JAX example's kernel scales and lengths for (time, frequency,
# direction), and the diagonal it adds to each covariance
SIGMAS = (0.25, 0.25, 0.25)
LENGTHS = (0.2, 0.3, 0.5)
JITTER = 1e-6


class GPGains(NamedTuple):
    """What :func:`gp_phase_gains` made: ``gains`` (time, ant, chan, dir,
    1) complex, ``phases`` (time, ant, chan, dir) real, and the
    covariances ``covariances`` (Kt, Kν, Ks, each with the added diagonal)
    and their Cholesky ``factors``, float64."""

    gains: torch.Tensor
    phases: torch.Tensor
    covariances: list
    factors: list


def gp_phase_gains(t, nu, src_coord, nant, sigmas=SIGMAS, lengths=LENGTHS,
                   xi=None, generator=None, device="cuda", dtype=torch.float64):
    """Phase-only gains exp(iφ) with φ drawn per antenna from the GP of
    covariance Kt ⊗ Kν ⊗ Ks.

    Parameters
    ----------
    t, nu : (ntime,), (nchan,) normalised coordinates (host arrays)
    src_coord : (ndir, 2) normalised direction coordinates
    nant : number of antennas
    sigmas, lengths : the three exponential-squared kernels' σ_f and l
    xi : optional (nant, ntime·nchan·ndir) normal draws (array or
        tensor); None draws them on ``device`` with ``generator``
    generator : ``torch.Generator`` on ``device`` for the draws
    device : where everything runs (the card by default; raises without
        one)
    dtype : float64 or float32, the dtype of the draws and the gains

    The covariances and their Cholesky factors are float64 whatever
    ``dtype``: they are small (the largest nchan²), and a float32
    Cholesky of a near-singular GP covariance is not the same factor.
    The work — the factors applied to every antenna's draws, as batched
    matmuls — runs in ``dtype``.

    Returns a :class:`GPGains`.
    """
    device = plan_device(device)
    f64 = torch.float64
    coords = [torch.as_tensor(np.asarray(c, np.float64), device=device)
              for c in (t, nu, src_coord)]
    covariances = []
    for c, sigma, length in zip(coords, sigmas, lengths):
        k = exponential_squared(c, c, sigma, length)
        covariances.append(k + JITTER * torch.eye(k.shape[0], dtype=f64, device=device))
    factors = kron_cholesky(covariances)
    ntime, nchan, ndir = (k.shape[0] for k in covariances)
    n = ntime * nchan * ndir
    if xi is None:
        xi = torch.randn((nant, n), generator=generator, dtype=dtype, device=device)
    else:
        xi = torch.as_tensor(xi, device=device).to(dtype)
    if xi.shape != (nant, n):
        raise ValueError(f"xi must be ({nant}, {n}), got {tuple(xi.shape)}")
    draws = kron_matmat([L.to(dtype) for L in factors], xi.T).T
    phases = draws.reshape(nant, ntime, nchan, ndir).permute(1, 0, 2, 3).contiguous()
    del draws
    # cos and sin straight into the gains' (re, im) lanes: no unit
    # amplitudes and no complex intermediate the size of the gains
    gains = torch.empty(phases.shape + (1,), dtype=dtype.to_complex(), device=device)
    lanes = torch.view_as_real(gains)[..., 0, :]
    torch.cos(phases, out=lanes[..., 0])
    torch.sin(phases, out=lanes[..., 1])
    return GPGains(gains, phases, covariances, factors)


def example_coordinates(rng, ntime, nchan, ndir):
    """The JAX example's normalised coordinates: ``ndir`` directions drawn
    from ``rng`` about (1.0, -0.9) rad, projected about their mean and
    scaled to unit maximum."""
    t = np.linspace(0.0, 1.0, ntime)
    nu = np.linspace(0.0, 1.0, nchan)
    radec = rng.uniform(-0.01, 0.01, (ndir, 2)) + np.array([1.0, -0.9])
    lm = radec_to_lm(torch.as_tensor(radec),
                     torch.as_tensor(radec.mean(axis=0))).numpy()
    return t, nu, lm / np.abs(lm).max()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?",
                   default=str(Path(tempfile.gettempdir()) / "gp_gains.npy"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ntime, nchan, nant, ndir = 16, 8, 7, 3
    rng = np.random.default_rng(42)
    t, nu, src_coord = example_coordinates(rng, ntime, nchan, ndir)
    xi = np.stack([rng.normal(size=ntime * nchan * ndir) for _ in range(nant)])

    before = counts()
    t0 = time.perf_counter()
    out = gp_phase_gains(t, nu, src_coord, nant, xi=xi, device=args.device)
    sync(out.gains.device)
    dt = time.perf_counter() - t0
    gains = out.gains.cpu().numpy()
    phases = out.phases.cpu().numpy()
    np.save(args.out, gains)
    print(f"device: {device_name(out.gains.device)} (float64, {dt:.3f} s); "
          f"{describe(since(before))}")
    print(f"gains: {gains.shape} -> {args.out}")
    print(f"phase std: {phases.std():.3f} rad; "
          f"|g|=1 check: {np.abs(np.abs(gains) - 1).max():.1e}")


if __name__ == "__main__":
    main()
