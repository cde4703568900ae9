"""Define a custom fused-RIME Term and run it.

Port of ``examples/custom_rime_term.py`` (the reference's
``experimental/rime/fused/examples/custom_brightness_term.py``): a
``ModelFlux`` term replaces the standard Brightness term with a
user-supplied per-(source, chan, corr) flux array through the port's
Term protocol (``ARGS`` pulled from the dataset, ``sample(state) ->
TermValue``), and the result is held against the explicit K × flux sum.

    python -m africanus_tpu_torch.examples.custom_rime_term [--device cuda|cpu]

Float64, as the JAX example's numpy dataset. The fused RIME is torch
operations: no kernel of the port's own runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from africanus_tpu_torch.coordinates import radec_to_lm
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.rime import phase_delay
from africanus_tpu_torch.rime.fused import RimeSpecification, Term, TermValue, rime

__all__ = ["ModelFlux", "SPEC", "dataset", "custom_rime", "explicit", "main"]

SPEC = "(Kpq, Cpq): [I,Q,U,V] -> [XX,XY,YX,YY]"


class ModelFlux(Term):
    """Custom flux provider: a (source, chan, corr) ``model_flux`` array
    replaces the Brightness term's Stokes → correlation machinery."""

    ARGS = ("model_flux",)
    SOURCE_ARGS = ("model_flux",)

    def sample(self, state) -> TermValue:
        flux = state["model_flux"]  # (src, chan, corr)
        ncorr = flux.shape[2]
        comps = tuple(flux[:, None, :, c].to(flux.dtype.to_complex())
                      for c in range(ncorr))
        kind = {1: "scalar", 2: "diag", 4: "full"}[ncorr]
        return TermValue(kind, comps)


def dataset(nsrc=6, ntime=3, nant=7, nchan=16, seed=0):
    """The JAX example's float64 dataset from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    a1u, a2u = np.triu_indices(nant, 1)
    nrow = a1u.size * ntime
    return dict(
        time=np.repeat(5.03e9 + np.arange(ntime) * 8.0, a1u.size),
        antenna1=np.tile(a1u, ntime),
        antenna2=np.tile(a2u, ntime),
        feed1=np.zeros(nrow, np.int32),
        feed2=np.zeros(nrow, np.int32),
        radec=rng.uniform(-0.01, 0.01, (nsrc, 2)) + np.array([0.8, -0.7]),
        phase_dir=np.array([0.8, -0.7]),
        uvw=rng.uniform(-1000, 1000, (nrow, 3)),
        chan_freq=np.linspace(0.856e9, 1.712e9, nchan),
        model_flux=rng.uniform(0.1, 1.0, (nsrc, nchan, 4)),
    )


def custom_rime(ds, device="cuda"):
    """(row, chan, 4) complex visibilities of :data:`SPEC` with
    :class:`ModelFlux` as its C term, on ``device``."""
    spec = RimeSpecification(SPEC, terms={"C": ModelFlux})
    return rime(spec, ds, device=plan_device(device))


def explicit(ds, device="cuda"):
    """The same visibilities as Σ_s K_s · flux_s, with
    :func:`~africanus_tpu_torch.rime.phase_delay`."""
    device = plan_device(device)

    def t(x):
        return torch.as_tensor(x, device=device)

    lm = radec_to_lm(t(ds["radec"]), t(ds["phase_dir"]))
    k = phase_delay(lm, t(ds["uvw"]), t(ds["chan_freq"]))  # (src, row, chan)
    return (k[..., None] * t(ds["model_flux"])[:, None]).sum(dim=0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    ds = dataset()
    before = counts()
    vis = custom_rime(ds, args.device)
    print(f"device: {device_name(vis.device)} ({vis.real.dtype}); "
          f"{describe(since(before))}")
    print(f"custom-term vis: {tuple(vis.shape)}, |vis| max "
          f"{float(vis.abs().max()):.4f}")
    expected = explicit(ds, args.device)
    err = float((vis - expected).abs().max() / expected.abs().max())
    print(f"max rel err vs explicit composition: {err:.2e}")
    if not err < 1e-6:
        raise SystemExit(f"the custom term is {err:.2e} from the explicit sum")


if __name__ == "__main__":
    main()
