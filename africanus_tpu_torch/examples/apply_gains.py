"""Apply gains to visibilities and undo them (corrupt → correct).

Port of ``examples/apply_gains.py`` (the reference's
``calibration/utils/examples/apply_gains_to_ms.py`` and
``apply_gains_time_varying_sources.py``): time-varying DIAG_DIAG gains
corrupt a model predicted from moving sources
(:func:`~africanus_tpu_torch.calibration.compute_and_corrupt_vis`), then
:func:`~africanus_tpu_torch.calibration.correct_vis` recovers the model.
The observation and gain tables are synthetic.

    python -m africanus_tpu_torch.examples.apply_gains [--device cuda|cpu]

Float32 (complex64), as the JAX example. Both steps are torch operations:
no kernel of the port's own runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from africanus_tpu_torch.calibration import (
    chunkify_rows, compute_and_corrupt_vis, correct_vis,
)
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["gain_inputs", "apply_and_undo", "main"]


def gain_inputs(ntime=8, nant=7, nchan=32, ndir=1, seed=0):
    """The JAX example's float32 draws from ``default_rng(seed)``: a dict
    of the time bins, antennas, uvw, frequencies, per-time source
    positions ``lm``, model coherencies and gain ``phases``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    a1u, a2u = np.triu_indices(nant, 1)
    nbl = a1u.size
    time = np.repeat(np.arange(ntime, dtype=np.float64), nbl)
    _, tbi, tbc = chunkify_rows(time, 1)
    nrow = nbl * ntime
    uvw = rng.uniform(-1000, 1000, (nrow, 3)).astype(f32)
    freq = np.linspace(0.856e9, 1.712e9, nchan).astype(f32)
    lm = (rng.uniform(-1, 1, (ntime, ndir, 2)) * 1e-3).astype(f32)
    model = rng.uniform(0.5, 2.0, (ntime, nchan, ndir, 2)).astype(f32)
    phases = rng.uniform(-0.5, 0.5, (ntime, nant, nchan, ndir, 2)).astype(f32)
    return dict(tbi=tbi, tbc=tbc, antenna1=np.tile(a1u, ntime),
                antenna2=np.tile(a2u, ntime), uvw=uvw, freq=freq, lm=lm,
                model=model, phases=phases)


def apply_and_undo(tbi, tbc, antenna1, antenna2, uvw, freq, lm, model, phases,
                   device="cuda"):
    """(corrupted, corrected, uncorrupted) (row, chan, corr) complex64
    visibilities on ``device``: the model corrupted with the gains
    exp(i·phases), corrected with the same gains, and predicted with unit
    gains."""
    device = plan_device(device)

    def t(x):
        return torch.as_tensor(x, device=device)

    idx = [t(x) for x in (tbi, tbc, antenna1, antenna2)]
    jones = torch.polar(torch.ones(phases.shape, device=device), t(phases))
    model = t(model).to(torch.complex64)
    geometry = (t(uvw), t(freq), t(lm))
    vis = compute_and_corrupt_vis(*idx, jones, model, *geometry)
    flag = torch.zeros(vis.shape, dtype=torch.bool, device=device)
    fixed = correct_vis(*idx, jones, vis, flag)
    k = compute_and_corrupt_vis(*idx, torch.ones_like(jones), model, *geometry)
    return vis, fixed, k


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    before = counts()
    vis, fixed, k = apply_and_undo(**gain_inputs(), device=args.device)
    print(f"device: {device_name(vis.device)} (float32); {describe(since(before))}")
    print(f"corrupted vis: {tuple(vis.shape)}")
    # the corrected data equal the (phased) model sum over directions
    err = float((fixed - k).abs().max() / k.abs().max())
    print(f"max rel err corrected vs uncorrupted: {err:.2e}")
    if not err < 1e-5:
        raise SystemExit(f"correction left a relative error of {err:.2e}")


if __name__ == "__main__":
    main()
