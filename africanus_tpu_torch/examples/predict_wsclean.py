"""Predict visibilities from a WSClean component list.

Port of ``examples/predict_wsclean.py`` (the reference's
``africanus/rime/examples/predict.py`` CLI): a WSClean component file is
loaded and predicted with
:func:`africanus_tpu_torch.rime.wsclean_predict` onto a synthetic
KAT-7-like observation (no Measurement Set here).

    python -m africanus_tpu_torch.examples.predict_wsclean [components.txt]
        [--device cuda|cpu]

Without a file it writes the three-component demo list into a temporary
directory. It runs in float32, as the JAX example does: one
``predict_kb`` launch on the card.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from africanus_tpu_torch.coordinates import radec_to_lm
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.examples.predict_to_ms_store import DEMO_MODEL
from africanus_tpu_torch.model.wsclean import load
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.rime.wsclean_predict import wsclean_predict

__all__ = ["DEMO_MODEL", "sky_model", "observation", "predict_wsclean", "main"]


def sky_model(model_file):
    """The JAX example's arrays of a component list: its names, and a
    dict of ``radec``, ``source_type``, ``flux``, ``coeffs``,
    ``log_poly``, ``ref_freq`` and ``gauss_shape`` (float64)."""
    sources = dict(load(str(model_file)))
    nsrc = len(sources["Name"])
    coeffs = np.zeros((nsrc, max(max(len(c) for c in sources["SpectralIndex"]), 1)))
    for i, c in enumerate(sources["SpectralIndex"]):
        coeffs[i, :len(c)] = c
    return sources["Name"], dict(
        radec=np.stack([sources["Ra"], sources["Dec"]], axis=1),
        source_type=np.array(sources["Type"]),
        flux=np.array(sources["I"], np.float64),
        coeffs=coeffs,
        log_poly=np.array(sources["LogarithmicSI"]),
        ref_freq=np.array(sources["ReferenceFrequency"], np.float64),
        gauss_shape=np.stack([sources["MajorAxis"], sources["MinorAxis"],
                              sources["Orientation"]], axis=1).astype(np.float64),
    )


def observation(nant=7, ntime=10, nchan=64, seed=0):
    """The JAX example's synthetic KAT-7-like (uvw, freq), float64."""
    rng = np.random.default_rng(seed)
    nrow = nant * (nant - 1) // 2 * ntime
    return (rng.uniform(-1000, 1000, (nrow, 3)),
            np.linspace(0.856e9, 1.712e9, nchan))


def predict_wsclean(sky, uvw, freq, device="cuda", dtype=torch.float32):
    """(row, chan, 1) complex visibilities of ``sky`` (from
    :func:`sky_model`), projected about its mean direction, on
    ``device`` in ``dtype`` (float32: ``predict_kb``)."""
    device = plan_device(device)

    def t(x):
        return torch.as_tensor(x, device=device).to(dtype)

    radec = torch.as_tensor(sky["radec"])
    lm = radec_to_lm(radec, radec.mean(dim=0))
    return wsclean_predict(t(uvw), t(lm), sky["source_type"], t(sky["flux"]),
                           t(sky["coeffs"]),
                           torch.as_tensor(sky["log_poly"], device=device),
                           t(sky["ref_freq"]), t(sky["gauss_shape"]), t(freq))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", nargs="?")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        model_file = args.model
        if model_file is None:
            model_file = Path(tmp) / "demo_components.txt"
            model_file.write_text(DEMO_MODEL)
            print(f"wrote demo component list to {model_file}")
        names, sky = sky_model(model_file)
    print(f"loaded {len(names)} components: {names}")

    uvw, freq = observation()
    before = counts()
    t0 = time.perf_counter()
    vis = predict_wsclean(sky, uvw, freq, device)
    sync(device)
    dt = time.perf_counter() - t0
    vis = vis.cpu().numpy()
    print(f"device: {device_name(device)} (float32); {describe(since(before))}")
    print(f"predicted vis: {vis.shape} in {dt:.2f}s")
    print(f"|vis| range: [{np.abs(vis).min():.4f}, {np.abs(vis).max():.4f}]")


if __name__ == "__main__":
    main()
