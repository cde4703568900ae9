"""DFT predict example (BASELINE config 1: a KAT-7-style point-source
predict).

Port of ``examples/predict_dft.py`` (the reference's
``africanus/dft/examples/predict.py`` with the Measurement Set replaced
by a synthetic observation): a sky model of point sources with power-law
spectra is projected, converted to XX/YY and predicted with
:func:`africanus_tpu_torch.dft.im_to_vis`, then timed.

    python -m africanus_tpu_torch.examples.predict_dft [--nsrc 100]
        [--nant 7] [--nchan 64] [--ntime 10] [--device cuda|cpu]

It runs in float32, as the JAX example does: below 128 channels that is
the ``dft_forward`` kernel on the card, from 128 channels ``predict_kb``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from africanus_tpu_torch.coordinates import radec_to_lm
from africanus_tpu_torch.dft import im_to_vis
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.model.coherency import convert
from africanus_tpu_torch.model.spectral import spectral_model
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["PHASE_CENTRE", "dft_inputs", "predict_dft", "main"]

PHASE_CENTRE = np.array([0.5, -0.6], np.float32)


def dft_inputs(nsrc=100, nant=7, nchan=64, ntime=10, seed=42):
    """The JAX example's float32 draws: dict of ``radec`` (nsrc, 2),
    ``uvw`` (nant·(nant−1)/2·ntime, 3), ``freq`` (nchan,), ``stokes``
    (nsrc, 1), ``spi`` (nsrc, 1, 1) and ``ref_freq`` (nsrc,)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    nrow = nant * (nant - 1) // 2 * ntime
    radec = (PHASE_CENTRE + rng.uniform(-0.02, 0.02, (nsrc, 2))).astype(f32)
    uvw = rng.uniform(-1000.0, 1000.0, (nrow, 3)).astype(f32)
    freq = np.linspace(0.856e9, 1.712e9, nchan).astype(f32)
    stokes = rng.uniform(0.1, 1.0, (nsrc, 1)).astype(f32)
    spi = rng.normal(scale=0.2, size=(nsrc, 1, 1)).astype(f32)
    ref_freq = np.full(nsrc, 1.2e9, f32)
    return dict(radec=radec, uvw=uvw, freq=freq, stokes=stokes, spi=spi,
                ref_freq=ref_freq)


def predict_dft(radec, uvw, freq, stokes, spi, ref_freq, device="cuda"):
    """(row, chan, 2) complex64 XX/YY visibilities of the point sources at
    ``radec`` (projected about :data:`PHASE_CENTRE`) with Stokes I
    spectra ``stokes`` · (ν/ν₀)^spi, predicted on ``device``.

    The projection is float64, rounded to float32 once: sources ~0.5 rad
    from the origin lose ~6e-8 of m to cancellation in a float32
    projection, ~1e-3 rad of phase at 1 km and 1.7 GHz, and the card's and
    the CPU's float32 sines round differently (the JAX example projects in
    float32 and carries that error; here the float32 work is the DFT's)."""
    device = plan_device(device)

    def t(x):
        return torch.as_tensor(x, device=device)

    f64 = torch.float64
    lm = radec_to_lm(t(radec).to(f64), t(PHASE_CENTRE).to(f64)).float()
    flux = spectral_model(t(stokes), t(spi), t(ref_freq), t(freq), base="std")
    corr = convert(flux, ["I"], ["XX", "YY"], implicit_stokes=True)
    # the frequencies stay on the host: the DFT plan reads them there
    return im_to_vis(corr, t(uvw), lm, freq)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nsrc", type=int, default=100)
    p.add_argument("--nant", type=int, default=7)
    p.add_argument("--nchan", type=int, default=64)
    p.add_argument("--ntime", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    inputs = dft_inputs(args.nsrc, args.nant, args.nchan, args.ntime)
    before = counts()
    out = predict_dft(**inputs, device=device)
    sync(device)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = predict_dft(**inputs, device=device)
    sync(device)
    dt = (time.perf_counter() - t0) / reps

    vis = out.cpu().numpy()
    nvis = vis.shape[0] * args.nchan * 2
    print(f"device: {device_name(device)} (float32); {describe(since(before))} "
          f"in {reps + 1} calls")
    print(f"predicted vis: {vis.shape} {vis.dtype}")
    print(f"throughput: {nvis / dt / 1e6:.1f} Mvis/s ({dt*1e3:.2f} ms/call)")
    print(f"sample: vis[0, 0] = {vis[0, 0]}")


if __name__ == "__main__":
    main()
