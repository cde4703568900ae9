"""Predict visibilities from a FITS model image with the DFT.

Port of ``examples/predict_from_fits.py`` (the reference's
``africanus/dft/examples/predict_from_fits.py``): read a FITS image, take
its non-zero pixels as point components with lm offsets from the cell
size, and DFT-predict them (:func:`africanus_tpu_torch.dft.im_to_vis`)
in row chunks through :func:`africanus_tpu_torch.parallel.stream_rows`.
The observation is synthetic; a demo model is written if none is given.

    python -m africanus_tpu_torch.examples.predict_from_fits [model.fits]
        [--device cuda|cpu]

Float32 at 16 channels, as the JAX example: one ``dft_forward`` launch a
chunk on the card.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from africanus_tpu_torch.dft import im_to_vis
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.parallel import stream_rows
from africanus_tpu_torch.utils.fits import read_fits, write_fits

__all__ = ["NX", "CELL_DEG", "write_demo_model", "fits_components",
           "observation", "predict_from_fits", "main"]

NX = 64
CELL_DEG = 2.0 / 3600.0  # 2 arcsec cells


def write_demo_model(path, rng):
    """The JAX example's demo model: five point sources drawn from
    ``rng`` on a 64² image of 2″ cells about (60°, −50°)."""
    img = np.zeros((NX, NX), np.float32)
    for _ in range(5):
        img[rng.integers(8, NX - 8), rng.integers(8, NX - 8)] = rng.uniform(0.5, 2.0)
    write_fits(path, img, [
        ("CTYPE1", "RA---SIN"), ("CDELT1", -CELL_DEG),
        ("CRPIX1", NX // 2 + 1.0), ("CRVAL1", 60.0),
        ("CTYPE2", "DEC--SIN"), ("CDELT2", CELL_DEG),
        ("CRPIX2", NX // 2 + 1.0), ("CRVAL2", -50.0),
    ])


def fits_components(model_file):
    """(flux (ncomp,), lm (ncomp, 2)) float32 of the image's non-zero
    pixels, offsets from the centre in cells of |CDELT2|."""
    header, image = read_fits(model_file)
    nx, ny = image.shape
    cell_rad = np.deg2rad(abs(float(header.get("CDELT2", CELL_DEG))))
    ix, iy = np.nonzero(image)
    flux = image[ix, iy].astype(np.float32)
    lm = np.stack([(ix - nx // 2) * cell_rad, (iy - ny // 2) * cell_rad],
                  axis=1).astype(np.float32)
    return flux, lm


def observation(rng, nrow=5000, nchan=16):
    """The JAX example's synthetic (uvw, freq), float32, drawn from
    ``rng`` after the demo model's draws."""
    freq = np.linspace(0.856e9, 1.712e9, nchan).astype(np.float32)
    uvw = rng.uniform(-2000, 2000, (nrow, 3)).astype(np.float32)
    return uvw, freq


def predict_from_fits(flux, lm, uvw, freq, chunk=2048, device="cuda"):
    """(row, chan, 1) complex64 host visibilities of the components, the
    rows streamed to ``device`` in chunks of ``chunk``."""
    device = plan_device(device)
    image = torch.as_tensor(flux, device=device)[:, None, None].expand(
        flux.size, freq.size, 1).contiguous()
    lm = torch.as_tensor(lm, device=device)

    def fn(tree, valid):
        return im_to_vis(image, tree["uvw"], lm, freq)

    return stream_rows(fn, {"uvw": uvw}, chunk=chunk, combine="concat",
                       device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("model", nargs="?")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        model_file = args.model
        if model_file is None:
            model_file = Path(tmp) / "demo_model.fits"
            write_demo_model(model_file, rng)
            print(f"wrote demo model to {model_file}")
        flux, lm = fits_components(model_file)
    print(f"model: {flux.size} components, total flux {flux.sum():.3f}")

    uvw, freq = observation(rng)
    before = counts()
    v = predict_from_fits(flux, lm, uvw, freq, device=device)
    print(f"device: {device_name(device)} (float32); {describe(since(before))}")
    print(f"predicted vis: {v.shape}")
    # a zero baseline would see the total flux: an amplitude bound
    if not np.abs(v).max() <= flux.sum() * (1 + 1e-4):
        raise SystemExit("|vis| exceeds the total flux")
    print(f"|vis| max {np.abs(v).max():.3f} <= total flux {flux.sum():.3f}")


if __name__ == "__main__":
    main()
