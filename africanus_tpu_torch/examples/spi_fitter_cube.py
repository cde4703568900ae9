"""Image-cube spectral-index fitter CLI.

Port of ``examples/spi_fitter_cube.py`` (the reference's
simple_spi_fitter.py): restore a FITS model cube with the clean beam,
threshold components against the residual rms (or a dynamic-range
limit), fit per-pixel power laws I(ν) = I₀·(ν/ν₀)^α with
:func:`africanus_tpu_torch.model.spi.fit_spi_components`, and write α /
α-error / I₀ / I₀-error maps and the reconstructed cube as FITS.

    python -m africanus_tpu_torch.examples.spi_fitter_cube --fitsmodel model.fits
        [--fitsresidual resid.fits] [--beampars EMAJ EMIN PA(deg)]
        [--threshold 5] [--maxDR 100] [--outfile prefix]
        [--output aeIkc] [--padding-frac 0.2] [--beammodel schema.fits]
        [--device cuda|cpu]

The restore is a per-band FFT convolution with ``torch.fft``; the cube,
the mask and the fit stay on the device, in float64 as the JAX example.
An optional primary-beam cube (``utils/beams`` schema, complex64 as the
JAX example loads it) divides the components before fitting: it is
interpolated with :func:`africanus_tpu_torch.rime.beam_cube_dde`, which
on the card launches ``beam_interp`` and, when every component's
frequencies lie inside the cube (the channel-invariant route),
``beam_blend``.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.model.spi import fit_spi_components
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.rime import beam_cube_dde
from africanus_tpu_torch.utils.beams import load_beam_cube
from africanus_tpu_torch.utils.fits import read_fits, write_fits

__all__ = ["parse_cube_header", "restoring_beam", "fft_convolve_cube",
           "evaluate_primary_beam", "CubeFit", "fit_cube", "main"]

# CASA linear correlation ids XX/XY/YX/YY: a real beam schema ships one
# re/im FITS pair per correlation
LINEAR_CORRS = (9, 10, 11, 12)
PRODUCTS = dict(a="alpha", e="alpha_err", I="I0", k="I0_err")


def parse_cube_header(hdr):
    """(l_coord, m_coord, freqs, ref_freq, freq_axis) from a FITS image
    cube header with FREQ on axis 3 or 4 and degree sky units."""
    for ax in (1, 2):
        unit = str(hdr.get(f"CUNIT{ax}", "deg")).strip().lower()
        if unit != "deg":
            raise ValueError(f"CUNIT{ax} must be degrees, got {unit!r}")

    def axis_coords(ax):
        n = hdr[f"NAXIS{ax}"]
        refpix = hdr.get(f"CRPIX{ax}", 1.0)
        delta = hdr.get(f"CDELT{ax}", 1.0)
        return (np.arange(1, n + 1) - refpix) * delta

    freq_axis = None
    for ax in (3, 4):
        if str(hdr.get(f"CTYPE{ax}", "")).strip().upper().startswith("FREQ"):
            freq_axis = ax
            break
    if freq_axis is None:
        raise ValueError("FREQ must be on axis 3 or 4")
    ref_freq = hdr.get(f"CRVAL{freq_axis}")
    return (axis_coords(1), axis_coords(2), ref_freq + axis_coords(freq_axis),
            ref_freq, freq_axis)


def restoring_beam(l_coord, m_coord, emaj, emin, pa_deg, device):
    """Peak-normalised elliptical Gaussian (FWHM major/minor in degrees,
    position angle in degrees) sampled on the image grid, float64 on
    ``device``."""
    fwhm2sig = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    sx = max(emaj, emin) * fwhm2sig
    sy = min(emaj, emin) * fwhm2sig
    th = np.deg2rad(90.0 + pa_deg)
    ll = torch.as_tensor(l_coord, device=device)[:, None]
    mm = torch.as_tensor(m_coord, device=device)[None, :]
    u = ll * np.cos(th) + mm * np.sin(th)
    v = -ll * np.sin(th) + mm * np.cos(th)
    return torch.exp(-0.5 * ((u / sx) ** 2 + (v / sy) ** 2))


def fft_convolve_cube(cube, kern, padding_frac):
    """Per-band 2D FFT convolution of the (band, l, m) ``cube`` with the
    (l, m) kernel ``kern``, zero-padded by ``padding_frac`` to powers of
    two, with the kernel centred on the image centre."""
    nband, nl, nm = cube.shape
    pad_l = int(np.ceil(padding_frac * nl / 2))
    pad_m = int(np.ceil(padding_frac * nm / 2))
    nfl = int(2 ** np.ceil(np.log2(nl + 2 * pad_l)))
    nfm = int(2 ** np.ceil(np.log2(nm + 2 * pad_m)))
    kf = torch.fft.fft2(kern, s=(nfl, nfm))
    out = torch.empty_like(cube)
    for b in range(nband):
        full = torch.fft.ifft2(torch.fft.fft2(cube[b], s=(nfl, nfm)) * kf).real
        # roll the kernel's centre offset out and crop the padding (the
        # pad absorbs the beam tails)
        out[b] = torch.roll(full, (-(nl // 2), -(nm // 2)), dims=(0, 1))[:nl, :nm]
    return out


def evaluate_primary_beam(schema, maskindices, l_coord, m_coord, freqs, device,
                          operands=None):
    """(comps, chan) primary-beam amplitude at the components' positions,
    the mean over the four correlations of |E| from the beam cube. A dict
    passed as ``operands`` receives the beam kernels' operands (see
    :func:`~africanus_tpu_torch.rime.beam_cube_dde`)."""
    beam, extents, freq_map = load_beam_cube(schema, LINEAR_CORRS)
    l_sel = torch.as_tensor(l_coord, device=device)[maskindices[:, 0]]
    m_sel = torch.as_tensor(m_coord, device=device)[maskindices[:, 1]]
    lm = torch.deg2rad(torch.stack([l_sel, m_sel], dim=1))
    nfreq = freqs.size
    out = beam_cube_dde(
        torch.as_tensor(beam.astype(np.complex64), device=device), extents,
        freq_map, lm,
        np.zeros((1, 1)),                # parallactic angles
        np.zeros((1, 1, nfreq, 2)),      # pointing errors
        np.ones((1, nfreq, 2)),          # antenna scaling
        freqs, operands=operands)
    # (src, time=1, ant=1, chan, corr) -> mean over the correlations
    return out.abs().reshape(lm.shape[0], nfreq, -1).mean(dim=-1)


class CubeFit(NamedTuple):
    """What :func:`fit_cube` made: the (l, m) product maps by letter
    (``a``, ``e``, ``I``, ``k``; float64 tensors), the (comps, 2) mask
    indices, the threshold, the files written, and the host-clock seconds
    of each stage (``read``, ``restore``, ``mask``, ``beam``, ``fit``,
    ``write``; each ends on an idle device)."""

    maps: dict
    maskindices: torch.Tensor
    threshold: float
    written: list
    stage_seconds: dict


def _cube(data, nband, npm, npl, device):
    # read_fits returns C order with NAXIS1 (l) as the LAST axis, i.e.
    # (nband, m, l): reorder to the (band, l, m) layout of the restoring
    # beam, the mask and the fitter
    return torch.as_tensor(np.asarray(data, np.float64).reshape(nband, npm, npl),
                           device=device).transpose(1, 2)


def fit_cube(fitsmodel, fitsresidual=None, outfile=None, beampars=None,
             threshold=5.0, maxDR=100.0, beammodel=None, output="aeIkc",  # noqa: N803
             padding_frac=0.2, device="cuda"):
    """The CLI's pipeline (its flags as arguments) on ``device``. Writes
    the products named in ``output`` and returns a :class:`CubeFit`."""
    device = plan_device(device)
    stages = {}
    t0 = time.perf_counter()
    mhdr, mdata = read_fits(fitsmodel)
    l_coord, m_coord, freqs, ref_freq, freq_axis = parse_cube_header(mhdr)
    nband, npl, npm = freqs.size, l_coord.size, m_coord.size
    model = _cube(mdata, nband, npm, npl, device)
    del mdata
    resid = None
    if fitsresidual:
        resid = _cube(read_fits(fitsresidual)[1], nband, npm, npl, device)
    print(f"cube {tuple(model.shape)}, ref_freq {ref_freq:.3e} Hz")
    sync(device)
    stages["read"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if beampars is None:
        beampars = (mhdr["BMAJ"], mhdr["BMIN"], mhdr.get("BPA", 0.0))
        print("restoring beam from header cards")
    else:
        beampars = tuple(beampars)
    print("emaj %.3e deg, emin %.3e deg, pa %.1f deg" % beampars)
    kern = restoring_beam(l_coord, m_coord, *beampars, device)
    model = fft_convolve_cube(model, kern, padding_frac)
    sync(device)
    stages["restore"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if resid is not None:
        rms = float(resid.std(correction=0))
        rms_cube = resid.reshape(nband, -1).std(dim=1, correction=0)
        factor, threshold = threshold, threshold * rms
        weights = torch.where(rms_cube > 0, 1.0 / rms_cube**2, 0.0)
        weights = weights / weights.max()
        print(f"threshold {threshold:.4e} Jy ({factor} x rms)")
        del resid
    else:
        threshold = float(model.max()) / maxDR
        weights = torch.ones(nband, dtype=torch.float64, device=device)
        print(f"threshold {threshold:.4e} Jy (maxDR {maxDR})")
    maskindices = torch.nonzero(model.amin(dim=0) > threshold)
    if maskindices.shape[0] == 0:
        raise SystemExit("no components above threshold — lower it "
                         f"(convolved max {float(model.max()):.3e} Jy)")
    fitcube = model[:, maskindices[:, 0], maskindices[:, 1]].T.contiguous()
    del model
    print(f"fitting {fitcube.shape[0]} components over {nband} bands")
    sync(device)
    stages["mask"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    beam_amp = None
    if beammodel:
        beam_amp = evaluate_primary_beam(beammodel, maskindices, l_coord, m_coord,
                                         freqs, device).to(torch.float64)
    sync(device)
    stages["beam"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fit = fit_spi_components(fitcube, weights,
                             torch.as_tensor(freqs, device=device), float(ref_freq),
                             beam=beam_amp)
    alpha, alpha_var, i0, i0_var = fit
    maps = {}
    for letter, vals in (("a", alpha), ("e", torch.sqrt(alpha_var)),
                         ("I", i0), ("k", torch.sqrt(i0_var))):
        img = torch.zeros((npl, npm), dtype=torch.float64, device=device)
        img[maskindices[:, 0], maskindices[:, 1]] = vals
        maps[letter] = img
    sync(device)
    stages["fit"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if outfile:
        prefix = outfile
    else:
        prefix = fitsmodel[:-5] if str(fitsmodel).endswith(".fits") else str(fitsmodel)
        prefix += "-"
    cards = [(k, v) for k, v in mhdr.items()
             if isinstance(v, (int, float, str, bool))
             and not (k in ("SIMPLE", "BITPIX", "NAXIS", "END")
                      or (k.startswith("NAXIS") and k[5:].isdigit()))]
    written = []
    for letter, name in PRODUCTS.items():
        if letter in output:
            # write_fits is NAXIS1-fastest: l must be the LAST axis
            path = f"{prefix}{name}.fits"
            write_fits(path, maps[letter].T.cpu().numpy(), cards)
            written.append(path)
            print(f"wrote {path}")
    if "c" in output:
        freq_ratio = torch.as_tensor(freqs / ref_freq, device=device)[:, None, None]
        i_map, a_map = maps["I"][None], maps["a"][None]
        rec = i_map * freq_ratio ** torch.where(i_map != 0, a_map, 0.0)
        rec = rec.transpose(1, 2)  # (band, m, l): l NAXIS1-fastest
        shape = (1, nband, npm, npl) if freq_axis == 3 else (nband, 1, npm, npl)
        path = f"{prefix}Irec_cube.fits"
        write_fits(path, rec.reshape(shape).cpu().numpy(), cards)
        written.append(path)
        print(f"wrote {path}")
    stages["write"] = time.perf_counter() - t0
    return CubeFit(maps, maskindices, threshold, written, stages)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fitsmodel", required=True,
                   help="FITS model image cube (Stokes I)")
    p.add_argument("--fitsresidual",
                   help="FITS residual cube: sets the component threshold "
                        "from its rms and per-band fit weights")
    p.add_argument("--outfile", help="output prefix (default: model path "
                                     "with .fits stripped + '-')")
    p.add_argument("--beampars", nargs=3, type=float, metavar=("EMAJ", "EMIN", "PA"),
                   help="restoring beam FWHM maj/min [deg] and position "
                        "angle [deg]; default: BMAJ/BMIN/BPA header cards")
    p.add_argument("--threshold", type=float, default=5.0,
                   help="component cutoff in residual-rms units")
    p.add_argument("--maxDR", type=float, default=100.0,
                   help="dynamic-range cutoff when no residual is given")
    p.add_argument("--beammodel",
                   help="primary-beam cube schema (utils/beams) to divide "
                        "out before fitting")
    p.add_argument("--output", default="aeIkc",
                   help="products to write: a=alpha, e=alpha error, "
                        "I=I0, k=I0 error, c=reconstructed cube")
    p.add_argument("--padding-frac", type=float, default=0.2,
                   help="zero-padding fraction for the FFT convolution")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    before = counts()
    run = fit_cube(args.fitsmodel, args.fitsresidual, args.outfile, args.beampars,
                   args.threshold, args.maxDR, args.beammodel, args.output,
                   args.padding_frac, args.device)
    print(f"device: {device_name(run.maskindices.device)} (float64); "
          f"{describe(since(before))}; seconds " + ", ".join(
              f"{k} {v:.2f}" for k, v in run.stage_seconds.items()))


if __name__ == "__main__":
    main()
