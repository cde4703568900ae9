"""End-to-end MS-shaped IO pipeline: read -> predict -> MODEL_DATA write.

Port of ``examples/predict_to_ms_store.py``, the analogue of the
reference's flagship example (``africanus/rime/examples/predict.py:
531-587``): it reads a Measurement Set, parses a sky model, predicts
model visibilities and writes MODEL_DATA back. The MS is an
:class:`africanus_tpu_torch.io.MSStore` — a directory of memory-mapped
``.npy`` columns with JSON subtables — and the sky model a WSClean
component list. :func:`predict_to_ms_store` streams row chunks of UVW
through :func:`africanus_tpu_torch.rime.wsclean_predict` (float32: one
``predict_kb`` launch per chunk on the card) and writes each chunk back
in place.

    python -m africanus_tpu_torch.examples.predict_to_ms_store [store_dir]
        [--model FILE] [--chunk ROWS] [--device cuda|cpu]

Without ``store_dir`` it fabricates a small store in a temporary
directory; without ``--model`` it writes the three-component demo list
into the store.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from africanus_tpu_torch.coordinates import radec_to_lm
from africanus_tpu_torch.examples.launches import device_name, sync
from africanus_tpu_torch.io import MSStore
from africanus_tpu_torch.model.wsclean import load
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.ops.cuda_predict import predict_kb
from africanus_tpu_torch.rime.wsclean_predict import wsclean_predict

__all__ = ["DEMO_MODEL", "make_store", "random_component_list", "sky_arrays",
           "predict_to_ms_store", "StoreRun", "chunk_digest"]

DEMO_MODEL = """\
Format = Name, Type, Ra, Dec, I, SpectralIndex, LogarithmicSI, ReferenceFrequency='1.2e9', MajorAxis, MinorAxis, Orientation
s0,POINT,04:00:05.0,-50.30.00.0,1.2,[-0.7],false,1.2e9,,,
s1,GAUSSIAN,04:01:10.0,-50.28.30.0,0.8,[-0.5,0.05],true,1.2e9,60.0,30.0,45.0
s2,POINT,03:59:30.0,-50.31.00.0,0.4,[],false,,,,
"""
HEADER = ("Format = Name, Type, Ra, Dec, I, SpectralIndex, LogarithmicSI, "
          "ReferenceFrequency='1.2e9', MajorAxis, MinorAxis, Orientation")


def make_store(path, nant=16, ntime=12, nchan=64):
    """Fabricate an MS-shaped store for a synthetic observation (the JAX
    example's store, the same bytes)."""
    rng = np.random.default_rng(11)
    a1u, a2u = np.triu_indices(nant, 1)
    nbl = a1u.size
    nrow = nbl * ntime
    time_col = np.repeat(5.03e9 + np.arange(ntime) * 8.0, nbl)
    ant_pos = rng.uniform(-2000, 2000, (nant, 3))
    ant_pos[:, 2] *= 0.05
    uvw = ant_pos[np.tile(a1u, ntime)] - ant_pos[np.tile(a2u, ntime)]
    chan_freq = np.linspace(0.856e9, 1.712e9, nchan)
    data = np.zeros((nrow, nchan, 1), np.complex64)
    columns = dict(
        TIME=time_col,
        ANTENNA1=np.tile(a1u, ntime).astype(np.int32),
        ANTENNA2=np.tile(a2u, ntime).astype(np.int32),
        UVW=uvw,
        DATA=data,
        MODEL_DATA=np.zeros_like(data),
        FLAG=np.zeros(data.shape, bool),
    )
    subtables = dict(
        FIELD=dict(PHASE_DIR=[1.0472, -0.8813]),  # ~04h00, -50.5 deg
        SPECTRAL_WINDOW=dict(CHAN_FREQ=chan_freq),
        ANTENNA=dict(POSITION=ant_pos),
    )
    return MSStore.create(path, columns, subtables)


def _hms(ra):
    hours = (ra % (2 * math.pi)) / (2 * math.pi) * 24.0
    h = int(hours)
    m = int((hours - h) * 60.0)
    return f"{h:02d}:{m:02d}:{(hours - h) * 3600.0 - m * 60.0:09.6f}"


def _dms(dec):
    deg = abs(dec) * 180.0 / math.pi
    d = int(deg)
    m = int((deg - d) * 60.0)
    sign = "-" if dec < 0 else "+"
    return f"{sign}{d:02d}.{m:02d}.{(deg - d) * 3600.0 - m * 60.0:09.6f}"


def random_component_list(nsrc, phase_dir, seed=0):
    """A WSClean component list (text) of ``nsrc`` components drawn from
    ``seed``, as a MeerKAT L-band field's ``-save-source-list`` holds:
    uniform in a disc of 1° about ``phase_dir`` (ra, dec rad), 30%
    GAUSSIAN (major axis 2-60″, minor axis up to the major, any
    orientation), the rest POINT; fluxes log-uniform in 1 mJy-1 Jy;
    ordinary or logarithmic spectra with 1-3 coefficients about 1.284
    GHz."""
    rng = np.random.default_rng(seed)
    ra0, dec0 = phase_dir
    ref_freq = 1.284e9
    r = np.deg2rad(1.0) * np.sqrt(rng.uniform(size=nsrc))
    theta = rng.uniform(0, 2 * np.pi, nsrc)
    dec = dec0 + r * np.sin(theta)
    ra = ra0 + r * np.cos(theta) / np.cos(dec)
    flux = 10.0 ** rng.uniform(-3, 0, nsrc)
    gauss = rng.uniform(size=nsrc) < 0.3
    log_si = rng.uniform(size=nsrc) < 0.5
    lines = [HEADER]
    for s in range(nsrc):
        ncoeff = int(rng.integers(1, 4))
        if log_si[s]:
            coeffs = [rng.uniform(-1.2, -0.2)] + list(rng.normal(0, 0.05, ncoeff - 1))
        else:
            coeffs = list(flux[s] * rng.uniform(-1.0, 0.5, ncoeff))
        spi = "[" + ",".join(f"{c:.9g}" for c in coeffs) + "]"
        if gauss[s]:
            major = rng.uniform(2.0, 60.0)
            shape = (f"GAUSSIAN,{_hms(ra[s])},{_dms(dec[s])},{flux[s]:.9g},{spi},"
                     f"{str(bool(log_si[s])).lower()},{ref_freq:.9g},{major:.6f},"
                     f"{major * rng.uniform(0.2, 1.0):.6f},{rng.uniform(0, 180):.6f}")
        else:
            shape = (f"POINT,{_hms(ra[s])},{_dms(dec[s])},{flux[s]:.9g},{spi},"
                     f"{str(bool(log_si[s])).lower()},{ref_freq:.9g},,,")
        lines.append(f"c{s},{shape}")
    return "\n".join(lines) + "\n"


def sky_arrays(sources, phase_dir):
    """The float32 host arrays of :func:`wsclean_predict` (keyword
    arguments but ``uvw`` and ``frequency``) from a loaded component list
    (``dict(load(...))``), directions projected about ``phase_dir``."""
    nsrc = len(sources["Name"])
    radec = np.stack([sources["Ra"], sources["Dec"]], axis=1)
    lm = radec_to_lm(torch.as_tensor(radec), torch.as_tensor(np.asarray(phase_dir)))
    ncoeff = max(max(len(c) for c in sources["SpectralIndex"]), 1)
    coeffs = np.zeros((nsrc, ncoeff), np.float32)
    for i, c in enumerate(sources["SpectralIndex"]):
        coeffs[i, :len(c)] = c
    # load() has already converted MajorAxis/MinorAxis arcsec→radians and
    # Orientation deg→radians
    gauss_shape = np.stack([np.array([x or 0.0 for x in sources[k]])
                            for k in ("MajorAxis", "MinorAxis", "Orientation")],
                           axis=1).astype(np.float32)
    return dict(
        lm=lm.numpy().astype(np.float32),
        source_type=np.array(sources["Type"]),
        flux=np.array(sources["I"], np.float32),
        coeffs=coeffs,
        log_poly=np.array([bool(x) for x in sources["LogarithmicSI"]]),
        ref_freq=np.array([x if x else 1.2e9 for x in sources["ReferenceFrequency"]],
                          np.float32),
        gauss_shape=gauss_shape,
    )


def chunk_digest(values):
    """blake2b of a chunk's complex64 bytes: the bytes of its on-disk
    (re, im) float32 pairs (``MSStore.read_pair``)."""
    return hashlib.blake2b(np.ascontiguousarray(values).tobytes(),
                           digest_size=16).hexdigest()


class StoreRun(NamedTuple):
    """What :func:`predict_to_ms_store` wrote: the row slices of MODEL_DATA
    and the :func:`chunk_digest` of each, the visibilities written,
    the ``predict_kb`` launches, and per chunk the host-clock seconds
    of each stage (``read``, ``predict`` — to a synchronised device —,
    ``copy`` to the host, ``write``)."""

    slices: list
    digests: list
    nvis: int
    launches: int
    stage_seconds: list


def predict_to_ms_store(store_dir, model_file, chunk=8064, device="cuda"):
    """Predict MODEL_DATA of the store at ``store_dir`` from the WSClean
    component list ``model_file``, ``chunk`` rows at a time on
    ``device`` (the card by default; raises without one), in float32.
    Returns a :class:`StoreRun`."""
    device = plan_device(device)
    store = MSStore(store_dir)
    sources = dict(load(str(model_file)))
    sky = {k: (torch.as_tensor(v, device=device) if k != "source_type" else v)
           for k, v in sky_arrays(sources, store.subtables["FIELD"]["PHASE_DIR"]).items()}
    freq = torch.as_tensor(np.asarray(store.subtables["SPECTRAL_WINDOW"]["CHAN_FREQ"],
                                      np.float32), device=device)
    before = predict_kb.launches
    slices, digests, stages, nvis = [], [], [], 0
    for start in range(0, store.nrow, chunk):
        sl = slice(start, min(start + chunk, store.nrow))
        t0 = time.perf_counter()
        uvw = store.read("UVW", sl).astype(np.float32)
        t1 = time.perf_counter()
        vis = wsclean_predict(torch.as_tensor(uvw, device=device), frequency=freq, **sky)
        sync(device)
        t2 = time.perf_counter()
        host = vis.cpu().numpy()
        t3 = time.perf_counter()
        store.write("MODEL_DATA", host, sl)
        t4 = time.perf_counter()
        slices.append(sl)
        digests.append(chunk_digest(host))
        stages.append(dict(read=t1 - t0, predict=t2 - t1, copy=t3 - t2, write=t4 - t3))
        nvis += host.size
    return StoreRun(slices, digests, nvis, predict_kb.launches - before, stages)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("store_dir", nargs="?")
    parser.add_argument("--model", help="WSClean component list")
    parser.add_argument("--chunk", type=int, default=8064)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        store_dir = Path(args.store_dir or Path(tmp) / "store")
        if not (store_dir / "meta.json").exists():
            make_store(store_dir)
            print(f"fabricated synthetic MS store at {store_dir}")
        store = MSStore(store_dir)
        print(f"store: {store.nrow} rows, columns {store.columns()}")
        model_file = args.model
        if model_file is None:
            model_file = store_dir / "sky_model.txt"
            model_file.write_text(DEMO_MODEL)

        t0 = time.perf_counter()
        run = predict_to_ms_store(store_dir, model_file, args.chunk, args.device)
        dt = time.perf_counter() - t0
        device = plan_device(args.device)
        name = device_name(device)
        print(f"predicted + wrote {run.nvis / 1e6:.2f} Mvis of MODEL_DATA in "
              f"{len(run.slices)} chunks, {dt:.2f} s ({run.nvis / dt / 1e6:.1f} Mvis/s "
              f"incl. IO) on {name}; predict_kb launches {run.launches}")

        # the round trip through a fresh handle
        reopened = MSStore(store_dir)
        same = all(chunk_digest(reopened.read_pair("MODEL_DATA", sl)) == d
                   for sl, d in zip(run.slices, run.digests))
        print(f"round trip through a fresh handle bitwise equal: {same}")
        if not same:
            raise SystemExit("MODEL_DATA differs from what was predicted")


if __name__ == "__main__":
    main()
