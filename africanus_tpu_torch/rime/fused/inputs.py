"""Seeded inputs of the fused RIME at the flagship's MeerKAT-64 chunk.

:func:`fused_inputs` draws the flagship's sky and rows
(:func:`~africanus_tpu_torch.rime.flagship.flagship_inputs`) as
arguments of :func:`~africanus_tpu_torch.rime.fused.rime` — MJD-second
times 8 s apart, gaussian sources with a spectral index — and, for an E
term, config 3's beam cube (:func:`~africanus_tpu_torch.rime.beam_chain.beam_inputs`)
with seeded beam parallactic angles; :func:`from_numpy` carries them over
to tensors on a device; :func:`fused_oracle_f64` is the float64 numpy
oracle of the ``(Kpq, Gpq, Bpq)`` chain on a window of rows and channels.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.rime.beam_chain import beam_inputs
from africanus_tpu_torch.rime.flagship import flagship_inputs, predict_oracle_f64

__all__ = ["fused_inputs", "from_numpy", "fused_oracle_f64"]

# the columns the state builder reads on the host
_HOST_ARGS = ("time", "antenna1", "antenna2", "feed1", "feed2")


def fused_inputs(nsrc=100, ntime=4, nant=64, nchan=4096, seed=2026,
                 beam_seed=None):
    """Numpy keyword arguments of ``rime``: the flagship draws of
    ``flagship_inputs(nsrc, ntime, nant, nchan, seed)`` (rows time-major,
    time = 5.03e9 + 8 s × index, float32 sky and uvw), and with
    ``beam_seed`` the beam cube of ``beam_inputs(nant, nchan, beam_seed)``
    (129² × 8 × 4 complex128) and (ntime, nant) beam parallactic angles
    uniform in ±π from ``beam_seed``."""
    (time_index, antenna1, antenna2, lm, uvw, frequency, stokes, spi,
     ref_freq, gauss_shape, _) = flagship_inputs(nsrc, ntime, nant, nchan, seed)
    nrow = time_index.size
    args = dict(time=5.03e9 + 8.0 * time_index, antenna1=antenna1,
                antenna2=antenna2, feed1=np.zeros(nrow, np.int32),
                feed2=np.zeros(nrow, np.int32), lm=lm, uvw=uvw,
                chan_freq=frequency, stokes=stokes, spi=spi, ref_freq=ref_freq,
                gauss_shape=gauss_shape, spi_base="standard")
    if beam_seed is not None:
        cube = beam_inputs(nant, nchan, seed=beam_seed)
        rng = np.random.default_rng(beam_seed)
        args.update(beam=cube["beam"], beam_lm_extents=cube["extents"],
                    beam_freq_map=cube["fmap"],
                    beam_parangle=rng.uniform(-np.pi, np.pi, (ntime, nant)))
    return args


def from_numpy(args, device):
    """Carry :func:`fused_inputs` over to the port: the host columns stay
    numpy, every other array becomes a tensor on ``device`` — floats as
    float32, the beam as complex64 — so that ``rime(spec, **out)``
    evaluates on ``device``."""
    out = {}
    for k, v in args.items():
        if k in _HOST_ARGS or not isinstance(v, np.ndarray):
            out[k] = v
        elif np.iscomplexobj(v):
            out[k] = torch.as_tensor(v.astype(np.complex64), device=device)
        else:
            out[k] = torch.as_tensor(v.astype(np.float32), device=device)
    return out


def fused_oracle_f64(args, rows, chans):
    """Float64 numpy oracle of ``(Kpq, Gpq, Bpq): [I,Q,U,V] ->
    [XX,XY,YX,YY]`` on rows ``rows`` and channels ``chans`` of
    :func:`fused_inputs`: the flagship oracle with unit gains. Returns
    (rows, chans, 4) complex128."""
    freq = np.asarray(args["chan_freq"])[chans]
    nrow = np.asarray(args["uvw"])[rows].shape[0]
    zero = np.zeros((1, 1, freq.shape[0], 4))
    idx = np.zeros(nrow, np.int64)
    return predict_oracle_f64(idx, idx, idx, args["lm"], np.asarray(args["uvw"])[rows],
                              freq, args["stokes"], args["spi"], args["ref_freq"],
                              args["gauss_shape"], zero)
