"""The flagship RIME predict: K × gaussian envelope × B over sources, then
DIE gains G·V·Gᴴ.

Twin of ``__graft_entry__._predict_step_pallas`` (and of its XLA form
``_predict_step``): spectral model → Stokes→correlation conversion →
two-float geometric delay → envelope coordinates → the fused source
contraction (:func:`africanus_tpu_torch.ops.cuda_predict.predict_kb`,
the CUDA kernel on the card) → :func:`predict_vis` with diagonal 4-corr
DIE gains.

:class:`FlagshipPredict` holds the sky model as buffers and predicts one
row chunk per call, its stages in the profiler spans ``flagship.sky``,
``flagship.contract`` and ``flagship.gains`` under ``flagship.call``
(:mod:`africanus_tpu_torch.utils.profiling`); :func:`flagship_inputs`
makes the same seeded numpy inputs as ``__graft_entry__._flagship``;
:func:`from_numpy` turns such an input tuple into the module and its
tensors; :func:`predict_oracle_f64`
is the float64 numpy oracle of the same chain (the formula of the JAX
package's ``bench.py`` config 2).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.model.coherency.conversion import convert
from africanus_tpu_torch.model.shape.gaussian_shape import (
    GAUSS_SCALE, envelope_coordinates,
)
from africanus_tpu_torch.model.spectral.spec_model import spectral_model
from africanus_tpu_torch.ops.cuda_predict import predict_kb
from africanus_tpu_torch.rime.phase import phase_dot_cycles
from africanus_tpu_torch.rime.predict import predict_vis
from africanus_tpu_torch.utils.profiling import span

__all__ = ["FlagshipPredict", "flagship_inputs", "from_numpy",
           "predict_oracle_f64"]

_STOKES = ["I", "Q", "U", "V"]
_CORRS = ["XX", "XY", "YX", "YY"]


class FlagshipPredict(nn.Module):
    """Gaussian-source sky model that predicts 4-corr visibilities.

    Buffers (float32): ``lm`` (src, 2), ``stokes`` (src, 4) I/Q/U/V,
    ``spi`` (src, spi-comps, 4), ``ref_freq`` (src,), ``gauss_shape``
    (src, 3) (emajor, eminor, angle).
    """

    def __init__(self, lm, stokes, spi, ref_freq, gauss_shape):
        super().__init__()
        for name, x in (("lm", lm), ("stokes", stokes), ("spi", spi),
                        ("ref_freq", ref_freq), ("gauss_shape", gauss_shape)):
            self.register_buffer(name, torch.as_tensor(x, dtype=torch.float32))

    def kernel_operands(self, uvw, frequency):
        """The operands :meth:`forward` hands
        :func:`~africanus_tpu_torch.ops.cuda_predict.predict_kb`:
        ((delay hi, lo), u1, v1, frequency, sf, b)."""
        flux = spectral_model(self.stokes, self.spi, self.ref_freq,
                              frequency, base="std")
        b = convert(flux, _STOKES, _CORRS)  # (src, chan, 4) complex64

        # two-float signed delay (seconds); the kernel reduces delay·ν
        # mod one cycle, keeping f32 phases accurate at ~1e4 rad
        delay = phase_dot_cycles(self.lm, uvw)
        u1, v1 = envelope_coordinates(uvw, self.gauss_shape)
        sf = frequency * GAUSS_SCALE
        return delay, u1, v1, frequency, sf, b

    def forward(self, time_index, antenna1, antenna2, uvw, frequency,
                gain_phase):
        """Predict one row chunk.

        Parameters
        ----------
        time_index, antenna1, antenna2 : (row,) integer tensors
        uvw : (row, 3) float32, metres
        frequency : (chan,) float32, Hz
        gain_phase : (time, ant, chan, 4) float32 — diagonal DIE gain
            phases, indexed by ``time_index − min(time_index)``

        Returns
        -------
        (row, chan, 4) complex64 visibilities (XX, XY, YX, YY).
        """
        with span("flagship.call"):
            with span("flagship.sky"):
                operands = self.kernel_operands(uvw, frequency)
            with span("flagship.contract"):
                coh = predict_kb(*operands)
            with span("flagship.gains"):
                gains = torch.polar(torch.ones_like(gain_phase), gain_phase)
                return predict_vis(time_index, antenna1, antenna2,
                                   die1_jones=gains, base_vis=coh,
                                   die2_jones=gains)


def flagship_inputs(nsrc, ntime, nant, nchan, seed):
    """Seeded numpy inputs, equal to ``_flagship(..., default_rng(seed))``
    of the JAX package's ``__graft_entry__``: (time_index, antenna1,
    antenna2, lm, uvw, frequency, stokes, spi, ref_freq, gauss_shape,
    gain_phase)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    a1, a2 = np.triu_indices(nant, 1)
    antenna1 = np.tile(a1, ntime).astype(np.int32)
    antenna2 = np.tile(a2, ntime).astype(np.int32)
    time_index = np.repeat(np.arange(ntime, dtype=np.int32), a1.size)
    nrow = antenna1.size

    lm = rng.uniform(-0.01, 0.01, (nsrc, 2)).astype(f32)
    uvw = rng.uniform(-1000.0, 1000.0, (nrow, 3)).astype(f32)
    frequency = np.linspace(0.856e9, 1.712e9, nchan).astype(f32)
    stokes = rng.uniform(0.1, 1.0, (nsrc, 4)).astype(f32)
    spi = rng.normal(scale=0.2, size=(nsrc, 1, 4)).astype(f32)
    ref_freq = np.full(nsrc, 1.2e9, f32)
    gauss_shape = np.abs(rng.normal(size=(nsrc, 3))).astype(f32) * 1e-4
    gain_phase = rng.uniform(-0.1, 0.1, (ntime, nant, nchan, 4)).astype(f32)

    return (time_index, antenna1, antenna2, lm, uvw, frequency, stokes,
            spi, ref_freq, gauss_shape, gain_phase)


def from_numpy(args, device):
    """Carry the JAX package's flagship inputs over to the port.

    ``args`` is the ``_flagship`` / :func:`flagship_inputs` tuple of numpy
    arrays. Returns ``(model, inputs)``: the :class:`FlagshipPredict`
    holding the sky on ``device``, and the tuple (time_index, antenna1,
    antenna2, uvw, frequency, gain_phase) of tensors on ``device`` —
    indices as int64, floats as float32 — so that ``model(*inputs)``
    computes what ``_predict_step(*args)`` computes.
    """
    (time_index, antenna1, antenna2, lm, uvw, frequency, stokes, spi,
     ref_freq, gauss_shape, gain_phase) = args
    model = FlagshipPredict(lm, stokes, spi, ref_freq, gauss_shape).to(device)

    def idx(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    inputs = (idx(time_index), idx(antenna1), idx(antenna2), f32(uvw),
              f32(frequency), f32(gain_phase))
    return model, inputs


def predict_oracle_f64(time_index, antenna1, antenna2, lm, uvw, frequency,
                       stokes, spi, ref_freq, gauss_shape, gain_phase):
    """Float64 numpy oracle of the flagship predict (numpy in, numpy out).

    The plain formula — f64 phase, no two-float tricks — so it checks
    the whole chain independently of the code under test. ``time_index``
    indexes ``gain_phase`` directly (pass it normalised). Cost is
    O(src·row·chan): call it on a window of rows and channels.
    """
    f64 = np.float64
    lm, uvw, frequency, stokes, spi, ref_freq, gauss_shape, gain_phase = (
        np.asarray(x, f64) for x in (lm, uvw, frequency, stokes, spi,
                                     ref_freq, gauss_shape, gain_phase))
    ratio = frequency[None, :] / ref_freq[:, None]
    alpha = spi.sum(axis=1)
    flux = stokes[:, None, :] * ratio[:, :, None] ** alpha[:, None, :]
    i_, q_, u_, v_ = (flux[..., k] for k in range(4))
    b = np.stack([i_ + q_, u_ + 1j * v_, u_ - 1j * v_, i_ - q_], axis=-1)

    l, m = lm[:, 0], lm[:, 1]  # noqa: E741
    n = np.sqrt(np.maximum(1 - l * l - m * m, 0)) - 1
    dot = (l[:, None] * uvw[None, :, 0] + m[:, None] * uvw[None, :, 1]
           + n[:, None] * uvw[None, :, 2])
    phase = (-2 * np.pi / lightspeed) * dot[:, :, None] * frequency
    k = np.cos(phase) + 1j * np.sin(phase)

    fwhm = 2 * np.sqrt(2 * np.log(2))
    gscale = np.sqrt(2) * np.pi / (fwhm * lightspeed)
    emaj, emin, ang = gauss_shape[:, 0], gauss_shape[:, 1], gauss_shape[:, 2]
    el, em = emaj * np.sin(ang), emaj * np.cos(ang)
    er = emin / np.where(emaj == 0, 1, emaj)
    u1 = (uvw[None, :, 0] * em[:, None]
          - uvw[None, :, 1] * el[:, None]) * er[:, None]
    v1 = uvw[None, :, 0] * el[:, None] + uvw[None, :, 1] * em[:, None]
    sf = frequency * gscale
    env = np.exp(-((u1[:, :, None] * sf) ** 2 + (v1[:, :, None] * sf) ** 2))

    vis = np.einsum("srf,sfc->rfc", k * env, b)
    g = np.exp(1j * gain_phase)
    return g[time_index, antenna1] * vis * np.conj(g[time_index, antenna2])
