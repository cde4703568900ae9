"""Sharded RIME predict and DFT pipelines.

Port of ``africanus_tpu/parallel/predict.py`` — the reference's custom
dask layers (rime/dask_predict.py LinearReduction:64,
parallel_reduction:311) as per-shard calls over a :class:`~africanus_tpu_
torch.parallel.mesh.Mesh`: per-shard source sums stay local; the
cross-shard reduction of the adjoint DFT is a sum of the shard images in
shard order on the mesh's first device.

On the card each shard runs the port's kernels: ``dft_forward`` (or
``predict_kb`` at ≥ 128 channels) through :func:`~africanus_tpu_torch.
dft.im_to_vis`, ``dft_adjoint`` through :func:`~africanus_tpu_torch.dft.
vis_to_im`. Where the JAX package closes over a concrete ``frequency``
so that each shard's DFT tables are built at trace time, the port makes
a :func:`~africanus_tpu_torch.dft.kernels.dft_plan` for each shard's
device, with the delay bound measured once over every row, so that a
shard runs the plan the unsharded call would.
"""

from __future__ import annotations

import torch

from africanus_tpu_torch.dft.kernels import (
    _PREDICT_MIN_CHAN, dft_plan, im_to_vis, vis_to_im,
)
from africanus_tpu_torch.model.shape.gaussian_shape import gaussian
from africanus_tpu_torch.ops.cuda_dft import measured_delay_max
from africanus_tpu_torch.parallel.mesh import (
    as_tensor, check_rows, shard_slice, split,
)
from africanus_tpu_torch.rime.phase import phase_delay
from africanus_tpu_torch.utils.types import complex_dtype_for, real_dtype_for

__all__ = ["sharded_im_to_vis", "sharded_vis_to_im", "sharded_rime_predict"]

# sources a step of sharded_rime_predict's contraction: a shard holds a
# few (block, row, chan) planes, never the whole (src, row, chan) one
SOURCE_BLOCK = 8


def _fused_plans(mesh, devices, uvw, lm, frequency, ncorr, convention,
                 adjoint, f32):
    """{device: DftPlan} for the float32 fused DFT route (None where the
    call takes another route): one plan a device, the delay bound
    measured over every row on the mesh's first device."""
    if not f32 or (not adjoint and len(frequency) >= _PREDICT_MIN_CHAN):
        return None
    first = mesh.first
    lm32 = lm.to(first, torch.float32)
    delay_max = measured_delay_max(lm32, uvw.to(first, torch.float32))
    return {d: dft_plan(None, lm32.to(d), frequency, ncorr, convention,
                        adjoint, delay_max) for d in dict.fromkeys(devices)}


def sharded_im_to_vis(mesh, image, uvw, lm, frequency, convention="fourier"):
    """im_to_vis with rows sharded over the mesh "row" axis.

    The source contraction is local to each shard — zero communication.
    Returns the (row, chan, corr) complex visibilities on the mesh's
    first device.
    """
    devices = mesh.axis_devices("row")
    nshard = len(devices)
    image, uvw, lm = as_tensor(image), as_tensor(uvw), as_tensor(lm)
    check_rows(uvw.shape[0], nshard)
    freq = torch.as_tensor(frequency)
    f32 = complex_dtype_for(image, uvw, lm, freq) == torch.complex64
    plans = _fused_plans(mesh, devices, uvw, lm, frequency, image.shape[2],
                         convention, False, f32)
    parts = [
        im_to_vis(image.to(d), uvw_s, lm.to(d), frequency, convention,
                  plan=None if plans is None else plans[d])
        for d, uvw_s in zip(devices, split(uvw, nshard, devices.__getitem__))
    ]
    return torch.cat([p.to(mesh.first) for p in parts])


def sharded_vis_to_im(mesh, vis, uvw, lm, frequency, flags,
                      convention="fourier"):
    """vis_to_im with rows sharded: per-shard partial images summed in
    shard order on the mesh's first device — the reference's dask
    ``ims.sum(axis=0)`` row-chunk reduction (dft/dask.py:90)."""
    devices = mesh.axis_devices("row")
    nshard = len(devices)
    vis, uvw, lm = as_tensor(vis), as_tensor(uvw), as_tensor(lm)
    flags = as_tensor(flags)
    check_rows(uvw.shape[0], nshard)
    freq = torch.as_tensor(frequency)
    f32 = real_dtype_for(vis, uvw, lm, freq) == torch.float32
    plans = _fused_plans(mesh, devices, uvw, lm, frequency, vis.shape[2],
                         convention, True, f32)
    at = devices.__getitem__
    image = None
    for d, v_s, uvw_s, f_s in zip(devices, split(vis, nshard, at),
                                  split(uvw, nshard, at),
                                  split(flags, nshard, at)):
        part = vis_to_im(v_s, uvw_s, lm.to(d), frequency, f_s, convention,
                         plan=None if plans is None else plans[d])
        image = part.to(mesh.first) if image is None else image + part.to(
            mesh.first)
    return image


def _predict_shard(lm, uvw, freq, b, gauss_shape, convention):
    """K × envelope × B of one shard, ``SOURCE_BLOCK`` sources a step,
    the blocks' sums added in source order."""
    nsrc = lm.shape[0]
    out = None
    for s0 in range(0, max(nsrc, 1), SOURCE_BLOCK):
        blk = slice(s0, s0 + SOURCE_BLOCK)
        k = phase_delay(lm[blk], uvw, freq, convention)  # (src, row, chan)
        if gauss_shape is not None:
            k = k * gaussian(uvw, freq, gauss_shape[blk])
        part = torch.einsum("srf,sfc->rfc", k, b[blk].to(k.dtype))
        out = part if out is None else out + part
    return out


def sharded_rime_predict(mesh, lm, uvw, frequency, brightness,
                         gauss_shape=None, convention="fourier"):
    """Full per-source RIME predict (K × optional gaussian envelope × B),
    rows sharded over "row" and channels over "chan" when present.

    brightness : (src, chan, corr), real or complex
    Returns the (row, chan, corr) complex visibilities, in the operands'
    precision, on the mesh's first device.
    """
    lm, uvw, freq = as_tensor(lm), as_tensor(uvw), as_tensor(frequency)
    b = as_tensor(brightness)
    gs = None if gauss_shape is None else as_tensor(gauss_shape)
    nrow_shard = mesh.shape["row"]
    nchan_shard = mesh.shape["chan"] if "chan" in mesh.axis_names else 1
    rp = check_rows(uvw.shape[0], nrow_shard)
    cp = check_rows(freq.shape[0], nchan_shard, "channels")
    devices = mesh.devices.reshape(nrow_shard, nchan_shard)
    ctype = complex_dtype_for(lm, uvw, freq, b)
    out = torch.empty((uvw.shape[0], freq.shape[0], b.shape[2]), dtype=ctype,
                      device=mesh.first)
    for i in range(nrow_shard):
        rows = shard_slice(i, rp)
        for j in range(nchan_shard):
            chans = shard_slice(j, cp)
            d = devices[i, j]
            part = _predict_shard(lm.to(d), uvw[rows].to(d), freq[chans].to(d),
                                  b[:, chans].to(d),
                                  None if gs is None else gs.to(d), convention)
            out[rows, chans] = part.to(out.dtype).to(mesh.first)
    return out
