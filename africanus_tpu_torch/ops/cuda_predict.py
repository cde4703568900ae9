"""Fused K[×env]×B predict: the source contraction of the RIME predict.

Port of ``africanus_tpu/ops/pallas_predict.py``. Its two Pallas TPU
kernels, ``predict_kb_pallas_srclane`` (sources on lanes, MXU dot) and
``predict_kb_pallas`` (row × chan tiles), compute one map; here one
hand-written CUDA kernel for Hopper, ``csrc/predict_kb.cu``, computes it
for both (its header says what bounds it and how it is laid out):

    V[r,f,c] = Σ_s e^{iφ(s,r,f)} · env(s,r,f) · B[s,f,c]

:func:`predict_kb` launches the kernel on CUDA tensors and counts the
launches in ``predict_kb.launches``; on CPU tensors it computes the same
map with :func:`predict_kb_reference`, the plain PyTorch version, which
the tests hold against both Pallas kernels and ``chip_smoke.py`` holds
the kernel against on the card. Any S, R and F are accepted: the TPU's
tile divisibility rules and padding do not carry over.
"""

from __future__ import annotations

import ctypes
import math

import torch

from africanus_tpu_torch.ops import _build
from africanus_tpu_torch.ops.dfloat import frac_cycles

__all__ = ["predict_kb", "predict_kb_reference", "build_predict_kb"]

_SOURCES = ("predict_kb.cu",)


def build_predict_kb():
    """Compile ``csrc/predict_kb.cu`` if needed: (library path, seconds
    spent compiling, compiler log)."""
    return _build.build("predict_kb", _SOURCES)


def _library():
    lib = _build.load("predict_kb", _SOURCES)
    fn = lib.predict_kb_launch
    if fn.argtypes is None:
        # c_void_p for every pointer and the stream: ctypes would pass a
        # bare Python int as a 32-bit int and cut the address
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
        fn.restype = ctypes.c_int
    return fn


def _unpack(phase_dot, u1, v1, freq, scaled_freq, b):
    """Validate the operands; return (hi, lo or None, u1, v1)."""
    compensated = isinstance(phase_dot, (tuple, list))
    if compensated:
        if len(phase_dot) != 2:
            raise ValueError("a compensated delay is a (hi, lo) pair")
        hi, lo = phase_dot
    else:
        hi, lo = phase_dot, None
    if (u1 is None) != (v1 is None):
        raise ValueError("u1 and v1 must be given together (or both None)")
    if not isinstance(hi, torch.Tensor) or hi.ndim != 2:
        raise ValueError("the delay must be a (src, row) tensor")
    nsrc, nrow = hi.shape
    planes = [("delay", hi)]
    if lo is not None:
        planes.append(("delay lo", lo))
    if u1 is not None:
        planes += [("u1", u1), ("v1", v1)]
    for name, x in planes:
        if x.dtype != torch.float32 or tuple(x.shape) != (nsrc, nrow):
            raise ValueError(f"{name} must be float32 (src, row) = "
                             f"{(nsrc, nrow)}, got {x.dtype} {tuple(x.shape)}")
    if freq.ndim != 1 or freq.dtype != torch.float32:
        raise ValueError("freq must be a float32 (chan,) tensor")
    nchan = freq.shape[0]
    if scaled_freq.dtype != torch.float32 or tuple(scaled_freq.shape) != (nchan,):
        raise ValueError("scaled_freq must be a float32 (chan,) tensor")
    if b.dtype != torch.complex64 or b.ndim != 3 or tuple(b.shape[:2]) != (nsrc, nchan):
        raise ValueError(f"b must be complex64 (src, chan, corr) with "
                         f"(src, chan) = {(nsrc, nchan)}, got {b.dtype} "
                         f"{tuple(b.shape)}")
    if b.shape[2] not in (1, 2, 4):
        raise ValueError(f"corr must be 1, 2 or 4, got {b.shape[2]}")
    tensors = [x for _, x in planes] + [freq, scaled_freq, b]
    if any(x.device != hi.device for x in tensors):
        raise ValueError("all operands must be on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("all operands must be contiguous")
    return hi, lo, u1, v1


def predict_kb(phase_dot, u1, v1, freq, scaled_freq, b):
    """Fused K[×env]×B predict.

    Parameters
    ----------
    phase_dot : either a (src, row) float32 tensor — the 2π/c-scaled
        geometric delay, phase = dot·ν in radians (plain mode) — or a
        two-float ``(hi, lo)`` pair of (src, row) float32 tensors in
        signed *seconds* (from
        :func:`africanus_tpu_torch.rime.phase.phase_dot_cycles`): the
        phase is then 2π·frac((hi+lo)·ν), reduced at ~48-bit precision
        (compensated mode).
    u1, v1 : (src, row) float32 or None — gaussian-envelope coordinates
        (envelope = exp(−((u1·sf)² + (v1·sf)²))); None for point sources
    freq : (chan,) float32; scaled_freq : (chan,) float32 (gauss-scaled)
    b : (src, chan, corr) complex64 brightness, corr ∈ {1, 2, 4}

    Every operand is contiguous and on one device. CUDA tensors launch
    ``csrc/predict_kb.cu``; CPU tensors take :func:`predict_kb_reference`.

    Returns
    -------
    (row, chan, corr) complex64 visibilities.
    """
    hi, lo, u1, v1 = _unpack(phase_dot, u1, v1, freq, scaled_freq, b)
    if hi.device.type == "cpu":
        return predict_kb_reference(phase_dot, u1, v1, freq, scaled_freq, b)
    if hi.device.type != "cuda":
        raise ValueError(f"predict_kb runs on cuda or cpu, not {hi.device}")

    nsrc, nrow = hi.shape
    nchan, ncorr = b.shape[1], b.shape[2]
    fn = _library()
    out = torch.empty((nrow, nchan, ncorr), dtype=torch.complex64,
                      device=hi.device)
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(hi.data_ptr(),
                lo.data_ptr() if lo is not None else None,
                u1.data_ptr() if u1 is not None else None,
                v1.data_ptr() if v1 is not None else None,
                freq.data_ptr(), scaled_freq.data_ptr(),
                b.data_ptr(), out.data_ptr(),
                nsrc, nrow, nchan, ncorr, stream)
    if rc != 0:
        raise RuntimeError(f"predict_kb launch failed: CUDA error {rc}")
    predict_kb.launches += 1
    return out


predict_kb.launches = 0


def predict_kb_reference(phase_dot, u1, v1, freq, scaled_freq, b,
                         source_block: int = 8):
    """The plain PyTorch version of :func:`predict_kb` (same operands).

    Computes the map in eager torch, ``source_block`` sources at a time,
    so that its peak memory is a few (source_block, row, chan) planes —
    at the MeerKAT-64 full-band chunk a whole (src, row, chan) f32 plane
    would be 13 GB. The compensated phase is the same two-float chain as
    the kernel's (:func:`africanus_tpu_torch.ops.dfloat.frac_cycles`).
    """
    hi, lo, u1, v1 = _unpack(phase_dot, u1, v1, freq, scaled_freq, b)
    nsrc, nrow = hi.shape
    nchan, ncorr = b.shape[1], b.shape[2]
    out = torch.zeros((nrow, nchan, ncorr), dtype=torch.complex64,
                      device=hi.device)
    for s0 in range(0, nsrc, source_block):
        blk = slice(s0, s0 + source_block)
        h = hi[blk, :, None]
        if lo is not None:
            phase = (2.0 * math.pi) * frac_cycles(h, lo[blk, :, None], freq)
        else:
            phase = h * freq
        kre, kim = torch.cos(phase), torch.sin(phase)
        if u1 is not None:
            fu = u1[blk, :, None] * scaled_freq
            fv = v1[blk, :, None] * scaled_freq
            env = torch.exp(-(fu * fu + fv * fv))
            kre, kim = kre * env, kim * env
        out += torch.einsum("srf,sfc->rfc", torch.complex(kre, kim), b[blk])
    return out
