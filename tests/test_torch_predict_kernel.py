"""Port parity: the fused K×env×B predict (africanus_tpu_torch.ops.cuda_predict)
against BOTH Pallas TPU kernels it replaces, run in interpret mode.

On the CPU, ``predict_kb`` takes its plain version ``predict_kb_reference``;
the CUDA kernel itself is held against that plain version on the card
(``chip_smoke.py`` and tests/test_torch_cuda.py, which skips without a
card). Shapes are TPU-divisible (R=128, F=128/32)
because the Pallas kernels require it.

Bounds are those of tests/test_pallas_predict.py: 1e-5·max|V| for the
plain phase (f32 phases of ~1e4 rad: cos/sin of the same f32 phase
differ by a few ulp of the phase between implementations) and
2e-6·max|V| for the compensated phase (both sides reduce the same
two-float cycle count; what remains is cos/sin/exp rounding and the
f32 sum over sources in different orders).
"""

import numpy as np
import pytest
import torch

import africanus_tpu.ops.pallas_predict as pp
from africanus_tpu.ops.cplx import Cplx
from africanus_tpu.rime.phase import phase_dot_cycles as jax_phase_dot_cycles

from africanus_tpu_torch.ops import cuda_predict as cp


def _problem(rng, S, R, F, C, compensated):
    if compensated:
        lm = rng.uniform(-0.02, 0.02, (S, 2)).astype(np.float32)
        uvw = rng.uniform(-8000, 8000, (R, 3)).astype(np.float32)
        dot = tuple(np.array(d) for d in jax_phase_dot_cycles(lm, uvw))
    else:
        dot = (rng.uniform(-100, 100, (S, R)) * 1e-7).astype(np.float32)
    u1 = rng.uniform(-100, 100, (S, R)).astype(np.float32)
    v1 = rng.uniform(-100, 100, (S, R)).astype(np.float32)
    freq = np.linspace(0.856e9, 1.712e9, F).astype(np.float32)
    sf = (freq * 1e-12).astype(np.float32)
    b = (rng.normal(size=(S, F, C)) + 1j * rng.normal(size=(S, F, C))
         ).astype(np.complex64)
    return dot, u1, v1, freq, sf, b


def _torch_args(dot, u1, v1, freq, sf, b, env):
    t = torch.from_numpy
    tdot = tuple(t(d) for d in dot) if isinstance(dot, tuple) else t(dot)
    return (tdot, t(u1) if env else None, t(v1) if env else None,
            t(freq), t(sf), t(b))


def _pallas(kernel, dot, u1, v1, freq, sf, b, env):
    S = b.shape[0]
    bc = Cplx(np.ascontiguousarray(b.real), np.ascontiguousarray(b.imag))
    u1, v1 = (u1, v1) if env else (None, None)
    if kernel == "srclane":
        out = pp.predict_kb_pallas_srclane(dot, u1, v1, freq, sf, bc,
                                           chan_tile=16, interpret=True)
    else:
        # the row/chan-tile kernel needs S % 8 == 0: pad with zero flux,
        # as __graft_entry__._predict_step_pallas does
        pad = (-S) % 8

        def padsr(x):
            return None if x is None else np.pad(x, ((0, pad), (0, 0)))

        dot = (tuple(padsr(d) for d in dot) if isinstance(dot, tuple)
               else padsr(dot))
        bc = Cplx(*(np.pad(x, ((0, pad), (0, 0), (0, 0))) for x in bc))
        out = pp.predict_kb_pallas(dot, padsr(u1), padsr(v1), freq, sf, bc,
                                   chan_tile=freq.shape[0], interpret=True)
    return np.asarray(out.re) + 1j * np.asarray(out.im)


@pytest.mark.parametrize("kernel", ["rowchan", "srclane"])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("env", [True, False])
@pytest.mark.parametrize("S,F,C", [(16, 128, 4), (13, 32, 2)])
def test_reference_matches_pallas(rng, kernel, compensated, env, S, F, C):
    args = _problem(rng, S, 128, F, C, compensated)
    want = _pallas(kernel, *args, env)
    got = cp.predict_kb_reference(*_torch_args(*args, env)).numpy()
    assert got.shape == want.shape == (128, F, C)
    assert got.dtype == np.complex64
    bound = 2e-6 if compensated else 1e-5
    assert np.abs(got - want).max() <= bound * np.abs(want).max()


def test_compensated_against_f64_oracle(rng):
    """tests/test_pallas_predict.py::test_pallas_predict_compensated's
    shape and bound, for the port's chain: 1e4 rad phases, < 2e-6 of
    max|V| against complex128 on the same f32 inputs."""
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    S, R, F, C = 16, 128, 128, 2
    lm = rng.uniform(-0.02, 0.02, (S, 2)).astype(np.float32)
    uvw = rng.uniform(-8000, 8000, (R, 3)).astype(np.float32)
    freq = np.linspace(0.856e9, 1.712e9, F).astype(np.float32)
    b = (rng.normal(size=(S, F, C)) + 1j * rng.normal(size=(S, F, C))
         ).astype(np.complex64)
    dot = phase_dot_cycles(torch.from_numpy(lm), torch.from_numpy(uvw))
    t_freq = torch.from_numpy(freq)
    got = cp.predict_kb(dot, None, None, t_freq, t_freq * 0,
                        torch.from_numpy(b)).numpy()

    l, m = lm[:, 0].astype(np.float64), lm[:, 1].astype(np.float64)
    n = np.sqrt(np.maximum(1 - l * l - m * m, 0)) - 1
    d = (l[:, None] * uvw[None, :, 0] + m[:, None] * uvw[None, :, 1]
         + n[:, None] * uvw[None, :, 2])
    p = (-2 * np.pi / 299792458.0) * d[:, :, None] * freq.astype(np.float64)
    ref = np.einsum("srf,sfc->rfc", np.exp(1j * p), b.astype(np.complex128))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-6


@pytest.mark.parametrize("S,R,F,C", [(37, 100, 30, 4), (1, 1, 1, 1), (0, 5, 3, 2)])
def test_cpu_wrapper_takes_plain_version_any_shape(rng, S, R, F, C):
    """On CPU tensors predict_kb IS the plain version, at any (ragged)
    shape, and launches nothing."""
    args = _torch_args(*_problem(rng, S, R, F, C, compensated=False), True)
    before = cp.predict_kb.launches
    got = cp.predict_kb(*args)
    assert cp.predict_kb.launches == before
    want = cp.predict_kb_reference(*args, source_block=3)
    assert got.shape == (R, F, C)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(S, 1))


def test_source_block_invariance(rng):
    args = _torch_args(*_problem(rng, 11, 16, 8, 4, compensated=True), True)
    full = cp.predict_kb_reference(*args, source_block=11)
    for sb in (1, 4):
        blk = cp.predict_kb_reference(*args, source_block=sb)
        scale = full.abs().max()
        assert (blk - full).abs().max() <= 2e-6 * scale


def test_wrapper_validates_operands(rng):
    dot, u1, v1, freq, sf, b = _torch_args(
        *_problem(rng, 4, 8, 6, 4, compensated=True), True)
    cp.predict_kb(dot, u1, v1, freq, sf, b)

    def strided(x):  # same values, column-major strides
        return x.T.contiguous().T

    bad = [
        ((dot[0].double(), dot[1]), u1, v1, freq, sf, b),      # dtype
        (dot, u1, None, freq, sf, b),                          # u1 without v1
        (dot, u1, v1, freq, sf, b[..., :0].contiguous()),      # no corr
        (dot, u1, v1, freq, sf, b.to(torch.complex128)),       # b dtype
        (dot, u1[:, :4], v1[:, :4], freq, sf, b),              # shape
        (dot, u1, v1, freq, sf[:5], b),                        # chan mismatch
        ((strided(dot[0]), dot[1]), u1, v1, freq, sf, b),      # contiguity
        (dot, u1, strided(v1), freq, sf, b),
        ((dot[0],), u1, v1, freq, sf, b),                      # not a pair
    ]
    for args in bad:
        with pytest.raises(ValueError):
            cp.predict_kb(*args)
    meta = tuple(x.to("meta") for x in (dot[0], dot[1], u1, v1, freq, sf, b))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cp.predict_kb(meta[:2], *meta[2:])

