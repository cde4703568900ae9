"""Port parity: the DFT kernels (africanus_tpu_torch.ops.cuda_dft) and the
DFT module (africanus_tpu_torch.dft) against africanus_tpu.

- Host tables: ``chan_group_tables`` is bitwise equal to
  ``pallas_dft._chan_group_tables`` on the mode cases of
  tests/test_dft.py (same groups, same modes, same float32 tables).
- Kernels: on CPU tensors ``dft_forward``/``dft_adjoint`` are their
  plain versions, held against ``dft_forward_pallas`` and
  ``dft_adjoint_pallas`` in interpret mode within 3e-6·max|out|, the
  bound of tests/test_dft.py:322,363. Both sides take the same delays,
  bitwise, and the same modes, but not the same channel groups: the
  Pallas kernels' (cg·C ≤ 8 or ≤ 4, a recurrence from each group's first
  channel) against the port's (cg ≤ 16 and cg·C ≤ 32, a recurrence from
  the middle channel, the first-order rotation within ``delay_small``;
  tests/test_torch_dft_plan.py holds them against float64 oracles). What
  differs is the recurrence's drift, cos/sin rounding and the order of
  the f32 sums.
- Module: ``im_to_vis``/``vis_to_im`` against ``im_to_vis_ri``/
  ``vis_to_im_ri``: float64 within 1e-10·max|out| (the same einsum
  formulation; the sum order differs), float32 within 3e-6·max|out|
  (the port's fused plain versions against the JAX package's
  compensated einsum).
The CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from africanus_tpu.dft import im_to_vis_ri, vis_to_im_ri
from africanus_tpu.ops import pallas_dft as pd
from africanus_tpu.ops.cplx import Cplx
from africanus_tpu.rime.phase import phase_dot_cycles as jax_phase_dot_cycles

from africanus_tpu_torch.dft import dft_plan, im_to_vis, vis_to_im
from africanus_tpu_torch.ops import cuda_dft as cd
from africanus_tpu_torch.ops import cuda_predict as cp

BOUND_F32 = 3e-6
BOUND_F64 = 1e-10

# (nrow, nchan, ncorr, grid): tests/test_dft.py:287-289 and :327-329
ADJOINT_CASES = [(300, 4, 2, "exact"), (300, 16, 2, "residual"),
                 (257, 3, 1, "direct"), (64, 1, 4, "exact"),
                 (120, 12, 2, "residual"), (120, 12, 2, "direct")]
FORWARD_CASES = [(130, 4, 2, "exact", False), (257, 3, 1, "direct", True),
                 (64, 1, 4, "exact", False), (140, 16, 2, "residual", True),
                 (120, 12, 1, "residual", False), (120, 12, 1, "direct", False)]


def _mode_freq(grid, nchan, rng):
    """tests/test_dft.py:_mode_freq: a grid that engages ``grid``."""
    if grid == "exact":
        return np.linspace(0.856e9, 1.2e9, nchan)
    if grid == "residual":
        return np.linspace(0.856e9, 1.2e9, nchan).astype(np.float32)
    return (0.8e9 + np.sort(rng.uniform(0, 1e9, nchan))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _cplx(z):
    return Cplx(np.ascontiguousarray(z.real), np.ascontiguousarray(z.imag))


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


@pytest.mark.parametrize("nchan,ncorr,grid",
                         sorted({c[1:4] for c in ADJOINT_CASES}
                                | {c[1:4] for c in FORWARD_CASES}))
@pytest.mark.parametrize("cap", [8, 4])
@pytest.mark.parametrize("delay_max", [cd.DELAY_MAX, 4e-2])
def test_chan_group_tables_bitwise(nchan, ncorr, grid, cap, delay_max):
    freq = _mode_freq(grid, nchan, np.random.default_rng(nchan))
    want = pd._chan_group_tables(freq, nchan, ncorr, cap, delay_max)
    got = cd.chan_group_tables(freq, nchan, ncorr, cap, delay_max)
    assert got[:4] == want[:4]
    for g, w in zip(got[4:], want[4:]):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
    # a torch frequency tensor gives the same tables
    tens = cd.chan_group_tables(_t(np.asarray(freq)), nchan, ncorr, cap,
                                delay_max)
    assert tens[:4] == got[:4]
    np.testing.assert_array_equal(tens[4], got[4])


def test_cuda_dft_modes_engage():
    """The grids of the mode cases engage their modes (residual is the
    config-5 mode: an f32 linspace), and the delay bound demotes
    residual to direct (tests/test_dft.py:426-441)."""
    rng = np.random.default_rng(0)
    for grid in ("exact", "residual", "direct"):
        assert cd.chan_group_tables(_mode_freq(grid, 16, rng), 16, 2, 8)[2] == grid
    f5 = np.linspace(0.856e9, 1.712e9, 16).astype(np.float32)
    assert cd.chan_group_tables(f5, 16, 1, 8)[:3] == (8, 2, "residual")
    assert cd.chan_group_tables(f5, 16, 2, 4)[:3] == (2, 8, "residual")
    assert cd.chan_group_tables(f5, 16, 2, 8, delay_max=4e-2)[2] == "direct"


@pytest.mark.parametrize("nrow,nchan,ncorr,grid", ADJOINT_CASES)
def test_adjoint_reference_matches_pallas(rng, nrow, nchan, ncorr, grid):
    f32 = np.float32
    uvw = rng.uniform(-2000, 2000, (nrow, 3)).astype(f32)
    freq = _mode_freq(grid, nchan, rng)
    lm = rng.uniform(-0.01, 0.01, (81, 2)).astype(f32)
    vis = (rng.normal(size=(nrow, nchan, ncorr))
           + 1j * rng.normal(size=(nrow, nchan, ncorr))).astype(np.complex64)
    dhi, dlo = jax_phase_dot_cycles(lm, uvw, "casa")
    want = np.asarray(pd.dft_adjoint_pallas((dhi.T, dlo.T), freq, _cplx(vis),
                                            interpret=True))
    before = cd.dft_adjoint.launches
    plan = cd.DftPlan("adjoint", _t(lm), _t(np.asarray(freq)), ncorr, "casa")
    got = cd.dft_adjoint(plan, _t(uvw), _t(vis))
    assert cd.dft_adjoint.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (81, nchan, ncorr)
    assert _rel(got.numpy(), want) <= BOUND_F32


@pytest.mark.parametrize("nrow,nchan,ncorr,grid,complex_image", FORWARD_CASES)
def test_forward_reference_matches_pallas(rng, nrow, nchan, ncorr, grid,
                                          complex_image):
    f32 = np.float32
    nsrc = 37
    uvw = rng.uniform(-2000, 2000, (nrow, 3)).astype(f32)
    freq = _mode_freq(grid, nchan, rng)
    lm = rng.uniform(-0.01, 0.01, (nsrc, 2)).astype(f32)
    re = rng.normal(size=(nsrc, nchan, ncorr)).astype(f32)
    im = (rng.normal(size=(nsrc, nchan, ncorr)).astype(f32) if complex_image
          else np.zeros_like(re))
    dhi, dlo = jax_phase_dot_cycles(lm, uvw, "fourier")
    want = _np(pd.dft_forward_pallas((dhi, dlo), freq, Cplx(re, im),
                                     interpret=True,
                                     imag_zero=not complex_image))
    image = _t((re + 1j * im).astype(np.complex64)) if complex_image else _t(re)
    plan = cd.DftPlan("forward", _t(lm), _t(np.asarray(freq)), ncorr, "fourier")
    got = cd.dft_forward(plan, _t(uvw), image)
    assert got.dtype == torch.complex64 and got.shape == (nrow, nchan, ncorr)
    assert _rel(got.numpy(), want) <= BOUND_F32


def test_reference_blocks_do_not_change_results(rng, monkeypatch):
    """The plain versions' source/pixel blocking only bounds memory: 13
    directions in one block, and in blocks of 4 and 5 with a ragged last
    one."""
    f32 = np.float32
    uvw = _t(rng.uniform(-2000, 2000, (50, 3)).astype(f32))
    lm = _t(rng.uniform(-0.01, 0.01, (13, 2)).astype(f32))
    freq = _t(np.linspace(0.9e9, 1.0e9, 6).astype(f32))
    img = _t(rng.normal(size=(13, 6, 2)).astype(f32))
    vis = _t((rng.normal(size=(50, 6, 2)) + 1j).astype(np.complex64))
    fwd = cd.DftPlan("forward", lm, freq, 2, "fourier")
    adj = cd.DftPlan("adjoint", lm, freq, 2, "casa")
    a = cd.dft_forward_reference(fwd, uvw, img)
    c = cd.dft_adjoint_reference(adj, uvw, vis)
    monkeypatch.setattr(cd, "_REF_SOURCE_BLOCK", 4)
    monkeypatch.setattr(cd, "_REF_PIXEL_BLOCK", 5)
    b = cd.dft_forward_reference(fwd, uvw, img)
    assert (a - b).abs().max() <= 1e-6 * a.abs().max()
    d = cd.dft_adjoint_reference(adj, uvw, vis)
    torch.testing.assert_close(c, d, rtol=0, atol=0)


def test_kernel_wrappers_validate_operands(rng):
    f32 = np.float32
    lm = _t(rng.uniform(-0.01, 0.01, (4, 2)).astype(f32))
    uvw = _t(rng.uniform(-100, 100, (6, 3)).astype(f32))
    freq = _t(np.linspace(1e9, 1.1e9, 3).astype(f32))
    img = _t(rng.normal(size=(4, 3, 2)).astype(f32))
    vis = torch.complex(_t(rng.normal(size=(6, 3, 2)).astype(f32)),
                        torch.zeros(6, 3, 2))
    fwd = cd.DftPlan("forward", lm, freq, 2, "fourier")
    adj = cd.DftPlan("adjoint", lm, freq, 2, "casa")
    cd.dft_forward(fwd, uvw, img)
    cd.dft_adjoint(adj, uvw, vis)
    bad_plans = [
        ("sideways", lm, freq, 2, "fourier"),          # kind
        ("forward", lm.double(), freq, 2, "fourier"),  # lm dtype
        ("forward", lm[:, :1], freq, 2, "fourier"),    # lm shape
        ("forward", lm, freq, 0, "fourier"),           # no corr
    ]
    for args in bad_plans:
        with pytest.raises(ValueError):
            cd.DftPlan(*args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cd.DftPlan("forward", lm.to("meta"), freq, 2, "fourier")
    with pytest.raises(ValueError):
        cd.DftPlan("forward", lm, freq, 2, "sideways")  # convention
    bad_forward = [
        (adj, uvw, img),                               # plan kind
        (fwd, uvw[:, :2].contiguous(), img),           # uvw shape
        (fwd, uvw, img[:3].contiguous()),              # src mismatch
        (fwd, uvw, img.double()),                      # image dtype
        (fwd, uvw, img[:, :2].contiguous()),           # chan mismatch
        (fwd, uvw, img[..., :1].contiguous()),         # corr mismatch
        (fwd, uvw, img.transpose(0, 1).contiguous().transpose(0, 1)),  # contiguity
    ]
    for args in bad_forward:
        with pytest.raises(ValueError):
            cd.dft_forward(*args)
    with pytest.raises(ValueError):
        cd.dft_adjoint(adj, uvw, vis.real.contiguous())   # not complex
    with pytest.raises(ValueError):
        cd.dft_adjoint(adj, uvw[:5].contiguous(), vis)    # row mismatch
    with pytest.raises(ValueError):
        cd.dft_adjoint(adj, uvw.to("meta"), vis)          # device mismatch


@pytest.mark.parametrize("convention", ["fourier", "casa"])
@pytest.mark.parametrize("complex_image", [False, True])
def test_im_to_vis_f64(rng, convention, complex_image):
    lm = rng.uniform(-0.01, 0.01, (6, 2))
    uvw = rng.uniform(-800, 800, (21, 3))
    freq = np.linspace(0.856e9, 1.712e9, 8)
    image = rng.normal(size=(6, 8, 2))
    if complex_image:
        image = image + 1j * rng.normal(size=(6, 8, 2))
    want = _np(im_to_vis_ri(_cplx(image) if complex_image else image, uvw, lm,
                            freq, convention))
    got = im_to_vis(_t(image), _t(uvw), _t(lm), _t(freq), convention)
    assert got.dtype == torch.complex128
    assert _rel(got.numpy(), want) <= BOUND_F64


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_vis_to_im_f64_with_flags(rng, convention):
    lm = rng.uniform(-0.01, 0.01, (6, 2))
    uvw = rng.uniform(-800, 800, (21, 3))
    freq = np.linspace(0.856e9, 1.712e9, 8)
    vis = rng.normal(size=(21, 8, 2)) + 1j * rng.normal(size=(21, 8, 2))
    flags = rng.uniform(size=(21, 8, 2)) < 0.2
    want = np.asarray(vis_to_im_ri(_cplx(vis), uvw, lm, freq, flags, convention))
    got = vis_to_im(_t(vis), _t(uvw), _t(lm), _t(freq), _t(flags), convention)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= BOUND_F64


@pytest.mark.parametrize("convention", ["fourier", "casa"])
@pytest.mark.parametrize("nchan,ncorr", [(16, 2), (12, 1), (5, 4)])
def test_im_to_vis_f32(rng, convention, nchan, ncorr):
    f32 = np.float32
    lm = rng.uniform(-0.01, 0.01, (9, 2)).astype(f32)
    uvw = rng.uniform(-4000, 4000, (70, 3)).astype(f32)
    freq = np.linspace(0.856e9, 1.712e9, nchan).astype(f32)
    image = rng.uniform(0.1, 1.0, (9, nchan, ncorr)).astype(f32)
    want = _np(im_to_vis_ri(image, uvw, lm, freq, convention,
                            real_dtype=jnp.float32))
    before = cd.dft_forward.launches
    got = im_to_vis(_t(image), _t(uvw), _t(lm), _t(freq), convention)
    assert cd.dft_forward.launches == before
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), want) <= BOUND_F32


@pytest.mark.parametrize("convention", ["fourier", "casa"])
@pytest.mark.parametrize("nchan,ncorr", [(16, 1), (12, 2), (3, 4)])
def test_vis_to_im_f32_with_flags(rng, convention, nchan, ncorr):
    f32 = np.float32
    lm = rng.uniform(-0.01, 0.01, (25, 2)).astype(f32)
    uvw = rng.uniform(-4000, 4000, (90, 3)).astype(f32)
    freq = np.linspace(0.856e9, 1.712e9, nchan).astype(f32)
    vis = (rng.normal(size=(90, nchan, ncorr))
           + 1j * rng.normal(size=(90, nchan, ncorr))).astype(np.complex64)
    flags = rng.uniform(size=(90, nchan, ncorr)) < 0.1
    want = np.asarray(vis_to_im_ri(_cplx(vis), uvw, lm, freq, flags, convention,
                                   real_dtype=jnp.float32))
    got = vis_to_im(_t(vis), _t(uvw), _t(lm), _t(freq), _t(flags), convention)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= BOUND_F32


@pytest.mark.parametrize("convention", ["fourier", "casa"])
@pytest.mark.parametrize("nchan", [12, 128])
def test_im_to_vis_f32_three_correlations(rng, convention, nchan):
    """Three correlations in float32 compute as the JAX package does, on
    the dft_forward route (< 128 channels) and the predict_kb route (the
    kernels take 1, 2 or 4 at a time: the card splits 3 = 2 + 1)."""
    f32 = np.float32
    lm = rng.uniform(-0.01, 0.01, (9, 2)).astype(f32)
    uvw = rng.uniform(-4000, 4000, (70, 3)).astype(f32)
    freq = np.linspace(0.856e9, 1.712e9, nchan).astype(f32)
    image = rng.uniform(0.1, 1.0, (9, nchan, 3)).astype(f32)
    want = _np(im_to_vis_ri(image, uvw, lm, freq, convention,
                            real_dtype=jnp.float32))
    got = im_to_vis(_t(image), _t(uvw), _t(lm), _t(freq), convention)
    assert got.dtype == torch.complex64 and got.shape == (70, nchan, 3)
    assert _rel(got.numpy(), want) <= BOUND_F32


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_vis_to_im_f32_three_correlations(rng, convention):
    f32 = np.float32
    lm = rng.uniform(-0.01, 0.01, (25, 2)).astype(f32)
    uvw = rng.uniform(-4000, 4000, (90, 3)).astype(f32)
    freq = np.linspace(0.856e9, 1.712e9, 12).astype(f32)
    vis = (rng.normal(size=(90, 12, 3))
           + 1j * rng.normal(size=(90, 12, 3))).astype(np.complex64)
    flags = rng.uniform(size=(90, 12, 3)) < 0.1
    want = np.asarray(vis_to_im_ri(_cplx(vis), uvw, lm, freq, flags, convention,
                                   real_dtype=jnp.float32))
    got = vis_to_im(_t(vis), _t(uvw), _t(lm), _t(freq), _t(flags), convention)
    assert got.dtype == torch.float32 and got.shape == (25, 12, 3)
    assert _rel(got.numpy(), want) <= BOUND_F32


@pytest.mark.parametrize("kind", ["forward", "adjoint"])
def test_dft_plan_splits_correlations_the_kernels_take(rng, kind):
    """A plan of 3 (or 7) correlations holds one sub-plan per group the
    kernels take, each the plan of its own count (the channel groups
    depend on it); 1, 2 and 4 need none."""
    lm = _t(rng.uniform(-0.01, 0.01, (4, 2)).astype(np.float32))
    freq = np.linspace(0.856e9, 1.712e9, 16)
    for ncorr, groups in ((3, [(0, 2), (2, 1)]), (7, [(0, 4), (4, 2), (6, 1)]),
                          (4, [(0, 4)])):
        plan = cd.DftPlan(kind, lm, freq, ncorr, "fourier")
        assert plan.groups == groups
        assert len(plan.parts) == (0 if ncorr == 4 else len(groups))
        for (_, k), part in zip(groups, plan.parts):
            alone = cd.DftPlan(kind, lm, freq, k, "fourier")
            assert (part.ncorr, part.cg, part.mode) == (k, alone.cg, alone.mode)
            assert np.array_equal(part.rtab, alone.rtab)
            assert np.array_equal(part.gtab, alone.gtab)


def test_dft_empty_inputs():
    f32 = torch.float32
    freq = torch.linspace(1e9, 1.1e9, 4)
    z = im_to_vis(torch.zeros((0, 4, 2)), torch.ones((5, 3)),
                  torch.zeros((0, 2)), freq)
    assert z.shape == (5, 4, 2) and not z.abs().any()
    z = vis_to_im(torch.zeros((0, 4, 2), dtype=torch.complex64),
                  torch.zeros((0, 3)), torch.zeros((7, 2)), freq,
                  torch.zeros((0, 4, 2), dtype=torch.bool))
    assert z.shape == (7, 4, 2) and z.dtype == f32 and not z.abs().any()
    plan = cd.DftPlan("adjoint", torch.zeros((0, 2)), freq, 1, "casa")
    z = cd.dft_adjoint(plan, torch.ones((3, 3)),
                       torch.ones((3, 4, 1), dtype=torch.complex64))
    assert z.shape == (0, 4, 1)


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_im_to_vis_wide_band_routes_through_predict_kb(rng, monkeypatch,
                                                       convention):
    """≥ 128 channels: im_to_vis takes predict_kb with point sources
    (no envelope), as dft/kernels.py:138-153 takes predict_kb_pallas —
    held against that route in interpret mode, at the compensated
    predict bound of tests/test_pallas_predict.py (2e-6·max|V|)."""
    f32 = np.float32
    lm = rng.uniform(-0.01, 0.01, (5, 2)).astype(f32)
    uvw = rng.uniform(-4000, 4000, (16, 3)).astype(f32)
    freq = np.linspace(0.856e9, 1.712e9, 128).astype(f32)
    image = rng.normal(size=(5, 128, 2)).astype(f32)
    want = _np(im_to_vis_ri(image, uvw, lm, freq, convention,
                            real_dtype=jnp.float32, use_pallas=True,
                            interpret=True))
    calls = []
    orig = cp.predict_kb_reference

    def spy(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    monkeypatch.setattr(cp, "predict_kb_reference", spy)
    got = im_to_vis(_t(image), _t(uvw), _t(lm), _t(freq), convention)
    assert len(calls) == 1
    _, u1, v1, _, sf, _ = calls[0]
    assert u1 is None and v1 is None and not sf.any()
    assert _rel(got.numpy(), want) <= 2e-6


def test_measured_delay_max_matches_jax(rng, monkeypatch):
    lm = rng.uniform(-0.01, 0.01, (40, 2)).astype(np.float32)
    uvw = rng.uniform(-4000, 4000, (300, 3)).astype(np.float32)
    want = float(np.abs(np.asarray(jax_phase_dot_cycles(lm, uvw)[0])).max())
    got = cd.measured_delay_max(_t(lm), _t(uvw))  # one block
    assert abs(got - want) <= 1e-6 * want
    monkeypatch.setattr(cd, "_DELAY_BLOCK", 7)  # ragged blocks
    assert cd.measured_delay_max(_t(lm), _t(uvw)) == got
    assert cd.measured_delay_max(torch.zeros((0, 2)), _t(uvw)) == 1e-12


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_dft_plan_is_what_each_call_plans(rng, adjoint, convention):
    """A plan made once (as SelfcalStep makes it) gives bitwise what the
    call plans for itself, and one made for the other convention is
    refused."""
    f32 = np.float32
    lm = _t(rng.uniform(-0.01, 0.01, (11, 2)).astype(f32))
    uvw = _t(rng.uniform(-4000, 4000, (40, 3)).astype(f32))
    freq = np.linspace(0.856e9, 1.712e9, 16).astype(f32)
    plan = dft_plan(uvw, lm, freq, 2, convention, adjoint=adjoint)
    assert plan.kind == ("adjoint" if adjoint else "forward")
    assert plan.mode == "residual"
    other = "casa" if convention == "fourier" else "fourier"
    if adjoint:
        vis = _t((rng.normal(size=(40, 16, 2))
                  + 1j * rng.normal(size=(40, 16, 2))).astype(np.complex64))
        flags = torch.zeros((40, 16, 2), dtype=torch.bool)
        want = vis_to_im(vis, uvw, lm, _t(freq), flags, convention)
        got = vis_to_im(vis, uvw, lm, _t(freq), flags, convention, plan=plan)
        with pytest.raises(ValueError, match="convention"):
            vis_to_im(vis, uvw, lm, _t(freq), flags, other, plan=plan)
    else:
        image = _t(rng.uniform(0.1, 1.0, (11, 16, 2)).astype(f32))
        want = im_to_vis(image, uvw, lm, _t(freq), convention)
        got = im_to_vis(image, uvw, lm, _t(freq), convention, plan=plan)
        with pytest.raises(ValueError, match="convention"):
            im_to_vis(image, uvw, lm, _t(freq), other, plan=plan)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
