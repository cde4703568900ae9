"""The channel groups of the DFT kernels (``africanus_tpu_torch.ops.
cuda_dft.DftPlan``) and their plain versions on those groups, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_cuda.py,
``chip_smoke.py`` phases 4 and 9), where they are held against the plain
versions. Here:

- the plan at the config-5 selfcal step (197 antennas, 38612 rows, 16
  channels of a float32 linspace) holds the band in one group of 16 in
  the ``residual`` mode, and every (pixel or source, row) pair of the
  step takes the first-order rotation; at 64 channels, at 17 (a prime:
  ``direct``, the last group ragged) and at four correlations it gives
  the groups the kernels take (cg·C ≤ 32, cg ≤ 16);
- the tables rebuild each channel frequency from the group's middle
  channel, the step and the residual;
- the plain versions on those groups — the phasor at the middle
  channel, the recurrence up and down, the rotation to first order or by
  the polynomial — hold 3e-6 of max against the float64 oracles of
  ``calibration/selfcal.py`` for C ∈ {1, 2, 3, 4}, both conventions and
  all three modes, also where the delays pass ``delay_small``;
- the kernels' delay chain, which takes each product's error by an FMA
  (emulated here in float64, exact), gives the delays of
  ``phase_dot_cycles`` (Dekker's split) bit for bit;
- the adjoint's row chunks are a function of the shapes that covers the
  rows once in tiles.
"""

import numpy as np
import pytest
import torch

from africanus_tpu_torch.calibration.selfcal import (
    grid_lm, im_to_vis_oracle_f64, selfcal_inputs, vis_to_im_oracle_f64,
)
from africanus_tpu_torch.dft import dft_plan
from africanus_tpu_torch.ops import cuda_dft as cd
from africanus_tpu_torch.ops.dfloat import n_minus_one_df
from africanus_tpu_torch.rime.phase import phase_dot_cycles

BOUND = 3e-6  # tests/test_dft.py:322,363, of max|out|
F32 = np.float32


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _freq(grid, nchan):
    if grid == "exact":
        return np.linspace(0.856e9, 1.712e9, nchan)
    if grid == "residual":
        return np.linspace(0.856e9, 1.712e9, nchan).astype(F32)
    rng = np.random.default_rng(nchan)
    return (0.8e9 + np.sort(rng.uniform(0, 1e9, nchan))).astype(F32)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_port_dft_plan_config5_one_group_first_order():
    inputs = selfcal_inputs(nant=197, ntime=2, nchan=16, nsrc=20, ncorr=2, seed=5)
    uvw = _t(inputs["uvw"])
    assert uvw.shape[0] == 38612
    freq = inputs["frequency"]
    for lm, ncorr, adjoint in ((_t(inputs["lm"]), 2, False),
                               (_t(grid_lm(64)).to(torch.float32), 1, True)):
        plan = dft_plan(uvw, lm, freq, ncorr, adjoint=adjoint)
        assert (plan.cg, plan.ngroups, plan.mode) == (16, 1, "residual")
        # every pair of the step takes the first-order rotation (the
        # delays a block of 512 directions at a time)
        peak = max(float(phase_dot_cycles(lm[s:s + 512], uvw, plan.convention)[0]
                         .abs().max()) for s in range(0, lm.shape[0], 512))
        assert peak <= plan.delay_small == plan.delay_max
        # ... whose error x²/2 is under 1e-7 there
        x = plan.delay_small * np.abs(plan.rtab).max()
        assert x * x / 2 <= 1e-7


@pytest.mark.parametrize("nchan,ncorr,grid,want", [
    (64, 1, "residual", (16, 4, "residual")),
    (64, 2, "exact", (16, 4, "exact")),
    (64, 4, "residual", (8, 8, "residual")),
    (16, 4, "exact", (8, 2, "exact")),
    (12, 4, "residual", (6, 2, "residual")),
    (17, 1, "residual", (16, 2, "direct")),
    (17, 4, "exact", (8, 3, "direct")),
    (40, 2, "direct", (16, 3, "direct")),
    (1, 1, "exact", (1, 1, "direct")),
])
def test_port_dft_plan_groups_the_kernels_take(nchan, ncorr, grid, want):
    lm = _t(np.zeros((3, 2), F32))
    freq = _freq(grid, nchan)
    for kind in ("forward", "adjoint"):
        plan = cd.DftPlan(kind, lm, freq, ncorr, "fourier")
        assert (plan.cg, plan.ngroups, plan.mode) == want
        assert plan.cg * ncorr <= 32 and plan.cg <= 16
        assert plan.cg * (plan.ngroups - 1) < nchan <= plan.cg * plan.ngroups
        for name in ("ftab", "rtab", "gtab"):
            assert torch.equal(getattr(plan, f"{name}_dev"),
                               torch.from_numpy(getattr(plan, name)))
        assert plan.ftab.shape == (nchan, 4) and plan.gtab.shape == (plan.ngroups, 2, 4)
        if plan.mode == "direct":
            assert not plan.gtab.any() and not plan.rtab.any()
            continue
        # each channel from its group's middle channel, the step and the
        # residual table, as the kernels walk them
        mid = plan.gtab[:, 0, 0].astype(np.float64) + plan.gtab[:, 0, 3]
        step = float(plan.gtab[0, 1, 0]) + float(plan.gtab[0, 1, 3])
        k = np.arange(plan.cg) - plan.cg // 2
        grid_f = (mid[:, None] + k * step).reshape(-1)
        rebuilt = grid_f + plan.rtab.astype(np.float64) / (2 * np.pi)
        np.testing.assert_allclose(rebuilt, np.asarray(freq, np.float64),
                                   rtol=0, atol=2e-3)


def _problem(rng, nsrc, npix, nrow, nchan, ncorr, scale=1.0):
    lm_s = rng.uniform(-0.05, 0.05, (nsrc, 2)).astype(F32)
    lm_p = rng.uniform(-0.05, 0.05, (npix, 2)).astype(F32)
    uvw = (rng.uniform(-8000, 8000, (nrow, 3)) * scale).astype(F32)
    img = rng.normal(size=(nsrc, nchan, ncorr)).astype(F32)
    vis = (rng.normal(size=(nrow, nchan, ncorr))
           + 1j * rng.normal(size=(nrow, nchan, ncorr))).astype(np.complex64)
    return lm_s, lm_p, uvw, img, vis


def _against_oracles(lm_s, lm_p, uvw, freq, img, vis, ncorr, convention):
    """(forward, adjoint) errors of the plain versions against the
    float64 oracles, and their plans. The oracles take the fourier
    convention of im_to_vis / vis_to_im: the other sign is -uvw."""
    sign = 1.0 if convention == "fourier" else -1.0
    uvw64 = uvw.astype(np.float64)
    fwd = cd.DftPlan("forward", _t(lm_s), freq, ncorr, convention,
                     cd.measured_delay_max(_t(lm_s), _t(uvw)))
    got = cd.dft_forward_reference(fwd, _t(uvw), _t(img)).numpy()
    e_fwd = _rel(got, im_to_vis_oracle_f64(img, sign * uvw64, lm_s, freq))
    adj = cd.DftPlan("adjoint", _t(lm_p), freq, ncorr, convention,
                     cd.measured_delay_max(_t(lm_p), _t(uvw)))
    got = cd.dft_adjoint_reference(adj, _t(uvw), _t(vis)).numpy()
    e_adj = _rel(got, vis_to_im_oracle_f64(vis, -sign * uvw64, lm_p, freq))
    return e_fwd, e_adj, fwd, adj


@pytest.mark.parametrize("grid", ["exact", "residual", "direct"])
@pytest.mark.parametrize("ncorr", [1, 2, 3, 4])
@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_port_dft_plain_versions_match_f64_oracles(grid, ncorr, convention):
    rng = np.random.default_rng(ncorr * 10 + len(grid))
    freq = _freq(grid, 16)
    lm_s, lm_p, uvw, img, vis = _problem(rng, 23, 41, 900, 16, ncorr)
    e_fwd, e_adj, fwd, adj = _against_oracles(lm_s, lm_p, uvw, freq, img, vis,
                                              ncorr, convention)
    assert fwd.mode == adj.mode == grid
    assert e_fwd <= BOUND and e_adj <= BOUND


@pytest.mark.parametrize("nchan", [64, 17])
def test_port_dft_plain_versions_many_groups(nchan):
    """Several groups of 16 (64 channels) and a ragged direct group (17)."""
    rng = np.random.default_rng(nchan)
    freq = _freq("residual", nchan)
    lm_s, lm_p, uvw, img, vis = _problem(rng, 9, 30, 400, nchan, 2)
    e_fwd, e_adj, fwd, adj = _against_oracles(lm_s, lm_p, uvw, freq, img, vis,
                                              2, "fourier")
    assert (fwd.cg, fwd.ngroups) == ((16, 4) if nchan == 64 else (16, 2))
    assert e_fwd <= BOUND and e_adj <= BOUND


def test_port_dft_residual_rotation_beyond_delay_small():
    """Baselines to 48 km at |l| ≤ 0.05: delays to ~1.1e-5 s, beyond the
    plan's delay_small (~1.5e-6 s at 16 channels), so that most pairs
    take the rotation polynomial; the plain versions hold their bound."""
    rng = np.random.default_rng(11)
    freq = _freq("residual", 16)
    lm_s, lm_p, uvw, img, vis = _problem(rng, 23, 41, 900, 16, 1, scale=6.0)
    for convention in ("fourier", "casa"):
        e_fwd, e_adj, fwd, adj = _against_oracles(lm_s, lm_p, uvw, freq, img,
                                                  vis, 1, convention)
        assert fwd.mode == adj.mode == "residual"
        for plan, lm in ((fwd, lm_s), (adj, lm_p)):
            dhi, _ = phase_dot_cycles(_t(lm), _t(uvw), plan.convention)
            beyond = float((dhi.abs() > plan.delay_small).float().mean())
            assert plan.delay_small < plan.delay_max and beyond >= 0.5
        assert e_fwd <= BOUND and e_adj <= BOUND


@pytest.mark.parametrize("npix,nrow,ngroups", [
    (4096, 38612, 1), (4096, 4827, 1), (300, 1000, 1), (300, 1000, 4),
    (5, 9, 1), (129, 33, 2), (1, 1, 3)])
def test_port_dft_row_chunks_cover_the_rows(npix, nrow, ngroups):
    rows, nchunks = cd._row_chunks(npix, nrow, ngroups)
    assert rows % cd._ROW_TILE == 0 and rows * (nchunks - 1) < nrow <= rows * nchunks
    assert cd._row_chunks(npix, nrow, ngroups) == (rows, nchunks)
    gpb = cd._groups_a_block(ngroups)
    blocks = -(-npix // (cd._THREADS // gpb)) * -(-ngroups // gpb) * nchunks
    assert nchunks == 1 or blocks <= 2 * cd._TARGET_BLOCKS


def _kernel_delay(lm, uvw, convention):
    """csrc/dft.cu's delay() in numpy float32, its products' errors by a
    fused multiply-add: a·b − p in float64 is exact (a 48-bit product
    less its float32 rounding), then rounded once."""
    f32, f64 = np.float32, np.float64

    def prod_err(p, a, b):
        return (a.astype(f64) * b.astype(f64) - p.astype(f64)).astype(f32)

    def two_sum(a, b):
        s = a + b
        v = s - a
        return s, (a - (s - v)) + (b - v)

    def quick_two_sum(a, b):
        s = a + b
        return s, b - (s - a)

    with np.errstate(over="ignore", invalid="ignore"):
        nh, nl = (x.numpy()[:, None] for x in n_minus_one_df(_t(lm[:, 0]), _t(lm[:, 1])))
        l, m = lm[:, :1], lm[:, 1:]  # noqa: E741
        u, v, w = uvw[None, :, 0], uvw[None, :, 1], uvw[None, :, 2]
        p1, p2, p3 = l * u, m * v, nh * w
        s, e = two_sum(p1, p2)
        ah, al = quick_two_sum(s, (e + prod_err(p1, l, u)) + prod_err(p2, m, v))
        bh, bl = quick_two_sum(p3, prod_err(p3, nh, w) + nl * w)
        s, e = two_sum(ah, bh)
        mh, ml = quick_two_sum(s, (e + al) + bl)
        chi, clo = (f32(x) for x in cd._sign_pair(convention))
        p = mh * chi
        return quick_two_sum(p, prod_err(p, mh, chi) + (mh * clo + ml * chi))


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_port_dft_kernel_delay_chain_is_phase_dot_cycles(convention):
    rng = np.random.default_rng(5)
    inputs = selfcal_inputs(nant=16, ntime=2, nchan=16, nsrc=20, ncorr=2, seed=5)
    lm = np.concatenate([grid_lm(16).astype(F32), inputs["lm"],
                         rng.uniform(-0.7, 0.7, (40, 2)).astype(F32),
                         np.zeros((1, 2), F32)])
    uvw = np.concatenate([inputs["uvw"],
                          rng.uniform(-1e5, 1e5, (50, 3)).astype(F32),
                          np.zeros((1, 3), F32)])
    hi, lo = _kernel_delay(lm, uvw, convention)
    want_hi, want_lo = (x.numpy() for x in phase_dot_cycles(_t(lm), _t(uvw), convention))
    assert np.array_equal(hi, want_hi) and np.array_equal(lo, want_lo)
