"""The port on a CUDA card: the hand-written kernels against their plain
versions, and the flagship predict, the selfcal step, w-stacked imaging
and the beam DDE chain on the card against the same modules on the CPU.

Every test here needs a card and skips without one. The file imports no
JAX (the card's machine has none), so it also runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bounds: predict_kb 2e-6·max|V| for the compensated phase, 1e-5·max|V|
for the plain phase (the bounds of tests/test_pallas_predict.py; the
kernel and the plain version differ in cos/sin/exp rounding, in the
kernel's phasor recurrence along a channel group against the plain
version's phase per channel, and in the order of the f32 source sum). The DFT kernels 3e-6·max|out|, the bound
of tests/test_dft.py:322,363, for the same reasons; on plans made for
shorter baselines than the call's (pairs beyond the plan's delay bound)
also 3e-6·max against float64, reruns bitwise. The selfcal step
takes the bounds and the two cases (converged, and a model that lacks a
source) of tests/test_torch_selfcal.py. The wgrid kernels 1e-5·max|out| in
float32 and 1e-12 in float64 (sums in another order than the plain
versions' index_add_ and gather-sum); w-stacked imaging on the card
1e-5·max against the CPU, and in blocks of planes 1e-6·max against one
block (a straddling sample's parts summed in another order), reruns
bitwise. The beam kernels 1e-5·max|out| in float32 and
1e-12 in float64 (the same operations, contracted into FMAs by nvcc);
the beam chain's routes on the card 1e-5·max against the CPU. The 2D
multi-correlation and table gridder kernels 1e-5·max|out| in float32
and 1e-12 in float64 (sums in another order than index_add_ and the
gather-sum), two launches bitwise equal; the nifty and Perley-polyhedron gridders on the card
against the CPU 1e-5·max in float32, 1e-12 in float64. The averagers'
segmented sums and bda on the card against the CPU 1e-6·max in float32
and 1e-12 in float64 (each bin summed in another order), two runs
bitwise equal; the fused RIME's E term on the card 1e-5·max against the
CPU, its beam_interp and beam_blend launches counted; the direction-
dependent predict at the benchmark cell's chunk in the block the kernel
route chooses, within its memory estimate, equal to blocks of 3; the
fused_dde kernel 1e-6·max against its plain version on ragged shapes
(sincospif and ex2.approx against torch's cos, sin and exp2), blocks and
reruns bitwise equal, and the DDE route 2e-6·max against the float64
reference of the same float32 inputs; the pairs kernel equal to
phase_dot_cycles and envelope_coordinates bit for bit. The Perley-
polyhedron gridder's conv_nn_scatter route (an accumulating index_put_)
1e-5·max in complex64 and 1e-12 in complex128 against the CPU, two card
runs bitwise equal. The sky-model tail: wsclean_predict in float32
(predict_kb, one launch) 2e-6·max against the CPU's plain version and in
float64 1e-12; the store pipeline's MODEL_DATA 2e-6·max against the
CPU's, one predict_kb launch a chunk; zernike_dde and the shapelets in
float32 1e-5·max and in float64 1e-12 against the CPU in float64; the
SPI fit in float64 1e-6 (α absolute, I₀ relative) and in float32 1e-4
against the CPU in float64; stream_rows on the card as on the CPU. The CLEAN kernel
equals the plain loop run on the card (torch.equal on both images and the
running flags: the same operations in the same rounding).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    DFT_FAR_CASES, FAR_PAIRS, beam_problem, dft_far_problem, dft_problem, far_plan,
    far_warps, fused_problem, grid2d_problem, kernel_problem, pp_nn_grid, pp_nn_problem,
    shapelet_problem, spi_problem, table_problem, wgrid_problem, zernike_problem,
)

from africanus_tpu_torch.averaging import bda, time_and_channel  # noqa: E402
from africanus_tpu_torch.averaging.time_and_channel_avg import (  # noqa: E402
    _segment_table, _to_device,
)
from africanus_tpu_torch.calibration.selfcal import (  # noqa: E402
    from_numpy as selfcal_from_numpy, im_to_vis_oracle_f64, make_data,
    selfcal_inputs, vis_to_im_oracle_f64,
)
from africanus_tpu_torch.deconv.hogbom import hogbom_clean  # noqa: E402
from africanus_tpu_torch.deconv.hogbom.clean import hogbom_clean_reference  # noqa: E402
from africanus_tpu_torch.gridding import nifty  # noqa: E402
from africanus_tpu_torch.gridding import perleypolyhedron as pp  # noqa: E402
from africanus_tpu_torch.gridding.wgridder import dirty, model  # noqa: E402
from africanus_tpu_torch.gridding.wgridder.imaging import (  # noqa: E402
    from_numpy as imaging_from_numpy, imaging_inputs,
)
from africanus_tpu_torch.ops import cuda_beam as cb  # noqa: E402
from africanus_tpu_torch.ops import cuda_dft as cd  # noqa: E402
from africanus_tpu_torch.ops import cuda_fused as cf  # noqa: E402
from africanus_tpu_torch.ops import cuda_grid2d as g2  # noqa: E402
from africanus_tpu_torch.ops import cuda_gridtab as gt  # noqa: E402
from africanus_tpu_torch.ops import cuda_hogbom as ch  # noqa: E402
from africanus_tpu_torch.ops import cuda_predict as cp  # noqa: E402
from africanus_tpu_torch.ops import cuda_wgrid as cw  # noqa: E402
from africanus_tpu_torch.rime.beam_chain import (  # noqa: E402
    beam_inputs, from_numpy as beam_from_numpy,
)
from africanus_tpu_torch.rime.fast_beam_cubes import (  # noqa: E402
    beam_cube_dde as cb_dde, beam_cube_dde_fr as cb_dde_fr,
)
from africanus_tpu_torch.rime.feeds import feed_rotation  # noqa: E402
from africanus_tpu_torch.rime.flagship import (  # noqa: E402
    flagship_inputs, from_numpy,
)
from africanus_tpu_torch.rime.fused import rime  # noqa: E402
from africanus_tpu_torch.rime.fused.inputs import (  # noqa: E402
    from_numpy as fused_from_numpy, fused_inputs, fused_oracle_f64,
)
from africanus_tpu_torch.rime.fused.core import MEMORY_SHARE, RimeFactory  # noqa: E402
from africanus_tpu_torch.testing.averaging import meerkat_inputs  # noqa: E402
from africanus_tpu_torch.testing.dde_reference import analytic_beam, dde_predict  # noqa: E402


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("S,R,F,C", [(37, 1000, 300, 4), (1, 9, 129, 2),
                                     (70, 17, 5, 1), (0, 8, 8, 4)])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("env", [True, False])
def test_kernel_matches_plain(device, S, R, F, C, compensated, env):
    rng = np.random.default_rng(S * 1000 + R + F)
    ops = kernel_problem(rng, S, R, F, C, compensated, env, device)
    before = cp.predict_kb.launches
    got = cp.predict_kb(*ops)
    torch.cuda.synchronize()
    assert cp.predict_kb.launches == before + 1
    want = cp.predict_kb_reference(*ops)
    assert got.shape == (R, F, C) and got.dtype == torch.complex64
    if S == 0:
        assert not got.abs().any()
        return
    bound = 2e-6 if compensated else 1e-5
    assert (got - want).abs().max() <= bound * want.abs().max()


@pytest.mark.cuda
def test_kernel_is_deterministic(device):
    ops = kernel_problem(np.random.default_rng(1), 40, 300, 200, 4, True, True,
                         device)
    a, b = cp.predict_kb(*ops), cp.predict_kb(*ops)
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("S,R,F", [(37, 1000, 300), (5, 70, 4093), (3, 33, 1),
                                   (9, 45, 250)])
@pytest.mark.parametrize("grid", ["exact", "residual", "direct"])
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("env", [True, False])
def test_predict_kernel_plan_modes_match_plain(device, S, R, F, grid, C,
                                               compensated, env):
    """Every phase mode of the predict plan (and the one-channel groups
    of a prime channel count, one channel, groups of 10) on the card."""
    rng = np.random.default_rng(S * 1000 + R + F + C)
    ops = kernel_problem(rng, S, R, F, C, compensated, env, device, grid)
    got = cp.predict_kb(*ops)
    want = cp.predict_kb_reference(*ops)
    assert got.shape == (R, F, C)
    bound = 2e-6 if compensated else 1e-5
    assert (got - want).abs().max() <= bound * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("S,far", FAR_PAIRS)
@pytest.mark.parametrize("C", [1, 2, 4])
def test_predict_kernel_pairs_beyond_the_delay_bound(device, S, far, C):
    """(source, row) pairs whose |delay| exceeds the plan's bound take the
    direct phase inside the kernel, beside pairs on the recurrence: in
    the first tile of sources, and in the second after a tile that is
    all on the recurrence."""
    ops = kernel_problem(np.random.default_rng(9), S, 256, 4096, C, True, True,
                         device, far=far)
    plan = cp.plan_for(ops[3])
    beyond = ops[0][0].abs() > plan.delay_max
    near = [s for s in range(S) if s not in far]
    assert plan.mode == "residual" and 0 < beyond.sum() < len(far) * 256
    assert not beyond[near].any()
    got, want = cp.predict_kb(*ops), cp.predict_kb_reference(*ops)
    assert (got - want).abs().max() <= 2e-6 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("grid,F,mode", DFT_FAR_CASES)
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_dft_kernels_pairs_beyond_the_delay_bound(device, grid, F, mode, C, convention):
    """Both DFT kernels on plans made at the measured delay bound / 1000:
    in the exact and residual modes a warp with a pair beyond it takes the
    direct phase. Warps all far, mixed and all near, against the plain
    versions and float64, and a rerun bitwise."""
    lm_s, lm_p, uvw, freq, img, vis = dft_far_problem(
        np.random.default_rng(10 * F + C), 24, 192, 384, F, C, grid, device)
    sign = 1.0 if convention == "fourier" else -1.0
    uvw64, f64 = uvw.double().cpu().numpy(), np.asarray(freq.cpu(), np.float64)
    for kind, lm, fn, plain, values, oracle in (
            ("forward", lm_s, cd.dft_forward, cd.dft_forward_reference, img,
             im_to_vis_oracle_f64(img.cpu().numpy(), sign * uvw64,
                                  lm_s.cpu().numpy(), f64)),
            ("adjoint", lm_p, cd.dft_adjoint, cd.dft_adjoint_reference, vis,
             vis_to_im_oracle_f64(vis.cpu().numpy(), -sign * uvw64,
                                  lm_p.cpu().numpy(), f64))):
        plan = far_plan(kind, lm, uvw, freq, C, convention)
        assert plan.mode == mode
        far, *votes = far_warps(plan, uvw)
        assert far > 0 and min(votes) > 0
        got = fn(plan, uvw, values)
        _assert_close(got, plain(plan, uvw, values))
        assert torch.equal(got, fn(plan, uvw, values))
        _assert_close(got.cpu(), torch.from_numpy(oracle))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 1000, 1e6])
@pytest.mark.parametrize("C", [1, 2, 4])
def test_dft_plan_of_shorter_baselines_on_card(device, k, C):
    """im_to_vis and vis_to_im on plans made on uvw / k (20 sources x 2000
    rows x 16 channels of a float32 linspace, uvw sigma 3 km): float64 on
    the same inputs within 3e-6 of max."""
    from africanus_tpu_torch.dft import dft_plan, im_to_vis, vis_to_im

    rng = np.random.default_rng(16)
    freq = np.linspace(0.856e9, 1.712e9, 16).astype(np.float32)
    lm = rng.uniform(-0.05, 0.05, (20, 2)).astype(np.float32)
    uvw = rng.normal(0.0, 3000.0, (2000, 3)).astype(np.float32)
    img = rng.normal(size=(20, 16, C)).astype(np.float32)
    vis = (rng.normal(size=(2000, 16, C))
           + 1j * rng.normal(size=(2000, 16, C))).astype(np.complex64)
    t_lm, t_uvw = (torch.as_tensor(x, device=device) for x in (lm, uvw))
    flags = torch.zeros(vis.shape, dtype=torch.bool, device=device)
    for adjoint in (False, True):
        plan = dft_plan(t_uvw / k, t_lm, freq, C, adjoint=adjoint)
        if adjoint:
            got = vis_to_im(torch.as_tensor(vis, device=device), t_uvw, t_lm,
                            freq, flags, plan=plan)
            want = vis_to_im_oracle_f64(vis, uvw, lm, freq)
        else:
            got = im_to_vis(torch.as_tensor(img, device=device), t_uvw, t_lm,
                            freq, plan=plan)
            want = im_to_vis_oracle_f64(img, uvw, lm, freq)
        _assert_close(got.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
def test_predict_kernel_refuses_a_plan_of_other_frequencies(device):
    """predict_kb with a plan of other frequencies raises on the card, as
    on the CPU; the plan's own freq_dev is taken unread."""
    ops = kernel_problem(np.random.default_rng(3), 4, 40, 64, 1, True, False, device)
    other = cp.plan_for(ops[3].cpu().numpy() + np.float32(1e6), device)
    with pytest.raises(ValueError, match="other frequencies"):
        cp.predict_kb(*ops, plan=other)
    plan = cp.plan_for(ops[3].cpu().numpy(), device)
    own = (*ops[:3], plan.freq_dev, *ops[4:])
    want = cp.predict_kb(*own, plan=plan)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cp.predict_kb(*own, plan=plan)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)
    assert torch.equal(cp.predict_kb(*ops, plan=plan), want)  # the keyed tensor


@pytest.mark.cuda
def test_predict_kernel_reruns_bitwise_at_the_flagship_chunk(device):
    args = flagship_inputs(nsrc=100, ntime=4, nant=64, nchan=4096, seed=2026)
    model, x = from_numpy(args, device)
    ops = model.kernel_operands(x[3], x[4])
    assert torch.equal(cp.predict_kb(*ops), cp.predict_kb(*ops))


@pytest.mark.cuda
def test_flagship_forward_does_not_sync(device):
    """The flagship forward never waits for the card: the frequencies'
    predict plan is made at the first call and kept (one warm-up call)."""
    args = flagship_inputs(nsrc=20, ntime=2, nant=16, nchan=96, seed=4)
    model, x = from_numpy(args, device)
    model(*x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model(*x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_predict_plan_for_keys_a_card_tensor_on_itself(device):
    freq = torch.as_tensor(np.linspace(0.856e9, 1.712e9, 256).astype(np.float32),
                           device=device)
    plan = cp.plan_for(freq)
    assert plan.ftab_dev.device == freq.device and cp.plan_for(freq) is plan
    freq.add_(1e6)  # an in-place change plans anew
    assert cp.plan_for(freq) is not plan


@pytest.mark.cuda
def test_im_to_vis_plans_the_predict_route_once(device, monkeypatch):
    """At >= 128 channels im_to_vis plans predict_kb from the caller's
    host frequencies, keyed on their values: a second call, with a new
    array of the same grid, plans nothing and never waits for the card
    (its operands on the card)."""
    from africanus_tpu_torch.dft import im_to_vis

    rng = np.random.default_rng(5)
    lm = torch.as_tensor(rng.uniform(-0.01, 0.01, (7, 2)).astype(np.float32),
                         device=device)
    uvw = torch.as_tensor(rng.uniform(-4000, 4000, (50, 3)).astype(np.float32),
                          device=device)
    image = torch.as_tensor(rng.normal(size=(7, 300, 2)).astype(np.float32),
                            device=device)
    freq = np.linspace(0.9e9, 1.6e9, 300).astype(np.float32)
    first = im_to_vis(image, uvw, lm, freq)

    def planned(*args, **kwargs):
        pytest.fail("im_to_vis planned the same grid again")

    monkeypatch.setattr(cp, "PredictPlan", planned)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = im_to_vis(image, uvw, lm, freq.copy())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_predict_kernel_refuses_a_plan_of_other_channels(device):
    ops = kernel_problem(np.random.default_rng(3), 4, 40, 64, 1, True, False, device)
    other = cp.plan_for(np.linspace(0.9e9, 1.6e9, 65).astype(np.float32), device)
    with pytest.raises(ValueError, match="65 channels"):
        cp.predict_kb(*ops, plan=other)


@pytest.mark.cuda
def test_flagship_on_card_matches_cpu(device):
    """The flagship on the card (kernel) against the same module on the
    CPU (plain version), same inputs."""
    args = flagship_inputs(nsrc=20, ntime=2, nant=16, nchan=96, seed=4)
    m_cpu, x_cpu = from_numpy(args, "cpu")
    m_gpu, x_gpu = from_numpy(args, device)
    want = m_cpu(*x_cpu)
    before = cp.predict_kb.launches
    got = m_gpu(*x_gpu)
    torch.cuda.synchronize()
    assert cp.predict_kb.launches == before + 1
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err <= 2e-6


def _assert_close(got, want, bound=3e-6):
    if want.numel() == 0 or not want.abs().any():
        assert not got.abs().any()
        return
    assert (got - want).abs().max() <= bound * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("S,P,R,F", [(37, 300, 1000, 12), (1, 5, 9, 1),
                                     (70, 129, 33, 16), (0, 3, 8, 4),
                                     (5, 4, 0, 4), (20, 200, 10, 16),
                                     (9, 77, 300, 17), (40, 300, 500, 64),
                                     (20, 4096, 38612, 16)])
@pytest.mark.parametrize("grid", ["exact", "residual", "direct"])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_dft_kernels_match_plain(device, S, P, R, F, grid, C, convention):
    """Both kernels against their plain versions, and a rerun bitwise, at
    the edges of the channel groups and tiles — one full group (F = 16),
    a ragged one (17), several (64); P not a multiple of the pixel tile,
    R under one row tile; C = 3 as 2 + 1 launches — and the config-5
    shape (4096 pixels or 20 sources, 38612 rows, 16 channels)."""
    rng = np.random.default_rng(S * 1000 + R + F + C)
    lm_s, lm_p, uvw, freq, img, vis = dft_problem(rng, S, P, R, F, C, grid,
                                                  device)
    fwd = cd.DftPlan("forward", lm_s, freq, C, convention)
    launches = len(fwd.parts) or 1
    for image in (img, img.real.contiguous()):
        before = cd.dft_forward.launches
        got = cd.dft_forward(fwd, uvw, image)
        torch.cuda.synchronize()
        assert cd.dft_forward.launches == before + launches * (S > 0 and R > 0)
        want = cd.dft_forward_reference(fwd, uvw, image)
        assert got.shape == (R, F, C) and got.dtype == torch.complex64
        _assert_close(got, want)
        assert torch.equal(got, cd.dft_forward(fwd, uvw, image))
    adj = cd.DftPlan("adjoint", lm_p, freq, C, convention)
    before = cd.dft_adjoint.launches
    got = cd.dft_adjoint(adj, uvw, vis)
    torch.cuda.synchronize()
    assert cd.dft_adjoint.launches == before + launches * (R > 0)
    want = cd.dft_adjoint_reference(adj, uvw, vis)
    assert got.shape == (P, F, C) and got.dtype == torch.float32
    _assert_close(got, want)
    assert torch.equal(got, cd.dft_adjoint(adj, uvw, vis))


@pytest.mark.cuda
def test_dft_kernels_are_deterministic(device):
    rng = np.random.default_rng(2)
    lm_s, lm_p, uvw, freq, img, vis = dft_problem(rng, 20, 2000, 5000, 16, 1,
                                                  "residual", device)
    adj = cd.DftPlan("adjoint", lm_p, freq, 1, "casa")
    fwd = cd.DftPlan("forward", lm_s, freq, 1, "fourier")
    assert torch.equal(cd.dft_adjoint(adj, uvw, vis),
                       cd.dft_adjoint(adj, uvw, vis))
    assert torch.equal(cd.dft_forward(fwd, uvw, img),
                       cd.dft_forward(fwd, uvw, img))


def _selfcal(device, unmodelled=False):
    args = selfcal_inputs(nant=8, ntime=2, nchan=8, nsrc=5, ncorr=2, seed=5)
    args.update(make_data(args, "cpu"))
    if unmodelled:  # the model lacks the last source
        four = dict(args, image=args["image"][:4], lm=args["lm"][:4])
        args["model"] = make_data(four, "cpu")["model"]
    return selfcal_from_numpy(args, device, npx=16)


def _max_err(got, want):
    return float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("unmodelled", [False, True],
                         ids=["converged", "unmodelled-source"])
def test_selfcal_on_card_matches_cpu(device, unmodelled):
    """SelfcalStep on the card (kernels) against the same module on the
    CPU (plain versions), same inputs, at the size of
    tests/test_torch_selfcal.py and with its bounds."""
    step_cpu, data_cpu = _selfcal("cpu", unmodelled)
    step_gpu, data_gpu = _selfcal(device, unmodelled)
    want = step_cpu(data_cpu)
    before = (cd.dft_forward.launches, cd.dft_adjoint.launches, ch.hogbom.launches)
    got = [x.cpu() for x in step_gpu(data_gpu)]
    assert (cd.dft_forward.launches, cd.dft_adjoint.launches,
            ch.hogbom.launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    gains, jhj, jhr, dirty, clean, res, re_model = got
    assert _max_err(gains, want[0]) <= 1e-5
    scale_jhj = float(want[1].abs().max())
    assert _max_err(jhj, want[1]) <= 1e-5 * scale_jhj
    images = list(zip((dirty, clean, res), want[3:6]))
    if unmodelled:
        assert float(want[3].abs().max()) >= 0.05  # the source is in the residual
        assert _max_err(jhr, want[2]) <= 1e-5 * float(want[2].abs().max())
        for g, w in images:
            assert _max_err(g, w) <= 1e-5 * float(w.abs().max())
    else:
        assert _max_err(jhr, want[2]) <= 1e-5 * scale_jhj
        scale = float(data_cpu.abs().sum()) / (data_cpu.shape[0]
                                               * data_cpu.shape[1])
        for g, w in images:
            assert _max_err(g, w) <= 1e-5 * scale
    assert bool((want[4] != 0).any())
    assert torch.equal(clean != 0, want[4] != 0)  # same components
    assert _max_err(re_model, want[6]) <= 3e-6 * float(want[6].abs().max())


@pytest.mark.cuda
def test_selfcal_step_does_not_sync(device):
    """The step never waits for the card: the Gauss-Newton loop and CLEAN
    run masked iterations, and the DFT tables go up through pinned
    memory (one warm-up step first, to build and load the kernels)."""
    step, data = _selfcal(device)
    step(data)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(data)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _clean_problem(npix, psf_kind, seed):
    """A dirty image of five sources on noise and its (2npix)² PSF, a
    delta or a gaussian peaking at (npix − 1, npix − 1)."""
    rng = np.random.default_rng(seed)
    if psf_kind == "delta":
        psf = np.zeros((2 * npix, 2 * npix))
        psf[npix - 1, npix - 1] = 1.0
    else:
        x = np.arange(2 * npix) - (npix - 1)
        psf = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2 * 1.5 ** 2))
    dirty = 0.05 * rng.standard_normal((npix, npix))
    for _ in range(5):
        p, q = rng.integers(0, npix, 2)
        dirty += rng.uniform(0.5, 2.0) * psf[npix - 1 - p:2 * npix - 1 - p,
                                             npix - 1 - q:2 * npix - 1 - q]
    return dirty, psf


def _clean_matches_plain(device, dirty, psf, dtype, gamma, frac, niter):
    """The kernel, launched once, against the plain loop on the card:
    clean image, residual and running flags equal value for value."""
    d = torch.as_tensor(dirty, dtype=dtype, device=device)
    p = torch.as_tensor(psf, dtype=dtype, device=device)
    before = ch.hogbom.launches
    got = ch.hogbom(d, p, gamma, frac, niter)
    assert ch.hogbom.launches == before + 1
    want = hogbom_clean_reference(d, p, gamma, frac, niter)
    torch.cuda.synchronize()
    assert tuple(got[2].shape) == (niter + 1,) and got[2].dtype == torch.bool
    for name, g, w in zip(("clean", "residual", "flags"), got, want):
        assert torch.equal(g, w), name
    return got


_CLEAN_DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                                        ids=["float32", "float64"])


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["8", "64", "65", "256", "past-one-block",
                                  "past-the-cluster"])
@pytest.mark.parametrize("psf_kind", ["delta", "gaussian"])
@_CLEAN_DTYPES
def test_hogbom_kernel_matches_plain_loop(device, size, psf_kind, dtype):
    itemsize = torch.empty((), dtype=dtype).element_size()
    if size == "past-one-block":
        npix = next(n for n in range(1, 2000) if ch.layout(n, itemsize)[0] > 1)
    elif size == "past-the-cluster":
        npix = next(n for n in range(1, 2000) if not ch.layout(n, itemsize)[2])
    else:
        npix = int(size)
    dirty, psf = _clean_problem(npix, psf_kind, seed=npix)
    clean, _, flags = _clean_matches_plain(device, dirty, psf, dtype, 0.1, 0.2, 50)
    assert bool(flags[0]) and bool((clean != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("npix", [64, 256], ids=["one-block", "cluster"])
@_CLEAN_DTYPES
def test_hogbom_kernel_ties_take_the_lowest_index(device, npix, dtype):
    """Equal peaks in different rows (at 256², in different blocks of the
    cluster): the lowest flat index first, as torch.argmax."""
    psf = np.zeros((2 * npix, 2 * npix))
    psf[npix - 1, npix - 1] = 1.0
    dirty = np.zeros((npix, npix))
    peaks = [(npix - 1, 3), (npix // 2, 7), (npix // 2, 6), (3, npix - 5)]
    for p, q in peaks:
        dirty[p, q] = 5.0
    clean, _, _ = _clean_matches_plain(device, dirty, psf, dtype, 0.5, 0.0, 20)
    taken = torch.nonzero(clean.reshape(-1)).flatten().tolist()
    assert taken == sorted(p * npix + q for p, q in peaks)


@pytest.mark.cuda
@_CLEAN_DTYPES
def test_hogbom_kernel_signed_peak_exit_and_niter_zero(device, dtype):
    """A negative pixel deeper than the brightest is never taken; a high
    threshold stops the loop after a few components (the flags then end
    false); niter 0 takes one component."""
    dirty, psf = _clean_problem(48, "gaussian", seed=3)
    dirty[5, 9] = -4 * np.abs(dirty).max()
    clean, _, _ = _clean_matches_plain(device, dirty, psf, dtype, 0.5, 0.2, 30)
    assert float(clean[5, 9]) == 0.0
    _, _, flags = _clean_matches_plain(device, dirty, psf, dtype, 0.5, 0.6, 30)
    ntaken = int(flags.sum())
    assert 0 < ntaken < 31 and bool(flags[:ntaken].all())
    clean, _, flags = _clean_matches_plain(device, dirty, psf, dtype, 0.1, 0.2, 0)
    assert flags.tolist() == [True] and int((clean != 0).sum()) == 1


@pytest.mark.cuda
def test_hogbom_clean_on_card_launches_the_kernel_once(device):
    """hogbom_clean on CUDA tensors: one launch a call, the plain loop's
    images."""
    dirty, psf = _clean_problem(64, "gaussian", seed=1)
    d = torch.as_tensor(dirty, dtype=torch.float32, device=device)
    p = torch.as_tensor(psf, dtype=torch.float32, device=device)
    for _ in range(3):
        before = ch.hogbom.launches
        got = hogbom_clean(d, p, gamma=0.1, threshold=0.2, niter=50)
        assert ch.hogbom.launches == before + 1
    want = hogbom_clean_reference(d, p, 0.1, 0.2, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("support", [4, 6, 8, 10])
@pytest.mark.parametrize("stack", [False, True], ids=["one-plane", "stack"])
@pytest.mark.parametrize("nu,nv,n", [(64, 64, 1007), (70, 45, 333), (12, 10, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_wgrid_kernels_match_plain(device, support, stack, nu, nv, n, dtype):
    nplanes = support + 6 if stack else 1
    rng = np.random.default_rng(support * 1000 + n)
    plan, vis, grid = wgrid_problem(rng, n, nu, nv, nplanes, support, dtype,
                                    device)
    before = (cw.grid_wstack.launches, cw.degrid_wstack.launches)
    got_g = cw.grid_wstack(plan, vis)
    got_d = cw.degrid_wstack(plan, grid)
    torch.cuda.synchronize()
    assert (cw.grid_wstack.launches, cw.degrid_wstack.launches) == (
        before[0] + 1, before[1] + 1)
    assert got_g.shape == (nplanes, nu, nv) and got_d.shape == (n,)
    assert got_g.dtype == got_d.dtype == plan.complex_dtype
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    _assert_close(got_g, cw.grid_wstack_reference(plan, vis), bound)
    _assert_close(got_d, cw.degrid_wstack_reference(plan, grid), bound)


@pytest.mark.cuda
def test_wgrid_kernels_no_samples(device):
    plan, vis, grid = wgrid_problem(np.random.default_rng(0), 0, 40, 40, 12,
                                    6, torch.float32, device)
    assert not cw.grid_wstack(plan, vis).abs().any()
    assert cw.degrid_wstack(plan, grid).shape == (0,)


@pytest.mark.cuda
def test_wgrid_kernels_are_deterministic(device):
    plan, vis, grid = wgrid_problem(np.random.default_rng(9), 50_000, 512, 512,
                                    9, 6, torch.float32, device)
    assert torch.equal(cw.grid_wstack(plan, vis), cw.grid_wstack(plan, vis))
    assert torch.equal(cw.degrid_wstack(plan, grid), cw.degrid_wstack(plan, grid))


@pytest.mark.cuda
@pytest.mark.parametrize("support,nplanes,dtype", [(10, 60, torch.float64),
                                                   (8, 54, torch.float32),
                                                   (10, 16, torch.float64)])
def test_degrid_wstack_in_blocks_of_planes(device, support, nplanes, dtype):
    """A stack whose planes the degrid kernel stages in blocks (a gather
    order of its own): one launch, the plain version's values, bitwise
    equal launches."""
    rng = np.random.default_rng(nplanes)
    plan, _, grid = wgrid_problem(rng, 3000, 64, 64, nplanes, support, dtype, device,
                                  edges=True)
    assert plan.stack_block < nplanes and plan.stack_pos.numel() == 3000
    got = _launched(cw.degrid_wstack, plan, grid)
    _assert_close(got, cw.degrid_wstack_reference(plan, grid),
                  1e-5 if dtype == torch.float32 else 1e-12)
    assert torch.equal(got, cw.degrid_wstack(plan, grid))


@pytest.mark.cuda
def test_plans_default_to_the_card(device):
    """The plan builders hold their plans on the current card unless asked
    for the CPU, and make_plan keys "cuda" and "cuda:<index>" as one."""
    from africanus_tpu_torch.gridding.wgridder import make_plan

    args = imaging_inputs(nrow=500, nchan=2, nx=32, seed=3)
    here = torch.device("cuda", torch.cuda.current_device())
    a = make_plan(args["uvw"], args["freq"], 32, 32, args["cell"], args["cell"], 1e-4)
    assert a.wgrid.device == here
    assert make_plan(args["uvw"], args["freq"], 32, 32, args["cell"], args["cell"],
                     1e-4, device=f"cuda:{here.index}") is a
    plan, _, _, _ = table_problem(np.random.default_rng(1), 50, 32, 2, 7, 63,
                                  torch.float32, "cuda")
    assert plan.device == here


@pytest.mark.cuda
@pytest.mark.parametrize("wstack", [True, False])
def test_wstack_imaging_on_card_matches_cpu(device, wstack):
    """WStackImaging on the card (kernels) against the same module on the
    CPU (plain versions), same inputs."""
    args = imaging_inputs(nrow=3000, nchan=4, nx=64, seed=4)
    m_cpu, vis_cpu, img_cpu = imaging_from_numpy(args, "cpu", do_wstacking=wstack)
    m_gpu, vis_gpu, img_gpu = imaging_from_numpy(args, device, do_wstacking=wstack)
    before = (cw.grid_wstack.launches, cw.degrid_wstack.launches)
    d = m_gpu(vis_gpu)
    mv = m_gpu.degrid(img_gpu)
    torch.cuda.synchronize()
    assert (cw.grid_wstack.launches, cw.degrid_wstack.launches) == (
        before[0] + 1, before[1] + 1)
    _assert_close(d.cpu(), m_cpu(vis_cpu), 1e-5)
    _assert_close(mv.cpu(), m_cpu.degrid(img_cpu), 1e-5)


@pytest.mark.cuda
def test_wgridder_api_on_card_matches_cpu(device):
    """dirty (float64 accumulation) and model (float32) through the API,
    on the card against the CPU."""
    args = imaging_inputs(nrow=2000, nchan=4, nx=48, seed=6)
    uvw, freq, cell = args["uvw"], args["freq"], args["cell"]
    bands = (np.array([0, 2]), np.array([2, 2]))
    vis = torch.as_tensor(args["vis"])
    want = dirty(uvw, freq, vis, *bands, 48, 48, cell, epsilon=1e-6,
                 double_accum=True)
    got = dirty(uvw, freq, vis.to(device), *bands, 48, 48, cell, epsilon=1e-6,
                double_accum=True)
    assert got.dtype == torch.float64 and got.device.type == "cuda"
    _assert_close(got.cpu(), want, 1e-12)
    image = torch.as_tensor(np.stack([args["image"][:48, :48]] * 2))
    want = model(uvw, freq, image, *bands, cell, epsilon=1e-4)
    got = model(uvw, freq, image.to(device), *bands, cell, epsilon=1e-4)
    assert got.dtype == torch.complex64
    _assert_close(got.cpu(), want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [4, 5])
def test_wgridder_blocks_of_planes_on_card(device, planes, monkeypatch):
    """The residual with its w-stack in blocks of ``planes`` planes (the
    free memory the plan reads cut to hold no more) on the card: against
    the same problem as one block on the card 1e-6·max (a straddling
    sample's parts summed in another order), a launch of each kernel a
    block, and two blocked runs bitwise equal."""
    from africanus_tpu_torch.gridding.wgridder import core, residual
    from africanus_tpu_torch.utils.plancache import LRUCache

    args = imaging_inputs(nrow=2000, nchan=4, nx=64, seed=8, w_div=0.1)
    uvw, freq, cell = args["uvw"], args["freq"], args["cell"]
    image = torch.as_tensor(args["image"][None]).to(device)
    vis = torch.as_tensor(args["vis"]).to(device)

    def run(free):
        monkeypatch.setattr(core, "_MAKE_PLAN_CACHE", LRUCache(4))
        plan = core.make_plan(uvw, freq, 64, 64, cell, cell, 1e-5, device=device)
        per = core.block_bytes(plan, 1) - core.block_bytes(plan, 0)
        budget = 1e15 if free is None else (
            core.block_bytes(plan, free) + per / 2) / core.MEMORY_SHARE
        if free is not None:
            plan.screen.stack = None  # as a plan built at that free memory
        monkeypatch.setattr(core, "free_bytes", lambda d: budget)
        before = (cw.grid_wstack.launches, cw.degrid_wstack.launches)
        out = residual(uvw, freq, image, vis, [0], [4], cell, epsilon=1e-5)
        torch.cuda.synchronize()
        blocks = 1 if plan.layout is None else len(plan.layout)
        assert (cw.grid_wstack.launches, cw.degrid_wstack.launches) == (
            before[0] + blocks, before[1] + blocks)
        return out, blocks, plan

    whole, one, _ = run(None)
    got, blocks, plan = run(planes)
    assert one == 1 and blocks > 2 and plan.nplanes > 2 * planes
    _assert_close(got.cpu(), whole.cpu(), 1e-6)
    again = residual(uvw, freq, image, vis, [0], [4], cell, epsilon=1e-5)
    assert torch.equal(again, got)


def _launched(fn, *args):
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ncorr", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("nsamp,nchan", [(1000, 300), (37, 5)])
def test_beam_kernels_match_plain(device, ncorr, dtype, nsamp, nchan):
    """Phase 13's grid: interp normalised, raw and on shared coordinate
    columns; blend and blend_cell without a feed and, at C = 4, with
    linear and circular feeds; frequencies outside the cube."""
    p = beam_problem(np.random.default_rng(ncorr * 100 + nsamp), nsamp, nchan,
                     ncorr, dtype, device)
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    slabs, nud = p["slabs"], p["slabs"].shape[0]
    for norm in (True, False):
        args = (slabs, p["vl"], p["vm"], p["gc0"], p["gc1"], p["wlo"], norm)
        got = _launched(cb.beam_interp, *args)
        assert got.shape == (nsamp, nchan, ncorr if norm else 3 * ncorr)
        _assert_close(got, cb.beam_interp_reference(*args), bound)
    for ncol in (1, 4):
        rows = torch.arange(nud, dtype=torch.int32, device=device).repeat(ncol)
        args = (slabs, p["vl"][:, :ncol].contiguous(), p["vm"][:, :ncol].contiguous(),
                rows, rows, torch.ones(rows.shape[0], dtype=dtype, device=device),
                False)
        _assert_close(_launched(cb.beam_interp, *args),
                      cb.beam_interp_reference(*args), bound)
    feeds = [None] + ([feed_rotation(p["pa"], ft).contiguous()
                       for ft in ("linear", "circular")] if ncorr == 4 else [])
    for feed in feeds:
        args = (p["raw"], p["gc0"], p["wlo"], feed)
        got = _launched(cb.beam_blend, *args)
        assert got.shape == (nsamp, nchan, ncorr) and got.dtype == slabs.dtype.to_complex()
        _assert_close(got, cb.beam_blend_reference(*args), bound)
        args = (p["bt"], p["lda"], p["mda"], p["gc0"], p["wlo"], feed)
        _assert_close(_launched(cb.beam_blend_cell, *args),
                      cb.beam_blend_cell_reference(*args), bound)


@pytest.mark.cuda
@pytest.mark.parametrize("ncorr", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_beam_kernels_split_correlations(device, ncorr, dtype):
    """Counts csrc/beam.cu is not instantiated for launch each kernel per
    group (3 = 2 + 1, 8 = 4 + 4: two launches), against the plain
    versions on the whole axis."""
    p = beam_problem(np.random.default_rng(ncorr), 300, 70, ncorr, dtype, device)
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    for fn, plain, args in (
            (cb.beam_interp, cb.beam_interp_reference,
             (p["slabs"], p["vl"], p["vm"], p["gc0"], p["gc1"], p["wlo"], True)),
            (cb.beam_interp, cb.beam_interp_reference,
             (p["slabs"], p["vl"], p["vm"], p["gc0"], p["gc1"], p["wlo"], False)),
            (cb.beam_blend, cb.beam_blend_reference, (p["raw"], p["gc0"], p["wlo"])),
            (cb.beam_blend_cell, cb.beam_blend_cell_reference,
             (p["bt"], p["lda"], p["mda"], p["gc0"], p["wlo"]))):
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        want = plain(*args)
        assert got.shape == want.shape and got.dtype == want.dtype
        _assert_close(got, want, bound)
        assert torch.equal(fn(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_beam_interp_corners_are_exact(device, dtype):
    rng = np.random.default_rng(3)
    p = beam_problem(rng, 8, 2, 4, dtype, device)
    slabs, nud = p["slabs"], p["slabs"].shape[0]
    li = torch.as_tensor(rng.integers(0, 17, 300), device=device)
    mi = torch.as_tensor(rng.integers(0, 13, 300), device=device)
    rows = torch.arange(nud, dtype=torch.int32, device=device)
    raw = cb.beam_interp(slabs, li[:, None].to(dtype), mi[:, None].to(dtype), rows,
                         rows, torch.ones(nud, dtype=dtype, device=device), False)
    assert torch.equal(raw, slabs.permute(1, 2, 0, 3)[li, mi])


def _interp_operands(p, layout, normalize, device):
    """beam_interp's operands on one of its three layouts: the general
    route (a coordinate column per channel), the channel-invariant route
    (one column, a row per slab) and the cell corners (four columns, a
    row per slab)."""
    slabs, nud = p["slabs"], p["slabs"].shape[0]
    if layout == "general":
        return (slabs, p["vl"], p["vm"], p["gc0"], p["gc1"], p["wlo"], normalize)
    ncol = 1 if layout == "chan_invariant" else 4
    rows = torch.arange(nud, dtype=torch.int32, device=device).repeat(ncol)
    return (slabs, p["vl"][:, :ncol].contiguous(), p["vm"][:, :ncol].contiguous(),
            rows, rows, torch.ones(rows.shape[0], dtype=slabs.dtype, device=device),
            normalize)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["general", "chan_invariant", "cell_corners"])
@pytest.mark.parametrize("ncorr", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_beam_interp_layouts_match_plain(device, layout, ncorr, dtype):
    """beam_interp on each of its layouts against the plain version, at
    ragged shapes (515 samples: not a multiple of a sample group; 257
    channels: one past a row tile; one channel), normalised and raw, and
    two launches bitwise equal."""
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    ngroups = len(cb._groups(ncorr))
    for nsamp, nchan in ((515, 257), (3, 1)):
        p = beam_problem(np.random.default_rng(nsamp + ncorr), nsamp, nchan, ncorr,
                         dtype, device)
        for normalize in (True, False):
            args = _interp_operands(p, layout, normalize, device)
            before = cb.beam_interp.launches
            got = cb.beam_interp(*args)
            torch.cuda.synchronize()
            assert cb.beam_interp.launches == before + ngroups
            want = cb.beam_interp_reference(*args)
            assert got.shape == want.shape and got.dtype == want.dtype
            _assert_close(got, want, bound)
            assert torch.equal(cb.beam_interp(*args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_beam_interp_cell_corner_layout_is_exact(device, dtype):
    """Integer coordinates on the cell-corner layout (four columns, a row
    per slab) give the corner values bit for bit, |v| lanes included."""
    rng = np.random.default_rng(5)
    p = beam_problem(rng, 8, 4, 4, dtype, device)
    slabs, nud = p["slabs"], p["slabs"].shape[0]
    li = torch.as_tensor(rng.integers(0, 17, (300, 4)), device=device)
    mi = torch.as_tensor(rng.integers(0, 13, (300, 4)), device=device)
    rows = torch.arange(nud, dtype=torch.int32, device=device).repeat(4)
    raw = cb.beam_interp(slabs, li.to(dtype), mi.to(dtype), rows, rows,
                         torch.ones(4 * nud, dtype=dtype, device=device), False)
    want = slabs.permute(1, 2, 0, 3)[li.repeat_interleave(nud, 1),
                                     mi.repeat_interleave(nud, 1), rows]
    assert torch.equal(raw, want)


@pytest.mark.cuda
def test_beam_kernels_are_deterministic(device):
    p = beam_problem(np.random.default_rng(4), 256, 2048, 4, torch.float32, device,
                     lw=129, mh=129)
    feed = feed_rotation(p["pa"], "circular").contiguous()
    for fn, args in ((cb.beam_interp, (p["slabs"], p["vl"], p["vm"], p["gc0"],
                                       p["gc1"], p["wlo"], True)),
                     (cb.beam_blend, (p["raw"], p["gc0"], p["wlo"], feed)),
                     (cb.beam_blend_cell, (p["bt"], p["lda"], p["mda"], p["gc0"],
                                           p["wlo"], feed))):
        assert torch.equal(fn(*args), fn(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("leg,pe,flags,launches", [
    ("fast", "pe", dict(chan_invariant=True), (1, 1, 0)),
    ("time_varying", "pe_tvar", dict(feed_type=None, chan_invariant=True), (1, 1, 0)),
    ("general", "pe_pc", dict(feed_type=None, chan_invariant=False,
                              cell_residual=False), (1, 0, 0)),
    ("general_feed", "pe_pc", dict(chan_invariant=False, cell_residual=False),
     (1, 0, 0)),
    ("cell", "pe_pc", dict(chan_invariant=False, cell_residual=True), (1, 0, 1)),
])
def test_beam_chain_on_card_matches_cpu(device, leg, pe, flags, launches):
    """Each config-3 leg (8 antennas, 256 channels) on the card (kernels)
    against the same module on the CPU (plain versions), and the kernels
    each route launches."""
    args = beam_inputs(nant=8, nchan=256)
    args = dict(args, pe=args[pe])
    m_cpu, pa_cpu = beam_from_numpy(args, "cpu", **flags)
    m_gpu, pa_gpu = beam_from_numpy(args, device, **flags)
    want = m_cpu(pa_cpu)
    before = (cb.beam_interp.launches, cb.beam_blend.launches,
              cb.beam_blend_cell.launches)
    got = m_gpu(pa_gpu)
    torch.cuda.synchronize()
    after = (cb.beam_interp.launches, cb.beam_blend.launches,
             cb.beam_blend_cell.launches)
    assert tuple(a - b for a, b in zip(after, before)) == launches
    assert got.shape == want.shape == (8, 1, 8, 256, 2, 2)
    _assert_close(got.cpu(), want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("feed_type", [None, "linear", "circular"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["c64", "c128"])
def test_beam_cube_dde_out_of_cube_on_card_matches_cpu(device, feed_type, dtype):
    """beam_cube_dde(_fr) on the general route with per-channel pointing
    errors and frequencies below and above the cube (scaled lm), on the
    card against the CPU."""
    rng = np.random.default_rng(8)
    nsrc, ntime, nant, nchan = 3, 2, 3, 7
    beam = torch.as_tensor(rng.normal(size=(10, 10, 8, 2, 2))
                           + 1j * rng.normal(size=(10, 10, 8, 2, 2))).to(dtype)
    rest = [torch.as_tensor(x) for x in (
        np.array([[-0.02, 0.02], [-0.02, 0.02]]), np.linspace(0.9e9, 1.6e9, 8),
        rng.uniform(-0.015, 0.015, (nsrc, 2)), rng.uniform(-np.pi, np.pi, (ntime, nant)),
        rng.normal(scale=5e-3, size=(ntime, nant, nchan, 2)),
        rng.uniform(0.9, 1.1, (nant, nchan, 2)), np.linspace(0.5e9, 2.2e9, nchan))]

    def run(dev):
        args = (beam.to(dev), *rest)
        if feed_type is None:
            return cb_dde(*args)
        return cb_dde_fr(*args, feed_type=feed_type)

    want = run("cpu")
    before = cb.beam_interp.launches
    got = run(device)
    torch.cuda.synchronize()
    assert cb.beam_interp.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape == (nsrc, ntime, nant, nchan, 2, 2)
    _assert_close(got.cpu(), want, 1e-5 if dtype == torch.complex64 else 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("support", [4, 6, 8, 10])
@pytest.mark.parametrize("ncorr", [1, 2, 4])
@pytest.mark.parametrize("nu,nv,n", [(64, 64, 1007), (70, 45, 333), (12, 10, 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_grid2d_kernels_match_plain(device, support, ncorr, nu, nv, n, dtype):
    rng = np.random.default_rng(support * 1000 + 10 * ncorr + n)
    plan, vis, grid = grid2d_problem(rng, n, nu, nv, ncorr, support, dtype, device)
    before = (g2.grid_2d.launches, g2.degrid_2d.launches)
    got_g = g2.grid_2d(plan, vis)
    got_d = g2.degrid_2d(plan, grid)
    torch.cuda.synchronize()
    assert (g2.grid_2d.launches, g2.degrid_2d.launches) == (before[0] + 1,
                                                            before[1] + 1)
    assert got_g.shape == (ncorr, nu, nv) and got_d.shape == (ncorr, n)
    assert got_g.dtype == got_d.dtype == plan.complex_dtype
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    _assert_close(got_g, g2.grid_2d_reference(plan, vis), bound)
    _assert_close(got_d, g2.degrid_2d_reference(plan, grid), bound)
    # a contiguous (ncorr, N) operand reads the same as the transposed one
    _assert_close(g2.grid_2d(plan, vis.contiguous()), got_g, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("support", [3, 5, 7, 15])
@pytest.mark.parametrize("oversample", [5, 63])
@pytest.mark.parametrize("npix,n", [(64, 1007), (37, 333), (5, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gridtab_kernels_match_plain(device, support, oversample, npix, n, dtype):
    rng = np.random.default_rng(support * 1000 + oversample + n)
    plan, table, vals, grid = table_problem(rng, n, npix, 2, support, oversample,
                                            dtype, device)
    before = (gt.grid_table.launches, gt.degrid_table.launches)
    got_g = gt.grid_table(plan, table, vals)
    got_d = gt.degrid_table(plan, table, grid)
    torch.cuda.synchronize()
    assert (gt.grid_table.launches, gt.degrid_table.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    assert got_g.shape == (2, npix, npix) and got_d.shape == (n,)
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    _assert_close(got_g, gt.grid_table_reference(plan, table, vals), bound)
    _assert_close(got_d, gt.degrid_table_reference(plan, table, grid), bound)


@pytest.mark.cuda
@pytest.mark.parametrize("support", [29, 31])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_degrid_table_wide_windows(device, support, dtype):
    """Supports whose gather forms its taps' positions per step: one
    launch, the plain version's values, bitwise equal launches."""
    rng = np.random.default_rng(support)
    plan, table, _, grid = table_problem(rng, 2000, 96, 2, support, 63, dtype, device)
    got = _launched(gt.degrid_table, plan, table, grid)
    _assert_close(got, gt.degrid_table_reference(plan, table, grid),
                  1e-5 if dtype == torch.float32 else 1e-12)
    assert torch.equal(got, gt.degrid_table(plan, table, grid))


@pytest.mark.cuda
def test_degrid_table_empty_plans(device):
    """No samples, or none with a tap in the grid: zeros, no launch."""
    for ir0 in ([], [-40, 100]):
        n = len(ir0)
        plan = gt.TableGridPlan(ir0, ir0, [0] * n, [0] * n, [0] * n, 32, 1, 7, 63,
                                device=device)
        assert plan.nkeep == 0 and plan.ngather == 0
        table = torch.ones(plan.ntab, device=device)
        grid = torch.ones((1, 32, 32), dtype=torch.complex64, device=device)
        before = gt.degrid_table.launches
        out = gt.degrid_table(plan, table, grid)
        assert gt.degrid_table.launches == before and out.shape == (n,)
        assert not out.abs().any()


@pytest.mark.cuda
def test_gridder_kernels_are_deterministic(device):
    rng = np.random.default_rng(12)
    plan, vis, grid = grid2d_problem(rng, 50_000, 512, 512, 4, 8, torch.float32,
                                     device)
    assert torch.equal(g2.grid_2d(plan, vis), g2.grid_2d(plan, vis))
    assert torch.equal(g2.degrid_2d(plan, grid), g2.degrid_2d(plan, grid))
    plan, table, vals, grid = table_problem(rng, 50_000, 512, 2, 7, 63,
                                            torch.float32, device)
    assert torch.equal(gt.grid_table(plan, table, vals),
                       gt.grid_table(plan, table, vals))
    assert torch.equal(gt.degrid_table(plan, table, grid),
                       gt.degrid_table(plan, table, grid))


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_nifty_on_card_matches_cpu(device, cdtype):
    args = imaging_inputs(nrow=3000, nchan=4, nx=64, seed=4)
    rng = np.random.default_rng(3)
    vis = (rng.normal(size=(3000, 4, 4)) + 1j * rng.normal(size=(3000, 4, 4))
           ).astype(cdtype)
    flags = (rng.uniform(size=vis.shape) < 0.1).astype(np.uint8)
    image = rng.normal(size=(64, 64, 4)).astype(np.real(vis).dtype)
    cell_as = np.rad2deg(args["cell"]) * 3600
    gc = nifty.grid_config(64, 64, 1e-5, cell_as, cell_as)
    uvw, freq = args["uvw"], args["freq"]

    def run(dev):
        g = nifty.grid(torch.as_tensor(vis, device=dev), uvw, flags, None, freq, gc)
        return (g, nifty.dirty(g, gc),
                nifty.degrid(nifty.model(torch.as_tensor(image, device=dev), gc),
                             uvw, flags, None, freq, gc))

    before = (g2.grid_2d.launches, g2.degrid_2d.launches)
    got = run(device)
    torch.cuda.synchronize()
    assert (g2.grid_2d.launches, g2.degrid_2d.launches) == (before[0] + 1,
                                                            before[1] + 1)
    bound = 1e-5 if cdtype == np.complex64 else 1e-12
    for g, w in zip(got, run("cpu")):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_close(g.cpu(), w, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("cdtype", [np.complex64, np.complex128], ids=["c64", "c128"])
def test_pp_gridder_on_card_matches_cpu(device, cdtype):
    args = imaging_inputs(nrow=3000, nchan=4, nx=128, seed=4)
    uvw = args["uvw"].astype(np.float64)
    wl = 2.99792458e8 / args["freq"].astype(np.float64)
    chanmap = np.array([0, 0, 1, 1])
    cell_as = np.rad2deg(args["cell"]) * 3600
    centres = ((0.0, -0.5 + 0.01), (0.0, -0.5))
    kern = pp.kernels.pack_kernel(pp.kernels.kbsinc(7, oversample=63), 7, 63)
    rng = np.random.default_rng(4)
    vis = (rng.normal(size=(3000, 4, 2)) + 1j * rng.normal(size=(3000, 4, 2))
           ).astype(cdtype)

    def run(dev):
        g = pp.gridder(uvw, torch.as_tensor(vis, device=dev), wl, chanmap, 128,
                       cell_as, *centres, kern, 7, 63, "rotate", "phase_rotate",
                       "I_FROM_XXYY", "conv_1d_axisymmetric_packed_scatter",
                       do_normalize=True)
        return g, pp.degridder(uvw, g, wl, chanmap, cell_as, *centres, kern, 7, 63,
                               "rotate", "phase_rotate", "XXYY_FROM_I",
                               "conv_1d_axisymmetric_packed_gather")

    before = (gt.grid_table.launches, gt.degrid_table.launches)
    got = run(device)
    torch.cuda.synchronize()
    assert (gt.grid_table.launches, gt.degrid_table.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    bound = 1e-5 if cdtype == np.complex64 else 1e-12
    for g, w in zip(got, run("cpu")):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_close(g.cpu(), w, bound)


# ------------------------------------------------------------ F1 and the
# tile spread's plan on the card

@pytest.mark.cuda
@pytest.mark.parametrize("support", [4, 6, 8, 10])
@pytest.mark.parametrize("stack", [False, True], ids=["one-plane", "stack"])
@pytest.mark.parametrize("nu,nv,n", [(5, 7, 40), (97, 64, 3000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_wgrid_spread_over_tile_edges(device, support, stack, nu, nv, n, dtype):
    """Windows over the grid kernel's tile corners and in a tile's last
    cells, and a grid narrower than the window: the tile spread against
    the plain version, and bitwise-equal launches."""
    nplanes = support + 6 if stack else 1
    rng = np.random.default_rng(support * 100 + n + nplanes)
    plan, vis, _ = wgrid_problem(rng, n, nu, nv, nplanes, support, dtype, device,
                                 edges=True)
    got = cw.grid_wstack(plan, vis)
    _assert_close(got, cw.grid_wstack_reference(plan, vis),
                  1e-5 if dtype == torch.float32 else 1e-12)
    assert torch.equal(got, cw.grid_wstack(plan, vis))


@pytest.mark.cuda
@pytest.mark.parametrize("ncorr,grid_launches,degrid_launches",
                         [(3, 1, 2), (5, 2, 2), (7, 2, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_grid2d_kernels_split_correlations(device, ncorr, grid_launches,
                                           degrid_launches, dtype):
    """Correlation counts the kernels do not take in one launch are split
    into groups they take (grid ≤ 4, degrid 4/2/1), one launch each."""
    rng = np.random.default_rng(ncorr)
    plan, vis, grid = grid2d_problem(rng, 1007, 70, 45, ncorr, 8, dtype, device,
                                     edges=True)
    before = (g2.grid_2d.launches, g2.degrid_2d.launches)
    got_g = g2.grid_2d(plan, vis)
    got_d = g2.degrid_2d(plan, grid)
    torch.cuda.synchronize()
    assert (g2.grid_2d.launches - before[0], g2.degrid_2d.launches - before[1]) == (
        grid_launches, degrid_launches)
    assert got_g.shape == (ncorr, 70, 45) and got_d.shape == (ncorr, 1007)
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    _assert_close(got_g, g2.grid_2d_reference(plan, vis), bound)
    _assert_close(got_d, g2.degrid_2d_reference(plan, grid), bound)


@pytest.mark.cuda
def test_dft_and_predict_split_three_correlations(device):
    rng = np.random.default_rng(33)
    lm_s, lm_p, uvw, freq, img, vis = dft_problem(rng, 37, 300, 1000, 12, 3,
                                                  "residual", device)
    fwd = cd.DftPlan("forward", lm_s, freq, 3, "fourier")
    adj = cd.DftPlan("adjoint", lm_p, freq, 3, "casa")
    ops = kernel_problem(rng, 37, 1000, 300, 3, True, True, device)
    before = (cd.dft_forward.launches, cd.dft_adjoint.launches, cp.predict_kb.launches)
    got = (cd.dft_forward(fwd, uvw, img), cd.dft_adjoint(adj, uvw, vis),
           cp.predict_kb(*ops))
    torch.cuda.synchronize()
    assert (cd.dft_forward.launches, cd.dft_adjoint.launches,
            cp.predict_kb.launches) == tuple(b + 2 for b in before)
    want = (cd.dft_forward_reference(fwd, uvw, img),
            cd.dft_adjoint_reference(adj, uvw, vis), cp.predict_kb_reference(*ops))
    for g, w, bound in zip(got, want, (3e-6, 3e-6, 2e-6)):
        assert g.shape == w.shape
        _assert_close(g, w, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("support", [17, 21, 23, 29, 31])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_gridtab_kernels_wide_supports(device, support, dtype):
    rng = np.random.default_rng(support)
    plan, table, vals, grid = table_problem(rng, 1007, 64, 2, support, 63, dtype,
                                            device)
    before = (gt.grid_table.launches, gt.degrid_table.launches)
    got_g = gt.grid_table(plan, table, vals)
    got_d = gt.degrid_table(plan, table, grid)
    torch.cuda.synchronize()
    assert (gt.grid_table.launches, gt.degrid_table.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    _assert_close(got_g, gt.grid_table_reference(plan, table, vals), bound)
    _assert_close(got_d, gt.degrid_table_reference(plan, table, grid), bound)
    # one, two or three residues a consumer: launches bitwise equal
    assert torch.equal(gt.grid_table(plan, table, vals), got_g)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_degrid_2d_gathers_listed_tiles_only(device, dtype):
    """Samples in a few tiles of a wide grid, some in a tile's last cells
    and at the grid's far edges (windows wrapping): the tile gather
    launches on the tiles that have samples only."""
    rng = np.random.default_rng(7)
    plan, _, grid = grid2d_problem(rng, 12, 300, 260, 4, 8, dtype, device,
                                   edges=True)
    assert 0 < plan.ngather < plan.ntiles
    before = g2.degrid_2d.launches
    got = g2.degrid_2d(plan, grid)
    torch.cuda.synchronize()
    assert g2.degrid_2d.launches == before + 1
    bound = 1e-5 if dtype == torch.float32 else 1e-12
    _assert_close(got, g2.degrid_2d_reference(plan, grid), bound)
    assert torch.equal(g2.degrid_2d(plan, grid), got)


@pytest.mark.cuda
def test_gridtab_kernels_table_in_device_memory(device):
    """complex128 at W = 15, oversampling 1023: a 139 KB table that both
    kernels read from device memory instead of staging it."""
    rng = np.random.default_rng(1023)
    plan, table, vals, grid = table_problem(rng, 1007, 64, 2, 15, 1023,
                                            torch.float64, device)
    assert gt._spread_table_smem(plan) == 0
    _assert_close(gt.grid_table(plan, table, vals),
                  gt.grid_table_reference(plan, table, vals), 1e-12)
    _assert_close(gt.degrid_table(plan, table, grid),
                  gt.degrid_table_reference(plan, table, grid), 1e-12)


@pytest.mark.cuda
def test_gridtab_support_beyond_the_instances_raises_on_card(device):
    rng = np.random.default_rng(33)
    plan, table, vals, grid = table_problem(rng, 100, 64, 2, 33, 5, torch.float32,
                                            device)
    with pytest.raises(ValueError, match="support 33 on the card"):
        gt.grid_table(plan, table, vals)
    with pytest.raises(ValueError, match="support 33 on the card"):
        gt.degrid_table(plan, table, grid)


@pytest.mark.cuda
def test_nifty_three_correlations_on_card_matches_cpu(device):
    args = imaging_inputs(nrow=3000, nchan=4, nx=64, seed=4)
    rng = np.random.default_rng(5)
    vis = (rng.normal(size=(3000, 4, 3)) + 1j * rng.normal(size=(3000, 4, 3))
           ).astype(np.complex64)
    flags = (rng.uniform(size=vis.shape) < 0.1).astype(np.uint8)
    image = rng.normal(size=(64, 64, 3)).astype(np.float32)
    cell_as = np.rad2deg(args["cell"]) * 3600
    gc = nifty.grid_config(64, 64, 1e-5, cell_as, cell_as)
    uvw, freq = args["uvw"], args["freq"]

    def run(dev):
        g = nifty.grid(torch.as_tensor(vis, device=dev), uvw, flags, None, freq, gc)
        return g, nifty.degrid(nifty.model(torch.as_tensor(image, device=dev), gc),
                               uvw, flags, None, freq, gc)

    before = (g2.grid_2d.launches, g2.degrid_2d.launches)
    got = run(device)
    torch.cuda.synchronize()
    assert (g2.grid_2d.launches, g2.degrid_2d.launches) == (before[0] + 1,
                                                            before[1] + 2)
    for g, w in zip(got, run("cpu")):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_close(g.cpu(), w, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("w,os_,cdtype", [(17, 63, np.complex64),
                                          (15, 1023, np.complex128)])
def test_pp_gridder_f1_shapes_on_card_match_cpu(device, w, os_, cdtype):
    """The PP gridder at W = 17 and the degridder in complex128 at W = 15,
    oversampling 1023, through the kernels, against the CPU."""
    args = imaging_inputs(nrow=3000, nchan=4, nx=128, seed=4)
    uvw = args["uvw"].astype(np.float64)
    wl = 2.99792458e8 / args["freq"].astype(np.float64)
    chanmap = np.array([0, 0, 1, 1])
    cell_as = np.rad2deg(args["cell"]) * 3600
    centres = ((0.0, -0.5 + 0.01), (0.0, -0.5))
    kern = pp.kernels.kbsinc(w, oversample=os_)
    rng = np.random.default_rng(w)
    vis = (rng.normal(size=(3000, 4, 2)) + 1j * rng.normal(size=(3000, 4, 2))
           ).astype(cdtype)

    def run(dev):
        g = pp.gridder(uvw, torch.as_tensor(vis, device=dev), wl, chanmap, 128,
                       cell_as, *centres, kern, w, os_, "rotate", "phase_rotate",
                       "I_FROM_XXYY", "conv_1d_axisymmetric_unpacked_scatter")
        return g, pp.degridder(uvw, g, wl, chanmap, cell_as, *centres, kern, w, os_,
                               "rotate", "phase_rotate", "XXYY_FROM_I",
                               "conv_1d_axisymmetric_unpacked_gather")

    before = (gt.grid_table.launches, gt.degrid_table.launches)
    got = run(device)
    torch.cuda.synchronize()
    assert (gt.grid_table.launches, gt.degrid_table.launches) == (before[0] + 1,
                                                                  before[1] + 1)
    bound = 1e-5 if cdtype == np.complex64 else 1e-12
    for g, want in zip(got, run("cpu")):
        assert g.dtype == want.dtype and g.shape == want.shape
        _assert_close(g.cpu(), want, bound)


def _rel_close(got, want, bound):
    got, want = got.cpu(), want.cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bool:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max() <= bound * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64])
def test_segment_sums_on_card_match_cpu(device, dtype):
    """Segmented sums over a skewed map (bins of 1 to 300 inputs, an
    empty one): the card against the CPU, and two runs bitwise equal."""
    rng = np.random.default_rng(3)
    out_index = np.concatenate([np.zeros(300, np.int64), rng.integers(1, 5000, 40000)])
    out_index[out_index == 17] = 18
    table = _segment_table(out_index, 5000)
    x = torch.as_tensor(rng.normal(size=(out_index.size, 4))).to(
        dtype if not dtype.is_complex else torch.float32)
    if dtype.is_complex:
        x = torch.complex(x, x.flip(0))
    cpu = _to_device(table, "cpu")
    card = _to_device(table, device)
    want = cpu.sum(cpu.gather(x))
    a = card.sum(card.gather(x.to(device)))
    b = card.sum(card.gather(x.to(device)))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _rel_close(a, want, 1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bda_on_card_matches_cpu(device, dtype):
    o = meerkat_inputs(nant=12, ntime=8, nchan=64, flag_frac=0.1, seed=5)
    if dtype == np.float64:
        for k in ("visibilities", "weight_spectrum", "sigma_spectrum"):
            o[k] = o[k].astype(np.complex128 if k == "visibilities" else np.float64)
    o["flag"][:, 5] = True
    o["flag_row"] = o["flag"].reshape(o["flag"].shape[0], -1).all(1).astype(np.uint8)

    def run(dev):
        data = {k: torch.as_tensor(o[k], device=dev) for k in
                ("visibilities", "flag", "weight_spectrum", "sigma_spectrum")}
        rest = {k: v for k, v in o.items() if k not in data}
        return bda(**rest, **data)

    a, b = run(device), run(device)
    torch.cuda.synchronize()
    want = run("cpu")
    bound = 1e-12 if dtype == np.float64 else 1e-6
    for name, x, y, w in zip(a._fields, a, b, want):
        if isinstance(x, torch.Tensor):
            assert x.device.type == "cuda", name
            assert torch.equal(x, y), name
            _rel_close(x, w, bound)


@pytest.mark.cuda
def test_time_and_channel_on_card_matches_cpu(device):
    o = meerkat_inputs(nant=10, ntime=12, dump=2.0, nchan=32, flag_frac=0.1, seed=6)
    kw = {k: o[k] for k in ("time", "interval", "antenna1", "antenna2", "uvw",
                            "flag_row", "chan_freq", "chan_width")}
    data = ("visibilities", "flag", "weight_spectrum", "sigma_spectrum")

    def run(dev):
        return time_and_channel(**kw, **{k: torch.as_tensor(o[k], device=dev)
                                         for k in data},
                                time_bin_secs=16.0, chan_bin_size=4)

    a, b, want = run(device), run(device), run("cpu")
    for name, x, y, w in zip(a._fields, a, b, want):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
            _rel_close(x, w, 1e-6)


@pytest.mark.cuda
def test_fused_e_term_launches_and_matches_cpu(device):
    """[Ep, (Kpq, Gpq, Bpq), Eq] on the card: the kernel route, E sampled
    once a block for both sides on the chan-invariant route (one
    beam_interp and one beam_blend launch a block) and one fused_dde
    launch a block."""
    args = fused_inputs(nsrc=6, ntime=2, nant=7, nchan=64, seed=4, beam_seed=3)
    spec = "[Ep, (Kpq, Gpq, Bpq), Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]"
    before = (cb.beam_interp.launches, cb.beam_blend.launches, cf.fused_dde.launches)
    got = rime(spec, **fused_from_numpy(args, device), source_block=4)
    torch.cuda.synchronize()
    assert (cb.beam_interp.launches - before[0], cb.beam_blend.launches - before[1],
            cf.fused_dde.launches - before[2]) == (2, 2, 2)
    want = rime(spec, **fused_from_numpy(args, "cpu"), source_block=4)
    _rel_close(got, want, 1e-5)


DDE_SPEC = "[Ep, Lp, Kpq, Gpq, Bpq, Lq, Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]"


def _dde_chunk(device, nsrc=100, ntime=4, nant=64, nchan=4096, seed=22):
    """The direction-dependent cell's chunk (8,064 rows x 4,096 channels
    at 64 dishes), drawn on ``device``: 100 gaussians within +-0.02 rad,
    the analytic 257^2 x 33 2x2 beam, pointing errors and beam scalings
    the same in every channel; the host columns numpy."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(*shape):
        return torch.rand(shape, generator=gen, device=device)

    f32 = torch.float32
    a1, a2 = np.triu_indices(nant, 1)
    nrow = ntime * a1.size
    freq = torch.linspace(856e6, 1712e6, nchan, dtype=torch.float64, device=device)
    fmap = torch.linspace(856e6, 1712e6, 33, dtype=torch.float64, device=device)
    beam = analytic_beam(257, 0.05, fmap, np.radians(57.5 / 60), 1.5e9, 0.02, 0.02,
                         device=device)
    pa = (draw(ntime, 1) * 2 - 1).expand(ntime, nant).contiguous() * np.pi
    sc = torch.stack([torch.sin(pa), torch.cos(pa)], -1)
    return dict(
        time=np.repeat(8.0 * np.arange(ntime), a1.size),
        antenna1=np.tile(a1, ntime), antenna2=np.tile(a2, ntime),
        uvw=(draw(nrow, 3) * 2 - 1) * 4000, chan_freq=freq.to(f32),
        lm=(draw(nsrc, 2) * 2 - 1) * 0.02, stokes=draw(nsrc, 4) * 0.1,
        spi=(draw(nsrc, 1, 1) - 0.7).expand(nsrc, 1, 4).contiguous(),
        ref_freq=torch.full((nsrc,), 1.284e9, device=device),
        gauss_shape=draw(nsrc, 3) * torch.tensor([3e-4, 1e-4, 3.14], device=device),
        beam=beam.to(torch.complex64),
        beam_lm_extents=torch.tensor([[-0.05, 0.05], [-0.05, 0.05]], device=device),
        beam_freq_map=fmap.to(f32), beam_parangle=pa,
        beam_point_errors=((draw(ntime, nant, 1, 2) - 0.5) * 2e-4).expand(
            ntime, nant, nchan, 2),
        beam_antenna_scaling=(1 + (draw(nant, 1, 2) - 0.5) * 0.02).expand(nant, nchan, 2),
        feed_parangle=torch.stack([sc, sc], -2)[:, None])


@pytest.mark.cuda
def test_fused_dde_chosen_block_fits_at_the_cell_chunk(device):
    """The direction-dependent predict at the benchmark cell's chunk, no
    block given: the kernel route's block is every source (its bytes, the
    E table and the pairs a source, fit the device), the evaluation stays
    within the device's memory and the route's own estimate, and blocks of
    3 sources give the same bits (the sum and its compensation carried
    from block to block)."""
    args = _dde_chunk(device)
    factory = RimeFactory(DDE_SPEC)
    state = factory.build_state(**args)
    route = factory.route(state)
    assert route == cf.Route(beam=True, feed=True, envelope=True)
    block = factory._kernel_block(state, route, MEMORY_SHARE * state["free_bytes"])
    assert block == 100
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = rime(DDE_SPEC, **args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= factory.kernel_bytes(state, block) * 1.02
    assert torch.cuda.max_memory_allocated() < torch.cuda.get_device_properties(
        device).total_memory
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    want = rime(DDE_SPEC, **args, source_block=3)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= factory.kernel_bytes(state, 3) * 1.02
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("S,R,F,T,NF,A", [(7, 300, 37, 3, 2, 9), (1, 129, 9, 1, 1, 5),
                                          (13, 1000, 130, 5, 1, 64), (0, 10, 10, 1, 1, 3),
                                          (5, 700, 20, 2, 2, 197)])
@pytest.mark.parametrize("beam,feed,env,feed_first", [
    (True, True, True, False), (True, True, True, True), (True, False, True, False),
    (False, True, False, False), (False, False, True, False), (False, False, False, False)])
def test_fused_dde_kernel_matches_plain(device, S, R, F, T, NF, A, beam, feed, env,
                                        feed_first):
    """The kernel against its plain version on ragged shapes (rows,
    channels and sources no multiple of a tile; 394 stations drawn at
    random, so tiles cut to fit MAX_STATIONS), every factor switched on
    and off: 1e-6 of max (sincospif and ex2.approx against torch's cos,
    sin and exp2; the same Kahan sum in the same order); one launch a
    call; two blocks of sources equal one bit for bit; reruns equal."""
    ops = fused_problem(np.random.default_rng(S * 1000 + R + F), S, R, F, T, NF, A,
                        beam, feed, env, feed_first, device)
    out = torch.empty((R, F, 4), dtype=torch.complex64, device=device)
    before = cf.fused_dde.launches
    cf.fused_dde(ops, out)
    torch.cuda.synchronize()
    assert cf.fused_dde.launches == before + 1
    want = cf.fused_dde_reference(ops, torch.empty_like(out))
    if S == 0:
        assert not out.abs().any()
        return
    assert (out - want).abs().max() <= 1e-6 * want.abs().max()
    h = S // 2

    def part(sl):
        return ops._replace(pairs=ops.pairs[sl].contiguous(), bright=ops.bright[sl].contiguous(),
                            beam=None if ops.beam is None else ops.beam[sl].contiguous())

    blocks, comp = torch.empty_like(out), torch.empty_like(out)
    cf.fused_dde(part(slice(0, h)), blocks, comp, first=True, last=False)
    cf.fused_dde(part(slice(h, S)), blocks, comp, first=False, last=True)
    assert torch.equal(blocks, out)
    assert torch.equal(cf.fused_dde(ops, torch.empty_like(out)), out)


def _dde_reference(args):
    """The float64 reference (``testing/dde_reference.py``) of
    :func:`_dde_chunk`'s arguments, on the CPU."""
    t = {k: (v.cpu().double() if not v.is_complex() else v.cpu().to(torch.complex128))
         if isinstance(v, torch.Tensor) else torch.as_tensor(v) for k, v in args.items()}
    time_index = torch.as_tensor(np.unique(args["time"], return_inverse=True)[1])
    sky = {k: t[k] for k in ("lm", "stokes", "spi", "ref_freq", "gauss_shape")}
    rows = dict(uvw=t["uvw"], time=time_index, antenna1=t["antenna1"],
                antenna2=t["antenna2"])
    beam = dict(beam=t["beam"], extents=t["beam_lm_extents"], freq_map=t["beam_freq_map"],
                parangle=t["beam_parangle"], feed_angle=t["beam_parangle"],
                point_errors=t["beam_point_errors"], antenna_scaling=t["beam_antenna_scaling"])
    return dde_predict(sky, rows, t["chan_freq"], beam)


@pytest.mark.cuda
def test_fused_dde_route_matches_reference_on_ragged_shapes(device):
    """The DDE specification through the kernel on the card, 5 sources
    over 63 rows (3 dumps of 21 baselines) by 13 channels: 2e-6 of max
    against the float64 reference of the same float32 inputs (the bound
    of the CPU's kernel route), and 1e-6 against the same route's plain
    version on the CPU."""
    args = _dde_chunk(device, nsrc=5, ntime=3, nant=7, nchan=13, seed=5)
    got = rime(DDE_SPEC, **args)
    torch.cuda.synchronize()
    want = _dde_reference(args)
    assert (got.cpu().to(torch.complex128) - want).abs().max() <= 2e-6 * want.abs().max()
    factory = RimeFactory(DDE_SPEC)
    cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in args.items()}
    state = factory.build_state(device="cpu", **cpu)
    plain = factory._evaluate_kernel(state, factory.route(factory.build_state(**args)), 5)
    _rel_close(got, plain, 1e-6)


@pytest.mark.cuda
def test_fused_dde_route_takes_any_number_of_stations(device):
    """SKA-Mid AA4's 197 dishes through the kernel (a tile stages only its
    own stations, so no array leaves the route): one launch, 2e-6 of max
    against the float64 reference."""
    args = _dde_chunk(device, nsrc=3, ntime=1, nant=197, nchan=9, seed=8)
    factory = RimeFactory(DDE_SPEC)
    assert factory.route(factory.build_state(**args)) is not None
    before = cf.fused_dde.launches
    got = rime(DDE_SPEC, **args)
    torch.cuda.synchronize()
    assert cf.fused_dde.launches == before + 1
    want = _dde_reference(args)
    assert (got.cpu().to(torch.complex128) - want).abs().max() <= 2e-6 * want.abs().max()


def _fused_spans(prof):
    return [e.name for e in prof.events() if e.name.startswith("fused.")
            and e.device_type == torch.autograd.DeviceType.CPU]


@pytest.mark.cuda
def test_fused_dde_launch_a_block_and_spans(device):
    """One fused_dde launch a source block (5 sources in blocks of 2: 3),
    E sampled once a block; under a profiler a ``fused.call`` around
    ``fused.state`` and one ``fused.kernel`` a call, no ``fused.sample``
    or ``fused.sum``, and the kernel evaluations counted."""
    args = _dde_chunk(device, nsrc=5, ntime=2, nant=6, nchan=40, seed=6)
    before = (cf.fused_dde.launches, cb.beam_blend.launches)
    plain = rime(DDE_SPEC, **args, source_block=2)
    torch.cuda.synchronize()
    assert (cf.fused_dde.launches - before[0], cb.beam_blend.launches - before[1]) == (3, 3)
    counts = (RimeFactory.calls.value, RimeFactory.blocks.value,
              RimeFactory.kernel_evaluations.value)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        outs = [rime(DDE_SPEC, **args, source_block=2) for _ in range(2)]
        torch.cuda.synchronize()
    assert all(torch.equal(o, plain) for o in outs)
    names = _fused_spans(prof)
    assert names.count("fused.call") == 2 and names.count("fused.state") == 2
    assert names.count("fused.kernel") == 2
    assert "fused.sample" not in names and "fused.sum" not in names
    assert (RimeFactory.calls.value - counts[0], RimeFactory.blocks.value - counts[1],
            RimeFactory.kernel_evaluations.value - counts[2]) == (2, 6, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("convention", ["fourier", "casa"])
@pytest.mark.parametrize("envelope", [True, False])
def test_fused_pairs_equal_the_torch_prologue(device, convention, envelope):
    """The pairs kernel gives phase_dot_cycles' two-float delays and
    envelope_coordinates' u1, v1 on the card bit for bit, over 37 sources
    (one at the phase centre, one beyond the horizon) and 1,003 rows; one
    launch."""
    from africanus_tpu_torch.model.shape.gaussian_shape import envelope_coordinates
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    rng = np.random.default_rng(37)
    lm = rng.uniform(-0.05, 0.05, (37, 2))
    lm[0], lm[1] = 0.0, (0.8, 0.75)
    lm = torch.as_tensor(lm, dtype=torch.float32, device=device)
    uvw = torch.as_tensor(rng.uniform(-8e3, 8e3, (1003, 3)), dtype=torch.float32,
                          device=device)
    shape = torch.as_tensor(np.column_stack([rng.uniform(0, 3e-4, 37),
                                             rng.uniform(0, 1e-4, 37),
                                             rng.uniform(0, np.pi, 37)]),
                            dtype=torch.float32, device=device)
    shape[2, 0] = 0.0
    before = cf.fused_pairs.launches
    got = cf.fused_pairs(lm, uvw, shape if envelope else None, convention)
    torch.cuda.synchronize()
    assert cf.fused_pairs.launches == before + 1
    hi, lo = phase_dot_cycles(lm, uvw, convention)
    assert torch.equal(got[..., 0], hi) and torch.equal(got[..., 1], lo)
    if envelope:
        u1, v1 = envelope_coordinates(uvw, shape)
        assert torch.equal(got[..., 2], u1) and torch.equal(got[..., 3], v1)
    else:
        assert not got[..., 2:].any()


@pytest.mark.cuda
def test_fused_kgb_through_the_kernel(device):
    """(Kpq, Gpq, Bpq) on the card takes the kernel (one launch, no
    beam), 1e-6 of max against the eager chain on the CPU and 5e-6 against
    the float64 oracle on a window."""
    args = fused_inputs(nsrc=9, ntime=2, nant=9, nchan=70, seed=7)
    spec = "(Kpq, Gpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"
    before = (cf.fused_dde.launches, cb.beam_blend.launches)
    got = rime(spec, **fused_from_numpy(args, device))
    torch.cuda.synchronize()
    assert (cf.fused_dde.launches - before[0], cb.beam_blend.launches - before[1]) == (1, 0)
    _rel_close(got, rime(spec, **fused_from_numpy(args, "cpu")), 1e-6)
    rows, chans = slice(10, 40), slice(5, 30)
    want = fused_oracle_f64(args, rows, chans)
    diff = np.abs(got[rows, chans].cpu().numpy() - want).max()
    assert diff <= 5e-6 * np.abs(want).max()


# ------------------------------------------------------------ the PP
# conv_nn_scatter route and the sky-model tail

@pytest.mark.cuda
@pytest.mark.parametrize("cdtype,bound", [(np.complex64, 1e-5), (np.complex128, 1e-12)],
                         ids=["c64", "c128"])
def test_pp_nn_scatter_on_card_is_deterministic_and_matches_cpu(device, cdtype, bound):
    """~200 samples a cell: two card runs bitwise equal, and the CPU."""
    problem = pp_nn_problem(nrow=100_000, npix=32, cdtype=cdtype, seed=16)
    a, b = pp_nn_grid(problem, device), pp_nn_grid(problem, device)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _rel_close(a, pp_nn_grid(problem, "cpu"), bound)


def _wsclean_args(dtype, device, kinds=("POINT", "GAUSSIAN", "POINT")):
    rng = np.random.default_rng(22)
    nsrc = 9
    stype = np.resize(np.array(kinds), nsrc)
    gauss_shape = np.column_stack([rng.uniform(1e-5, 1e-4, nsrc),
                                   rng.uniform(1e-6, 1e-5, nsrc),
                                   rng.uniform(0, np.pi, nsrc)])
    host = dict(uvw=rng.uniform(-4000, 4000, (300, 3)), lm=rng.uniform(-0.02, 0.02, (nsrc, 2)),
                flux=rng.uniform(0.5, 2.0, nsrc), coeffs=rng.normal(scale=0.1, size=(nsrc, 3)),
                ref_freq=rng.uniform(1.0e9, 1.4e9, nsrc), gauss_shape=gauss_shape,
                frequency=np.linspace(0.856e9, 1.712e9, 200))
    args = {k: torch.as_tensor(v.astype(dtype), device=device) for k, v in host.items()}
    return dict(args, source_type=stype, log_poly=np.arange(nsrc) % 2 == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kinds", [("POINT", "GAUSSIAN", "POINT"), ("POINT",)],
                         ids=["mixed", "points"])
def test_wsclean_predict_f32_launches_predict_kb_and_matches_cpu(device, kinds):
    from africanus_tpu_torch.rime import wsclean_predict

    before = cp.predict_kb.launches
    got = wsclean_predict(**_wsclean_args(np.float32, device, kinds))
    torch.cuda.synchronize()
    assert cp.predict_kb.launches == before + 1
    want = wsclean_predict(**_wsclean_args(np.float32, "cpu", kinds))
    assert got.dtype == torch.complex64 and got.shape == (300, 200, 1)
    _rel_close(got, want, 2e-6)


@pytest.mark.cuda
def test_wsclean_predict_f64_on_card_matches_cpu(device):
    from africanus_tpu_torch.rime import wsclean_predict

    before = cp.predict_kb.launches
    got = wsclean_predict(**_wsclean_args(np.float64, device))
    assert cp.predict_kb.launches == before
    _rel_close(got, wsclean_predict(**_wsclean_args(np.float64, "cpu")), 1e-12)


@pytest.mark.cuda
def test_predict_to_ms_store_on_card_matches_cpu(device, tmp_path):
    """The store pipeline at a small size: one predict_kb launch a chunk,
    MODEL_DATA against the CPU run's, what was written read back
    bitwise."""
    from africanus_tpu_torch.examples import predict_to_ms_store as ex
    from africanus_tpu_torch.io import MSStore

    model = tmp_path / "model.txt"
    model.write_text(ex.random_component_list(50, (1.0472, -0.8813), seed=4))
    runs = {}
    for dev in (device, "cpu"):
        path = tmp_path / str(dev)
        ex.make_store(path, nant=12, ntime=6, nchan=256)
        before = cp.predict_kb.launches
        run = ex.predict_to_ms_store(path, model, chunk=150, device=dev)
        runs[str(dev)] = (run, cp.predict_kb.launches - before,
                          MSStore(path).read("MODEL_DATA"))
    run, launches, got = runs[str(device)]
    assert launches == run.launches == len(run.slices) == 3
    for sl, digest in zip(run.slices, run.digests):
        assert ex.chunk_digest(got[sl]) == digest
    _rel_close(torch.as_tensor(got), torch.as_tensor(runs["cpu"][2]), 2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_zernike_dde_on_card_matches_cpu(device, f64):
    from africanus_tpu_torch.rime import zernike_dde

    args = zernike_problem(nsrc=5, ntime=2, nant=6, nchan=64, npoly=12, seed=23,
                           device=device)

    def widen(x):
        if not isinstance(x, torch.Tensor):
            return x
        return x.to(torch.complex128 if x.is_complex() else torch.float64)

    if f64:
        args = tuple(map(widen, args))
    got = zernike_dde(*args)
    want = zernike_dde(*(widen(x.cpu()) if isinstance(x, torch.Tensor) else x
                         for x in args))
    assert got.dtype == (torch.complex128 if f64 else torch.complex64)
    _rel_close(got.to(want.dtype), want, 1e-12 if f64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_shapelets_on_card_match_cpu(device, f64):
    from africanus_tpu_torch.model.shape import shapelet, shapelet_with_w_term

    coords, freq, coeffs, beta, delta, lm = shapelet_problem(
        nant=10, ntime=2, nchan=64, nsrc=3, nmax=8, seed=24, device=device)
    ops = [coords, freq, coeffs, beta, lm]
    if f64:
        ops = [x.double() for x in ops]
    coords, freq, coeffs, beta, lm = ops
    dtype = torch.complex128 if f64 else torch.complex64
    for fn, extra in ((shapelet, ()), (shapelet_with_w_term, (lm,))):
        got = fn(coords, freq, coeffs, beta, delta, *extra, dtype=dtype)
        want = fn(*(x.cpu().double() for x in (coords, freq, coeffs, beta)), delta,
                  *(x.cpu().double() for x in extra))
        _rel_close(got.to(want.dtype), want, 1e-12 if f64 else 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_fit_spi_on_card_matches_cpu(device, f64):
    from africanus_tpu_torch.model.spi import fit_spi_components

    data, weights, freqs, freq0, alpha, i0 = spi_problem(20_000, 8, seed=25)
    dtype = torch.float64 if f64 else torch.float32
    got = fit_spi_components(*(torch.as_tensor(x, device=device).to(dtype)
                               for x in (data, weights, freqs)), freq0).cpu().double()
    want = fit_spi_components(*map(torch.as_tensor, (data, weights, freqs)), freq0)
    bound = 1e-6 if f64 else 1e-4
    assert (got[0] - want[0]).abs().max() <= bound
    assert (got[2] / want[2] - 1).abs().max() <= bound
    assert (got[0] - torch.as_tensor(alpha)).abs().max() <= 1e-4


@pytest.mark.cuda
def test_stream_rows_on_card_matches_cpu(device):
    from africanus_tpu_torch.parallel import stream_rows

    rng = np.random.default_rng(5)
    x = rng.normal(size=(70, 3))
    w = rng.normal(size=(70,))

    def fn(tree, valid):
        assert tree["x"].device.type == "cuda" and valid.device.type == "cuda"
        return {"y": tree["x"] * tree["w"][:, None],
                "s": (tree["x"] * valid[:, None]).sum(0)}

    on_card = stream_rows(fn, {"x": x, "w": w}, chunk=32, device=device,
                          row_axes={"y": True, "s": False})
    assert_equal = np.testing.assert_array_equal
    assert_equal(on_card["y"], x * w[:, None])
    total = stream_rows(lambda t, v: (t["x"] * v[:, None]).sum(0), {"x": x}, chunk=32,
                        combine="sum", device=device)
    assert total.device.type == "cuda"
    np.testing.assert_allclose(total.cpu().numpy(), x.sum(0), rtol=1e-12)


# ------------------------------------------------- the application layer

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bound", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_kron_products_on_card_match_cpu(device, dtype, bound):
    from africanus_tpu_torch.linalg import (
        kron_matmat, kron_matvec, kron_tensormat, kron_tensorvec,
    )

    rng = np.random.default_rng(31)
    sq = [torch.as_tensor(rng.normal(size=(n, n)), dtype=dtype) for n in (16, 64, 8)]
    rect = [torch.as_tensor(rng.normal(size=s), dtype=dtype) for s in ((8, 16), (32, 64))]
    b = torch.as_tensor(rng.normal(size=(16 * 64 * 8, 5)), dtype=dtype)
    c = torch.as_tensor(rng.normal(size=(16 * 64, 3)), dtype=dtype)
    for fn, factors, x in ((kron_matvec, sq, b[:, 0]), (kron_matmat, sq, b),
                           (kron_tensorvec, rect, c[:, 0]), (kron_tensormat, rect, c)):
        got = fn([f.to(device) for f in factors], x.to(device))
        assert got.device.type == "cuda"
        _rel_close(got, fn(factors, x), bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kron_cholesky_retry_on_card(device, dtype):
    """The first factor fails (info > 0) and the 1e6× jitter retry is
    selected on the card, with no host sync; the CPU selects the same."""
    from africanus_tpu_torch.linalg import kron_cholesky

    eps = torch.finfo(dtype).eps
    bad = torch.ones((4, 4), dtype=dtype) - 1e4 * eps * torch.eye(4, dtype=dtype)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(6, 6)), dtype=dtype)
    good = x @ x.T + 6 * torch.eye(6, dtype=dtype)
    got = kron_cholesky([bad.to(device), good.to(device)])
    want = kron_cholesky([bad, good])
    bound = 1e-12 if dtype == torch.float64 else 1e-5
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _rel_close(g, w, bound)


def _example_launches(fn):
    from africanus_tpu_torch.examples.launches import counts, since

    before = counts()
    out = fn()
    torch.cuda.synchronize()
    return out, since(before)


@pytest.mark.cuda
def test_generate_gains_on_card_matches_cpu(device):
    from africanus_tpu_torch.examples import generate_gains as ex

    rng = np.random.default_rng(42)
    t, nu, src = ex.example_coordinates(rng, 16, 8, 3)
    xi = rng.normal(size=(7, 16 * 8 * 3))
    for dtype, bound in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        got = ex.gp_phase_gains(t, nu, src, 7, xi=xi, device=device, dtype=dtype)
        want = ex.gp_phase_gains(t, nu, src, 7, xi=xi, device="cpu", dtype=dtype)
        _rel_close(got.gains, want.gains, bound)
    gen = torch.Generator(device=device).manual_seed(1)
    drawn = ex.gp_phase_gains(t, nu, src, 7, generator=gen, device=device)
    assert drawn.gains.device.type == "cuda"
    assert float((drawn.gains.abs() - 1).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_predict_dft_example_on_card(device):
    from africanus_tpu_torch.examples import predict_dft as ex

    inputs = ex.dft_inputs(nsrc=20, nant=7, nchan=64, ntime=4)
    got, n = _example_launches(lambda: ex.predict_dft(**inputs, device=device))
    assert n == {"dft_forward": 1}
    _rel_close(got, ex.predict_dft(**inputs, device="cpu"), 3e-6)


@pytest.mark.cuda
def test_make_dirty_example_on_card(device):
    from africanus_tpu_torch.examples import make_dirty as ex

    uvw, freq, cell, srcs = ex.dirty_inputs(64, 3000)
    vis = ex.point_source_vis(uvw, freq, cell, srcs, device)
    got, n = _example_launches(lambda: ex.make_dirty(uvw, freq, vis, 64, cell))
    assert n == {"grid_wstack": 1}
    _rel_close(got, ex.make_dirty(uvw, freq, vis.cpu(), 64, cell), 1e-5)


@pytest.mark.cuda
def test_selfcal_example_on_card(device):
    from africanus_tpu_torch.examples import selfcal as ex

    obs = ex.observation(nant=8, ntime=4)
    run, n = _example_launches(lambda: ex.selfcal(obs, device))
    assert n == {"dft_forward": 1, "grid_wstack": 2, "hogbom": 1}
    peak = np.unravel_index(int(torch.argmax(run.clean)), tuple(run.clean.shape))
    assert peak == (ex.NPIX // 2, ex.NPIX // 2)
    _rel_close(run.dirty, ex.selfcal(obs, "cpu").dirty, 1e-4)


@pytest.mark.cuda
def test_selfcal_ms_store_example_on_card(device, tmp_path):
    """At 160 channels the model takes predict_kb; the gain products meet
    the example's bound, and MODEL_DATA (2e-6, predict_kb's compensated
    bound), CORRECTED_DATA (1e-5) and the normalised dirty image (1e-4,
    as the selfcal example's) are what the CPU makes."""
    from africanus_tpu_torch.examples import selfcal_ms_store as ex
    from africanus_tpu_torch.io import MSStore

    stores = {}
    for dev in (device, "cpu"):
        path = tmp_path / str(dev)

        def pipeline():
            true_phase = ex.make_corrupted_store(path, np.random.default_rng(17), 12, 4,
                                                 160, 4, dev)
            return ex.selfcal_ms_store(path, true_phase, dev)

        run, n = _example_launches(pipeline)
        assert run.gain_error < ex.GAIN_BOUND
        store = MSStore(path)
        stores[str(dev)] = (n, store.read("MODEL_DATA"), store.read("CORRECTED_DATA"),
                            run.dirty.cpu())
    assert stores[str(device)][0] == {"predict_kb": 1, "grid_wstack": 2, "hogbom": 1}
    for i, bound in ((1, 2e-6), (2, 1e-5)):
        _rel_close(torch.as_tensor(stores[str(device)][i]),
                   torch.as_tensor(stores["cpu"][i]), bound)
    _rel_close(stores[str(device)][3], stores["cpu"][3], 1e-4)


@pytest.mark.cuda
def test_apply_phase_screen_example_on_card(device, tmp_path):
    from africanus_tpu_torch.examples import apply_phase_screen_ms_store as ex
    from africanus_tpu_torch.io import MSStore

    data = {}
    for dev in (device, "cpu"):
        rng = np.random.default_rng(23)
        path = tmp_path / str(dev)
        ex.fabricate_store(path, rng)
        run = ex.apply_phase_screen(path, rng, dev)
        _, _, err = ex.calibrate(path, run.phases, dev)
        assert err < ex.SCREEN_BOUND
        data[str(dev)] = MSStore(path).read("DATA")
    _rel_close(torch.as_tensor(data[str(device)]), torch.as_tensor(data["cpu"]), 1e-6)


@pytest.mark.cuda
def test_predict_wsclean_example_on_card(device, tmp_path):
    from africanus_tpu_torch.examples import predict_wsclean as ex

    model = tmp_path / "demo.txt"
    model.write_text(ex.DEMO_MODEL)
    _, sky = ex.sky_model(model)
    uvw, freq = ex.observation()
    got, n = _example_launches(lambda: ex.predict_wsclean(sky, uvw, freq, device))
    assert n == {"predict_kb": 1}
    _rel_close(got.to(torch.complex128),
               ex.predict_wsclean(sky, uvw, freq, "cpu", torch.float64), 1e-5)


@pytest.mark.cuda
def test_predict_from_fits_example_on_card(device, tmp_path):
    from africanus_tpu_torch.examples import predict_from_fits as ex

    rng = np.random.default_rng(0)
    ex.write_demo_model(tmp_path / "m.fits", rng)
    flux, lm = ex.fits_components(tmp_path / "m.fits")
    uvw, freq = ex.observation(rng)
    got, n = _example_launches(
        lambda: ex.predict_from_fits(flux, lm, uvw, freq, device=device))
    assert n == {"dft_forward": 3}
    want = ex.predict_from_fits(flux, lm, uvw, freq, device="cpu")
    assert np.abs(got - want).max() <= 3e-6 * np.abs(want).max()


@pytest.mark.cuda
def test_spi_fitter_cube_beammodel_on_card(device, tmp_path):
    """--beammodel on the card: the chan-invariant route, one beam_interp
    and one beam_blend launch; the maps as the CPU's."""
    from test_torch_examples_io import spi_cube

    from africanus_tpu_torch.examples import spi_fitter_cube as ex

    model, resid = spi_cube(tmp_path, "beam_$(corr)_$(reim).fits")
    fits = {}
    for dev in (device, "cpu"):
        run, n = _example_launches(lambda: ex.fit_cube(
            str(model), str(resid), str(tmp_path / f"{dev}-"), threshold=50.0,
            beammodel=str(tmp_path / "beam_$(corr)_$(reim).fits"), device=dev))
        fits[str(dev)] = (run, n)
    assert fits[str(device)][1] == {"beam_interp": 1, "beam_blend": 1}
    for letter in ("a", "I"):
        _rel_close(fits[str(device)][0].maps[letter], fits["cpu"][0].maps[letter], 1e-5)


@pytest.mark.cuda
def test_examples_without_kernels_on_card_match_cpu(device):
    """apply_gains, custom_rime_term, predict_shapelet and fit_spi are
    torch operations on the card: no launch, the CPU's results."""
    from africanus_tpu_torch.examples import (
        apply_gains, custom_rime_term, fit_spi, predict_shapelet,
    )

    inputs = apply_gains.gain_inputs()
    (vis, fixed, k), n = _example_launches(
        lambda: apply_gains.apply_and_undo(**inputs, device=device))
    assert n == {} and float((fixed - k).abs().max() / k.abs().max()) < 1e-5
    _rel_close(vis, apply_gains.apply_and_undo(**inputs, device="cpu")[0], 1e-5)
    ds = custom_rime_term.dataset()
    got = custom_rime_term.custom_rime(ds, device)
    _rel_close(got, custom_rime_term.explicit(ds, "cpu"), 1e-12)
    sin = predict_shapelet.shapelet_inputs()
    _rel_close(predict_shapelet.predict_shapelet(**sin, device=device),
               predict_shapelet.predict_shapelet(**sin, device="cpu"), 1e-5)
    data, weights, freqs, _, _ = fit_spi.spectra()
    got = fit_spi.fit_spi(data, weights, freqs, device)
    want = fit_spi.fit_spi(data, weights, freqs, "cpu")
    assert float((got[0].cpu() - want[0]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_examples_default_to_the_card(device, capsys):
    from africanus_tpu_torch.examples import apply_gains

    apply_gains.main([])
    out = capsys.readouterr().out
    assert torch.cuda.get_device_name(0) in out


# ------------------------------------------------- the sharded paths (parallel/)

def _mesh4(device):
    from africanus_tpu_torch.parallel import make_mesh

    return make_mesh((4,), ("row",), devices=[device] * 4)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_make_mesh_defaults_to_the_cards(device):
    from africanus_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    assert mesh.size == torch.cuda.device_count()
    assert all(d.type == "cuda" for d in mesh.devices.ravel())
    assert mesh.first == torch.device("cuda", 0)


@pytest.mark.cuda
def test_sharded_dfts_on_card_match_unsharded(device):
    """dft_forward, predict_kb (≥ 128 channels) and dft_adjoint, a launch
    a shard; the sum of the shard images within the DFT's 3e-6."""
    from africanus_tpu_torch import parallel as par
    from africanus_tpu_torch.dft import im_to_vis, vis_to_im

    rng = np.random.default_rng(29)
    mesh = _mesh4(device)
    for nchan, kernel in ((16, "dft_forward"), (128, "predict_kb")):
        lm = torch.as_tensor(rng.uniform(-0.02, 0.02, (7, 2)), dtype=torch.float32,
                             device=device)
        uvw = rng.uniform(-500, 500, (400, 3)).astype(np.float32)
        freq = np.linspace(1.0e9, 1.5e9, nchan).astype(np.float32)
        image = rng.uniform(0.1, 1.0, (7, nchan, 2)).astype(np.float32)
        got, n = _example_launches(lambda: par.sharded_im_to_vis(mesh, image, uvw, lm,
                                                                 freq))
        assert n == {kernel: 4}
        want = im_to_vis(torch.as_tensor(image, device=device),
                         torch.as_tensor(uvw, device=device), lm, freq)
        assert _rel(got, want) <= 1e-6
        flags = torch.zeros(want.shape, dtype=torch.bool, device=device)
        got, n = _example_launches(lambda: par.sharded_vis_to_im(mesh, want, uvw, lm,
                                                                 freq, flags))
        assert n == {"dft_adjoint": 4}
        ref = vis_to_im(want, torch.as_tensor(uvw, device=device), lm, freq, flags)
        assert _rel(got, ref) <= 3e-6
        assert torch.equal(got, par.sharded_vis_to_im(mesh, want, uvw, lm, freq, flags))


@pytest.mark.cuda
def test_sharded_imaging_on_card_matches_unsharded(device):
    """grid_wstack / degrid_wstack a launch a shard, on the full uvw's
    w-planes: the sharded dirty image, degrid and residual within 1e-5 of
    max of the unsharded calls, the sums rerun bitwise."""
    from africanus_tpu_torch import parallel as par
    from africanus_tpu_torch.gridding.wgridder.core import (
        degrid, grid_adjoint, make_plan,
    )

    args = imaging_inputs(nrow=4000, nchan=4, nx=64, seed=4)
    nx, cell, uvw, freq = args["nx"], args["cell"], args["uvw"], args["freq"]
    vis = torch.as_tensor(args["vis"], device=device)
    image = torch.as_tensor(args["image"], dtype=torch.float32, device=device)
    plan = make_plan(uvw, freq, nx, nx, cell, cell, 1e-4, True, device=device)
    mesh = _mesh4(device)
    got, n = _example_launches(lambda: par.sharded_dirty(mesh, uvw, freq, vis, nx, nx,
                                                         cell, 1e-4, True))
    assert n == {"grid_wstack": 4}
    assert torch.equal(got, par.sharded_dirty(mesh, uvw, freq, vis, nx, nx, cell, 1e-4,
                                              True))
    want = grid_adjoint(uvw, freq, vis, None, nx, nx, cell, cell, 1e-4, True, plan=plan)
    assert _rel(got, want) <= 1e-5
    got, n = _example_launches(lambda: par.sharded_degrid(
        mesh, uvw, freq, image, cell=cell, epsilon=1e-4, do_wstacking=True))
    assert n == {"degrid_wstack": 4}
    model = degrid(uvw, freq, image, None, cell, cell, 1e-4, True, plan=plan)
    assert _rel(got, model) <= 1e-5
    got = par.sharded_residual(mesh, uvw, freq, vis, image, cell, 1e-4, True)
    want = grid_adjoint(uvw, freq, vis - model, None, nx, nx, cell, cell, 1e-4, True,
                        plan=plan)
    assert _rel(got, want) <= 1e-5


@pytest.mark.cuda
def test_sharded_pp_on_card_matches_unsharded(device):
    """grid_table / degrid_table a launch a shard, each on its own plan:
    within 1e-5 of max of the unsharded gridder and degridder."""
    from africanus_tpu_torch import parallel as par

    rng = np.random.default_rng(30)
    npix, cell, w, os_ = 64, 8.0, 7, 63
    wl = 2.99792458e8 / np.array([1.0e9, 1.1e9])
    uvw = rng.uniform(-0.4, 0.4, (400, 3)) / (npix * cell / 3600 * np.pi / 180)
    uvw *= wl.min()
    chanmap = np.zeros(2, np.int32)
    kern = pp.kernels.kbsinc(w, oversample=os_)
    vis = torch.as_tensor((rng.normal(size=(400, 2, 2))
                           + 1j * rng.normal(size=(400, 2, 2))).astype(np.complex64),
                          device=device)
    centre = (0.2, -0.4)
    gargs = (wl, chanmap, npix, cell, centre, centre, kern, w, os_, "None", "None",
             "I_FROM_XXYY", "conv_1d_axisymmetric_unpacked_scatter")
    mesh = _mesh4(device)
    got, n = _example_launches(lambda: par.sharded_pp_gridder(mesh, uvw, vis, *gargs))
    assert n == {"grid_table": 4}
    want = pp.gridder(uvw, vis, *gargs)
    assert _rel(got, want) <= 1e-5
    dargs = (wl, chanmap, cell, centre, centre, kern, w, os_, "None", "None",
             "XXYY_FROM_I", "conv_1d_axisymmetric_unpacked_gather")
    got, n = _example_launches(lambda: par.sharded_pp_degridder(mesh, uvw, want, *dargs))
    assert n == {"degrid_table": 4}
    assert _rel(got, pp.degridder(uvw, want, *dargs)) <= 1e-5


@pytest.mark.cuda
def test_sharded_calibration_and_averaging_on_card(device):
    """The calibration residual (rtol 1e-12) and the averagers (each
    shard bitwise its own call on the card) on shards of the card."""
    from africanus_tpu_torch import parallel as par
    from africanus_tpu_torch.calibration.utils import residual_vis

    inputs = selfcal_inputs(nant=6, ntime=4, nchan=3, nsrc=3, ncorr=1, seed=5)
    inputs.update(make_data(inputs, "cpu"))
    meta = (inputs["time_bin_indices"], inputs["time_bin_counts"], inputs["antenna1"],
            inputs["antenna2"])
    c128 = torch.complex128
    gains = torch.polar(torch.ones(inputs["true_phase"].shape, dtype=torch.float64),
                        torch.as_tensor(inputs["true_phase"], dtype=torch.float64))
    data = torch.complex(*map(torch.as_tensor, inputs["data"])).to(c128)
    model_ = torch.complex(*map(torch.as_tensor, inputs["model"])).to(c128)
    flag = torch.as_tensor(inputs["flag"])
    ops = [x.to(device) for x in (gains, data, flag, model_)]
    got = par.sharded_residual_vis(_mesh4(device), *meta, *ops)
    want = residual_vis(*meta, gains, data, flag, model_)
    assert np.allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12, atol=1e-12)

    om = meerkat_inputs(nant=6, ntime=8, nchan=16)
    vis = torch.as_tensor(om["visibilities"], device=device)
    fl = torch.as_tensor(om["flag"], device=device)
    out = par.sharded_bda(_mesh4(device), om["time"], om["interval"], om["antenna1"],
                          om["antenna2"], om["uvw"], om["chan_freq"], om["chan_width"],
                          vis, flag=fl, decorrelation=om["decorrelation"])
    rp = om["time"].size // 4
    for s in range(4):
        sl = slice(s * rp, (s + 1) * rp)
        ref = bda(om["time"][sl], om["interval"][sl], om["antenna1"][sl],
                  om["antenna2"][sl], uvw=om["uvw"][sl], chan_freq=om["chan_freq"],
                  chan_width=om["chan_width"], visibilities=vis[sl], flag=fl[sl],
                  decorrelation=om["decorrelation"])
        n = int(out.nout[s])
        assert torch.equal(out.visibilities[s, :n], ref.visibilities)
        assert torch.equal(out.flag[s, :n], ref.flag)
        assert bool(out.flag[s, n:].all())
