"""The port on a CUDA card: the hand-written kernels against their plain
versions, and the flagship predict and the selfcal step on the card
against the same modules on the CPU.

Every test here needs a card and skips without one. The file imports no
JAX (the card's machine has none), so it also runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bounds: predict_kb 2e-6·max|V| for the compensated phase, 1e-5·max|V|
for the plain phase (the bounds of tests/test_pallas_predict.py; the
kernel and the plain version differ in cos/sin/exp rounding and in the
order of the f32 source sum). The DFT kernels 3e-6·max|out|, the bound
of tests/test_dft.py:322,363, for the same reasons. The selfcal step
takes the bounds and the two cases (converged, and a model that lacks a
source) of tests/test_torch_selfcal.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import dft_problem, kernel_problem  # noqa: E402

from africanus_tpu_torch.calibration.selfcal import (  # noqa: E402
    from_numpy as selfcal_from_numpy, make_data, selfcal_inputs,
)
from africanus_tpu_torch.ops import cuda_dft as cd  # noqa: E402
from africanus_tpu_torch.ops import cuda_predict as cp  # noqa: E402
from africanus_tpu_torch.rime.flagship import (  # noqa: E402
    flagship_inputs, from_numpy,
)


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
                                     (5, 4, 0, 4)])
@pytest.mark.parametrize("grid", ["exact", "residual", "direct"])
@pytest.mark.parametrize("C", [1, 2, 4])
@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_dft_kernels_match_plain(device, S, P, R, F, grid, C, convention):
    rng = np.random.default_rng(S * 1000 + R + F + C)
    lm_s, lm_p, uvw, freq, img, vis = dft_problem(rng, S, P, R, F, C, grid,
                                                  device)
    fwd = cd.DftPlan("forward", lm_s, freq, C, convention)
    for image in (img, img.real.contiguous()):
        before = cd.dft_forward.launches
        got = cd.dft_forward(fwd, uvw, image)
        torch.cuda.synchronize()
        assert cd.dft_forward.launches == before + (S > 0 and R > 0)
        want = cd.dft_forward_reference(fwd, uvw, image)
        assert got.shape == (R, F, C) and got.dtype == torch.complex64
        _assert_close(got, want)
    adj = cd.DftPlan("adjoint", lm_p, freq, C, convention)
    before = cd.dft_adjoint.launches
    got = cd.dft_adjoint(adj, uvw, vis)
    torch.cuda.synchronize()
    assert cd.dft_adjoint.launches == before + (R > 0)
    want = cd.dft_adjoint_reference(adj, uvw, vis)
    assert got.shape == (P, F, C) and got.dtype == torch.float32
    _assert_close(got, want)


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
    before = (cd.dft_forward.launches, cd.dft_adjoint.launches)
    got = [x.cpu() for x in step_gpu(data_gpu)]
    assert (cd.dft_forward.launches, cd.dft_adjoint.launches) == (
        before[0] + 1, before[1] + 1)
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
