"""The port on a CUDA card: the hand-written kernel against its plain
version, and the flagship predict on the card against the CPU.

Every test here needs a card and skips without one. The file imports no
JAX (the card's machine has none), so it also runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Bounds: 2e-6·max|V| for the compensated phase, 1e-5·max|V| for the
plain phase (the bounds of tests/test_pallas_predict.py; the kernel
and the plain version differ in cos/sin/exp rounding and in the order
of the f32 source sum).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import kernel_problem  # noqa: E402

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
