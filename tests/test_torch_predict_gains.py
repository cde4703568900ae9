"""Diagonal DIE gains in ``predict_kb``'s store
(africanus_tpu_torch.ops.cuda_predict, ``gains=``).

On the card the kernel applies g1[t, p]·V·conj(g2[t, q]) as it writes V;
it is held to ``predict_vis`` applied to the kernel's own V, within 1e-6
of max (the same complex products in the same order, contracted into
FMAs by nvcc), in every phase mode, with and without the envelope, at
1, 2, 3 (2 + 1 launches) and 4 correlations, on rows that are not a
multiple of a block's 32 and dumps whose first index is not 0. On the
CPU the wrapper's route is ``predict_vis`` after ``predict_kb_reference``,
exactly. The card tests skip without a card; the file imports no JAX, so
that it also runs on the card's machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_predict_gains.py
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
    FlagshipPredict, flagship_inputs, from_numpy,
)
from africanus_tpu_torch.rime.predict import predict_vis  # noqa: E402


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def gains_problem(rng, R, F, C, device, ntime=3, nant=7, first=5, same=False):
    """(time_index, antenna1, antenna2, g1, g2) of R rows: consecutive
    baselines of ``ntime`` dumps from dump ``first``, the last dump ragged;
    g1, g2 (ntime, nant, F, C) complex64 phasors of amplitude 0.5-1.5, one
    tensor where ``same``."""
    a1, a2 = np.triu_indices(nant, 1)
    reps = -(-R // a1.size)
    time_index = np.repeat(np.arange(reps), a1.size)[:R] % ntime + first
    a1, a2 = np.tile(a1, reps)[:R], np.tile(a2, reps)[:R]

    def table():
        amp = rng.uniform(0.5, 1.5, (ntime, nant, F, C))
        return torch.as_tensor(
            (amp * np.exp(1j * rng.uniform(-np.pi, np.pi, amp.shape))).astype(np.complex64),
            device=device)

    g1 = table()
    g2 = g1 if same else table()
    return tuple(torch.as_tensor(x, dtype=torch.int64, device=device)
                 for x in (time_index, a1, a2)) + (g1, g2)


def unfused(ops, gains, predict=cp.predict_kb):
    ti, a1, a2, g1, g2 = gains
    return predict_vis(ti, a1, a2, die1_jones=g1, base_vis=predict(*ops), die2_jones=g2)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["exact", "residual", "direct"])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("env", [True, False])
def test_port_gains_epilogue_matches_predict_vis(device, grid, C, env):
    rng = np.random.default_rng(100 * C + len(grid) + env)
    ops = kernel_problem(rng, 19, 333, 45, C, True, env, device, grid)
    gains = gains_problem(rng, 333, 45, C, device)
    before = (cp.predict_kb.launches, cp.predict_kb.gains_launches)
    got = cp.predict_kb(*ops, gains=gains)
    torch.cuda.synchronize()
    launches = 2 if C == 3 else 1
    assert (cp.predict_kb.launches, cp.predict_kb.gains_launches) == (
        before[0] + launches, before[1] + launches)
    want = unfused(ops, gains)
    assert got.shape == want.shape and got.dtype == torch.complex64
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert torch.equal(got, cp.predict_kb(*ops, gains=gains))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4])
def test_port_gains_one_table_and_rows_outside_it(device, C):
    """g1 and g2 one tensor; a row whose index lies outside the tables is
    written as NaN, and only that row."""
    rng = np.random.default_rng(7 + C)
    ops = kernel_problem(rng, 9, 100, 40, C, True, True, device)
    ti, a1, a2, g, _ = gains_problem(rng, 100, 40, C, device, same=True)
    want = unfused(ops, (ti, a1, a2, g, g))
    got = cp.predict_kb(*ops, gains=(ti, a1, a2, g, g))
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    a2 = a2.clone()
    a2[37] = g.shape[1]
    got = cp.predict_kb(*ops, gains=(ti, a1, a2, g, g))
    bad = torch.isnan(torch.view_as_real(got)).any(dim=(1, 2, 3))
    assert bad.nonzero().flatten().tolist() == [37]
    keep = torch.arange(100, device=device) != 37
    assert torch.equal(got[keep], cp.predict_kb(*ops, gains=(ti, a1, a2.clamp(max=6), g, g))[keep])


@pytest.mark.cuda
def test_port_gains_at_the_flagship_chunk(device):
    """The flagship's chunk (100 gaussians, 8064 rows, 4096 channels):
    its forward goes through the epilogue, reruns bitwise, within 1e-6
    of max of predict_vis on the kernel's V, and counted while a
    profiler records."""
    args = flagship_inputs(nsrc=100, ntime=4, nant=64, nchan=4096, seed=2026)
    model, x = from_numpy(args, device)
    ops = model.kernel_operands(x[3], x[4])
    g = torch.polar(torch.ones_like(x[5]), x[5])
    gains = (x[0], x[1], x[2], g, g)
    got = cp.predict_kb(*ops, gains=gains)
    assert torch.equal(got, cp.predict_kb(*ops, gains=gains))
    want = unfused(ops, gains)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    del want
    counts = (FlagshipPredict.calls.value, FlagshipPredict.gains_fused.value)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = model(*x)
    assert (FlagshipPredict.calls.value - counts[0],
            FlagshipPredict.gains_fused.value - counts[1]) == (1, 1)
    assert torch.equal(out, got)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("env", [True, False])
def test_port_gains_cpu_route_is_predict_vis_after_the_reference(C, env):
    rng = np.random.default_rng(C + 10 * env)
    ops = kernel_problem(rng, 5, 37, 20, C, True, env, "cpu")
    gains = gains_problem(rng, 37, 20, C, "cpu")
    before = (cp.predict_kb.launches, cp.predict_kb.gains_launches)
    got = cp.predict_kb(*ops, gains=gains)
    assert (cp.predict_kb.launches, cp.predict_kb.gains_launches) == before
    assert torch.equal(got, unfused(ops, gains, cp.predict_kb_reference))


def _bad_gains(kind, ti, a1, a2, g1, g2):
    if kind == "a (2, 2) layout":
        g = g1.reshape(*g1.shape[:3], 2, 2)
        return ti, a1, a2, g, g
    if kind == "int32 indices":
        return ti.to(torch.int32), a1, a2, g1, g2
    if kind == "indices of other rows":
        return ti[1:], a1, a2, g1, g2
    if kind == "tables of other channels":
        return ti, a1, a2, g1[:, :, 1:], g2[:, :, 1:]
    if kind == "tables of other dumps":
        return ti, a1, a2, g1, g2[1:]
    if kind == "complex128 tables":
        return ti, a1, a2, g1.to(torch.complex128), g2
    if kind == "non-contiguous tables":
        return ti, a1, a2, g1.transpose(0, 1), g2
    if kind == "tables on another device":
        return ti, a1, a2, g1.to("meta"), g2
    if kind == "four of five":
        return ti, a1, g1, g2
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "a (2, 2) layout", "int32 indices", "indices of other rows",
    "tables of other channels", "tables of other dumps", "complex128 tables",
    "non-contiguous tables", "tables on another device", "four of five"])
def test_port_gains_refuses_what_the_kernel_does_not_take(kind):
    rng = np.random.default_rng(3)
    ops = kernel_problem(rng, 4, 30, 16, 4, True, True, "cpu")
    gains = gains_problem(rng, 30, 16, 4, "cpu", ntime=7, nant=7)
    with pytest.raises(ValueError):
        cp.predict_kb(*ops, gains=_bad_gains(kind, *gains))


def test_port_gains_refuse_the_plain_phase():
    rng = np.random.default_rng(4)
    ops = kernel_problem(rng, 4, 30, 16, 2, False, True, "cpu")
    with pytest.raises(ValueError, match="compensated"):
        cp.predict_kb(*ops, gains=gains_problem(rng, 30, 16, 2, "cpu"))


def test_port_flagship_counts_its_calls_while_a_profiler_records():
    """On the CPU a forward counts as a call and not as fused gains; with
    no profiler nothing is counted."""
    model, x = from_numpy(flagship_inputs(nsrc=3, ntime=2, nant=5, nchan=8, seed=11),
                          "cpu")
    counts = (FlagshipPredict.calls.value, FlagshipPredict.gains_fused.value)
    model(*x)
    assert (FlagshipPredict.calls.value, FlagshipPredict.gains_fused.value) == counts
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model(*x)
        model(*x)
    assert (FlagshipPredict.calls.value - counts[0],
            FlagshipPredict.gains_fused.value - counts[1]) == (2, 0)
