"""The float32 DFTs on a plan made for shorter baselines than the call's,
on the CPU.

A :class:`~africanus_tpu_torch.ops.cuda_dft.DftPlan` chooses its phase
mode for a delay bound measured on the uvw it was made from; a call may
bring other rows. A pair beyond the bound takes the direct phase (the
CUDA kernels by warp vote, their plain versions pair by pair), so the
bound is a hint. Here, at 20 sources × 2000 rows × 16 channels, uvw σ
3 km, lm within ±0.05 (a float32 linspace over 0.856-1.712 GHz, where a
plan made on uvw/1000 picks the ``exact`` mode and drops the grid's
residual), in the three grids at C 1/2/4 and both conventions:

- ``im_to_vis`` and ``vis_to_im`` in float32 with plans made on uvw/k,
  k ∈ {1, 1000, 1e6}, and with ``delay_max=1e-12``, hold 3e-6 of max
  (tests/test_dft.py:322,363) against the JAX package's public
  ``im_to_vis``/``vis_to_im`` in float64 and against the port's float64
  route, on the same float32-rounded inputs;
- with a plan made on the call's own uvw no pair is beyond the bound,
  and the plain versions' output is that of the route without the
  far-pair branch, bit for bit;
- a ``SelfcalStep`` planned on a compact track, whose ``uvw`` buffer is
  then changed in place or loaded with the full track, holds its DFT
  outputs to the same bar against the float64 oracles.

The kernels themselves are held on the card (tests/test_torch_cuda.py,
``chip_smoke.py`` phase 4).
"""

import functools

import numpy as np
import pytest
import torch

from africanus_tpu.dft import im_to_vis as jax_im_to_vis
from africanus_tpu.dft import vis_to_im as jax_vis_to_im

from africanus_tpu_torch.calibration.selfcal import (
    from_numpy, im_to_vis_oracle_f64, make_data, selfcal_inputs,
    vis_to_im_oracle_f64,
)
from africanus_tpu_torch.calibration.utils import corrupt_vis
from africanus_tpu_torch.dft import dft_plan, im_to_vis, vis_to_im
from africanus_tpu_torch.rime.phase import phase_dot_cycles

BOUND = 3e-6  # tests/test_dft.py:322,363, of max|out|
F32 = np.float32
NSRC, NROW, NCHAN = 20, 2000, 16
GRIDS = ["exact", "residual", "direct"]
# where the plan was made: on uvw / k, or on the call's uvw with this
# delay_max
PLANS = {"uvw/1": (1.0, None), "uvw/1000": (1e3, None), "uvw/1e6": (1e6, None),
         "delay_max=1e-12": (1.0, 1e-12)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@functools.lru_cache(maxsize=None)
def _problem(grid, ncorr):
    """The H1 case: float32 numpy inputs of one grid and ncorr."""
    rng = np.random.default_rng(100 + 10 * ncorr + GRIDS.index(grid))
    if grid == "exact":
        freq = np.linspace(0.856e9, 1.712e9, NCHAN)
    elif grid == "residual":
        freq = np.linspace(0.856e9, 1.712e9, NCHAN).astype(F32)
    else:
        freq = (0.8e9 + np.sort(rng.uniform(0, 1e9, NCHAN))).astype(F32)
    lm = rng.uniform(-0.05, 0.05, (NSRC, 2)).astype(F32)
    uvw = rng.normal(0.0, 3000.0, (NROW, 3)).astype(F32)
    image = rng.normal(size=(NSRC, NCHAN, ncorr)).astype(F32)
    vis = (rng.normal(size=(NROW, NCHAN, ncorr))
           + 1j * rng.normal(size=(NROW, NCHAN, ncorr))).astype(np.complex64)
    flags = rng.random((NROW, NCHAN, ncorr)) < 0.02
    return freq, lm, uvw, image, vis, flags


def _operands(kind, grid, ncorr):
    freq, lm, uvw, image, vis, flags = _problem(grid, ncorr)
    values = (image,) if kind == "im_to_vis" else (vis,)
    return values, uvw, lm, freq, () if kind == "im_to_vis" else (flags,)


@functools.lru_cache(maxsize=None)
def _references(kind, grid, ncorr, convention):
    """(the JAX package's public function, the port's float64 route) on
    the float32-rounded inputs carried in float64."""
    values, uvw, lm, freq, flags = _operands(kind, grid, ncorr)
    f64 = [np.asarray(x, np.complex128 if np.iscomplexobj(x) else np.float64)
           for x in (*values, uvw, lm, freq)]
    jax_fn, fn = ((jax_im_to_vis, im_to_vis) if kind == "im_to_vis"
                  else (jax_vis_to_im, vis_to_im))
    want_jax = np.asarray(jax_fn(*f64, *flags, convention=convention))
    want_port = fn(*(_t(x) for x in f64), *(_t(x) for x in flags),
                   convention=convention).numpy()
    assert want_jax.dtype in (np.complex128, np.float64)
    return want_jax, want_port


def _call(kind, grid, ncorr, convention, where):
    """The float32 call on a plan made ``where`` (a key of PLANS), and
    the plan."""
    values, uvw, lm, freq, flags = _operands(kind, grid, ncorr)
    k, delay_max = PLANS[where]
    plan = dft_plan(_t(uvw / F32(k)), _t(lm), freq, ncorr, convention,
                    adjoint=kind == "vis_to_im", delay_max=delay_max)
    fn, dtype = ((im_to_vis, torch.complex64) if kind == "im_to_vis"
                 else (vis_to_im, torch.float32))
    # the float32 route also on the float64 grid, which the plan carries
    out = fn(*(_t(x) for x in values), _t(uvw), _t(lm), freq,
             *(_t(x) for x in flags), convention=convention, dtype=dtype,
             plan=plan)
    return out, plan


@pytest.mark.parametrize("convention", ["fourier", "casa"])
@pytest.mark.parametrize("ncorr", [1, 2, 4])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("where", list(PLANS))
@pytest.mark.parametrize("kind", ["im_to_vis", "vis_to_im"])
def test_port_dft_plan_of_other_baselines_keeps_the_map(kind, where, grid, ncorr,
                                                        convention):
    out, plan = _call(kind, grid, ncorr, convention, where)
    assert out.dtype == (torch.complex64 if kind == "im_to_vis" else torch.float32)
    want_jax, want_port = _references(kind, grid, ncorr, convention)
    got = out.numpy()
    assert _rel(got, want_jax) <= BOUND
    assert _rel(got, want_port) <= BOUND


@pytest.mark.parametrize("ncorr", [1, 2, 4])
@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("kind", ["im_to_vis", "vis_to_im"])
def test_port_dft_plan_of_the_calls_uvw_has_no_far_pair(kind, grid, ncorr):
    """A plan measured on the call's own uvw: every pair within its
    bound, and the output that of the route without the far branch."""
    out, plan = _call(kind, grid, ncorr, "fourier", "uvw/1")
    _, uvw, lm, _, _ = _operands(kind, grid, ncorr)
    hi, _ = phase_dot_cycles(_t(lm), _t(uvw), plan.convention)
    assert not bool((hi.abs() > plan.delay_far).any())
    assert plan.delay_far > plan.delay_max
    for part in [plan, *plan.parts]:
        part.delay_far = float("inf")
    again, _ = _call(kind, grid, ncorr, "fourier", "uvw/1")
    values, uvw, lm, freq, flags = _operands(kind, grid, ncorr)
    fn, dtype = ((im_to_vis, torch.complex64) if kind == "im_to_vis"
                 else (vis_to_im, torch.float32))
    unbranched = fn(*(_t(x) for x in values), _t(uvw), _t(lm), freq,
                    *(_t(x) for x in flags), dtype=dtype, plan=plan)
    assert torch.equal(out, again) and torch.equal(out, unbranched)


@pytest.mark.parametrize("kind", ["im_to_vis", "vis_to_im"])
def test_port_dft_plan_of_shorter_baselines_picks_the_exact_mode(kind):
    """What makes the H1 case a test: on uvw/1000 the plan of the float32
    linspace drops the grid's residual (``exact``), and most pairs of the
    call are beyond its bound."""
    _, plan = _call(kind, "residual", 2, "fourier", "uvw/1000")
    _, own = _call(kind, "residual", 2, "fourier", "uvw/1")
    assert (plan.mode, own.mode) == ("exact", "residual")
    _, uvw, lm, _, _ = _operands(kind, "residual", 2)
    hi, _ = phase_dot_cycles(_t(lm), _t(uvw), plan.convention)
    assert float((hi.abs() > plan.delay_far).float().mean()) >= 0.99


def _compact_step():
    """A SelfcalStep planned on a compact track (uvw/1000: the plans
    drop the linspace's residual), and the full track's uvw."""
    args = selfcal_inputs(nant=16, ntime=2, nchan=16, nsrc=5, ncorr=2, seed=5)
    full = args["uvw"]
    args["uvw"] = full / F32(1000)
    args.update(make_data(args, "cpu"))
    step, data = from_numpy(args, "cpu", npx=16)
    assert step.forward_plan.mode == step.adjoint_plan.mode == "exact"
    return step, data, full


@pytest.mark.parametrize("how", ["in-place", "load_state_dict"])
def test_port_selfcal_step_with_new_uvw_keeps_its_dfts(how):
    step, data, full = _compact_step()
    if how == "in-place":
        step.uvw.copy_(_t(full))
    else:
        step.load_state_dict(dict(step.state_dict(), uvw=_t(full)))
    assert torch.equal(step.uvw, _t(full))
    gains, _, _, dirty, _, _, re_model = step(data)

    freq = step.frequency.numpy()
    want = im_to_vis_oracle_f64(step.image.numpy(), full, step.lm.numpy(), freq)
    assert _rel(re_model.numpy(), want) <= BOUND
    # the residual image, as the step makes it, against float64
    meta = (step.time_bin_indices, step.time_bin_counts, step.antenna1,
            step.antenna2)
    resid = (data - corrupt_vis(*meta, gains, step.model)).sum(dim=-1, keepdim=True)
    im = vis_to_im(resid, step.uvw, step.grid_lm, step.frequency,
                   step.flag[..., :1], plan=step.adjoint_plan)
    want = vis_to_im_oracle_f64(resid.numpy(), full, step.grid_lm.numpy(), freq)
    assert _rel(im.numpy(), want) <= BOUND
    nvis = data.shape[0] * data.shape[1]
    assert torch.equal(dirty, im.sum(dim=(1, 2)).reshape(16, 16) / nvis)
