"""The w-gridder's plane-blocked w-stack (``gridding/wgridder/core.py``)
on the CPU, against the plain float64 sums of
``perfbench/reference/imaging.py`` and against itself run as one block.

The problem: a 128² image at 4e-4 rad, 64 rows × 8 channels at ε = 1e-5
(W = 8 taps each way), w in two clusters ±(3–5)k λ at the top channel:
a stack of ~36 planes (dw ≈ 380 λ) whose middle planes no window meets. Blocks are
forced by the free memory the plan reads: the whole stack, 4 planes and 5
planes, so that every window (8 planes) straddles one or two block
boundaries.

Bounds, each with its reason:
- against the reference: ≤ 2ε of max. The gridder's kernel at W = 8 is
  accurate to ~1e-7 (core._kernel_params); its float32 taps, FFTs and
  sums add ~1e-6 of max; ε is the accuracy asked for, and a factor 2
  covers the max norm over the l2 one the kernel is sized by;
- blocked against one block: ≤ 1e-6 of max: the same float32 taps and
  FFT planes, a straddling sample's parts summed in another order
  (float32 rounding, ~1e-7, over a few taps);
- one sample's taps over blocks: exactly equal (float64; a deposit is
  the same product whichever block makes it, and each is made once);
- adjointness when blocked: ≤ 1e-5 relative, as
  ``tests/test_torch_wgridder.py`` holds the one-block float32 pair.
"""

import numpy as np
import pytest
import torch

from africanus_tpu_torch.gridding.wgridder import api, core
from africanus_tpu_torch.ops.cuda_wgrid import degrid_wstack, grid_wstack
from africanus_tpu_torch.utils.plancache import LRUCache
from perfbench.reference import imaging as ref

NX, CELL, EPS, NROW, NCHAN = 128, 4e-4, 1e-5, 64, 8
FREQ = np.linspace(1.0e9, 1.4e9, NCHAN)
BLOCKS = [None, 4, 5]  # None: the whole stack


def _problem():
    rng = np.random.default_rng(26)
    lam = ref.LIGHTSPEED / FREQ[-1]
    umax = 0.45 / CELL * lam                      # within the grid's Nyquist
    uvw = np.empty((NROW, 3))
    uvw[:, :2] = rng.uniform(-umax, umax, (NROW, 2))
    w = rng.uniform(3e3, 5e3, NROW) * lam
    uvw[:, 2] = np.where(np.arange(NROW) % 2, w, -w)
    vis = rng.normal(size=(NROW, NCHAN)) + 1j * rng.normal(size=(NROW, NCHAN))
    image = np.zeros((NX, NX))
    pix = rng.choice(NX * NX, 40, replace=False)
    image.reshape(-1)[pix] = rng.uniform(0.1, 1.0, 40)
    return uvw, vis.astype(np.complex64), image.astype(np.float32)


UVW, VIS, IMAGE = _problem()


def _force(monkeypatch, plan, planes):
    """Have ``plan`` read a free memory that holds blocks of ``planes``
    planes (None: the whole stack, with room to spare); for blocks, the
    plan lets the whole stack's screens go, as a plan built at that free
    memory has not kept them."""
    if planes is None:
        free = 1e15
    else:
        per = core.block_bytes(plan, 1) - core.block_bytes(plan, 0)
        free = (core.block_bytes(plan, planes) + per / 2) / core.MEMORY_SHARE
        plan.screen.stack = None
    monkeypatch.setattr(core, "free_bytes", lambda device: free)


def _fresh_plan(monkeypatch):
    """The problem's float32 plan, fresh in a fresh make_plan cache (so
    that no run keeps another's blocks)."""
    monkeypatch.setattr(core, "_MAKE_PLAN_CACHE", LRUCache(4))
    return core.make_plan(UVW, FREQ, NX, NX, CELL, CELL, EPS, device="cpu")


@pytest.fixture
def plan(monkeypatch):
    return _fresh_plan(monkeypatch)


def _run(op, monkeypatch, planes):
    """``op`` through the api on a fresh plan in blocks of ``planes``:
    (output, blocks of the plan's layout)."""
    plan = _fresh_plan(monkeypatch)
    _force(monkeypatch, plan, planes)
    image = torch.as_tensor(IMAGE)[None]
    if op == "grid":
        out = api.dirty(UVW, FREQ, torch.as_tensor(VIS), [0], [NCHAN], NX, NX, CELL,
                        epsilon=EPS)
    elif op == "degrid":
        out = api.model(UVW, FREQ, image, [0], [NCHAN], CELL, epsilon=EPS)
    else:
        out = api.residual(UVW, FREQ, image, torch.as_tensor(VIS), [0], [NCHAN], CELL,
                           epsilon=EPS)
    return out.numpy(), 1 if plan.layout is None else len(plan.layout)


def _reference(op):
    uvw = torch.as_tensor(UVW)
    freq = torch.as_tensor(FREQ)
    nz = torch.as_tensor(np.flatnonzero(IMAGE))
    comps = ref.pixel_lm(nz, NX, NX, CELL)
    model = ref.model_rows(comps, torch.as_tensor(IMAGE.reshape(-1)[nz.numpy()]),
                           uvw, freq)
    if op == "degrid":
        return model.numpy()
    vis = torch.as_tensor(VIS).to(torch.complex128)
    if op == "residual":
        vis = vis - model
    lm = ref.pixel_lm(torch.arange(NX * NX), NX, NX, CELL)
    return ref.dirty_pixels(vis, uvw, freq, lm).reshape(1, NX, NX).numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_the_problem_is_a_stack_with_untouched_planes(plan):
    touched = plan.touched()
    assert plan.nplanes >= 12 and plan.support == 8
    inner = np.flatnonzero(touched)
    assert not touched[inner[0]:inner[-1]].all()  # a gap between the clusters


@pytest.mark.parametrize("planes", BLOCKS)
@pytest.mark.parametrize("op", ["grid", "degrid", "residual"])
def test_blocked_stack_matches_reference_and_one_block(op, planes, monkeypatch):
    got, blocks = _run(op, monkeypatch, planes)
    assert blocks == 1 if planes is None else blocks > 2
    assert _rel(got, _reference(op)) <= 2 * EPS
    one, _ = _run(op, monkeypatch, None)
    assert _rel(got, one) <= 1e-6


def test_a_straddling_sample_deposits_and_gathers_each_tap_once(monkeypatch):
    """One sample whose window covers planes of three 4-plane blocks: the
    blocks' grids, laid back at their planes, are the whole stack's grid
    bit for bit; its gathered parts add up to the whole stack's gather."""
    freq = np.array([1.2e9])
    lam = ref.LIGHTSPEED / freq[0]
    dw = core.plan_geometry(np.eye(3), freq, 32, 32, 1e-3, 1e-3, EPS)["dw"]
    # the first sample starts the run of touched planes (and its first
    # block); the second's window starts two planes further on
    uvw = np.array([[0.0, 0.0, 0.0], [100.0, -50.0, 2.3 * dw * lam],
                    [0.0, 0.0, 20 * dw * lam]])
    plan = core.build_plan(uvw, freq, 32, 32, 1e-3, 1e-3, EPS, dtype=torch.float64,
                           device="cpu")
    blocks = plan.plane_blocks(4)
    p0 = plan.wgrid.p0[plan.wgrid.order.argsort()]
    assert int(p0[1]) == int(p0[0]) + 2
    meets = [b for b in blocks if b.first < p0[1] + 8 and b.first + b.count > p0[1]]
    assert len(meets) == 3
    vis = torch.tensor([0.0, 1.0 - 2.0j, 0.0], dtype=torch.complex128)
    whole = grid_wstack(plan.wgrid, vis)
    stack = torch.zeros_like(whole)
    for b in blocks:
        part = grid_wstack(b.wgrid, vis.index_select(0, b.samples))
        assert not part[b.count:].any()       # nothing past the block's planes
        stack[b.first:b.first + b.count] += part[:b.count]
    assert torch.equal(stack, whole)
    grid = torch.randn(whole.shape, dtype=torch.float64) + 0j
    want = degrid_wstack(plan.wgrid, grid)
    got = torch.zeros_like(want)
    for b in blocks:
        g = torch.zeros((b.wgrid.nplanes,) + tuple(grid.shape[1:]), dtype=grid.dtype)
        g[:b.count] = grid[b.first:b.first + b.count]
        got[b.samples] += degrid_wstack(b.wgrid, g)
    assert torch.allclose(got, want, rtol=1e-13, atol=0)


def test_untouched_planes_are_skipped_and_change_nothing(plan, monkeypatch):
    touched = plan.touched()
    blocks = plan.plane_blocks(5)
    covered = np.zeros(plan.nplanes, bool)
    for b in blocks:
        assert touched[b.first:b.first + b.count].all()
        assert not covered[b.first:b.first + b.count].any()
        covered[b.first:b.first + b.count] = True
    assert np.array_equal(covered, touched)
    # an untouched plane's grid is zero: the one-block stack holds nothing there
    vis = torch.as_tensor(VIS).reshape(-1)
    grid = grid_wstack(plan.wgrid, vis)
    assert not grid[torch.as_tensor(~touched)].any()


@pytest.mark.parametrize("planes", [4, 5])
def test_blocked_pair_is_adjoint(planes, plan, monkeypatch):
    _force(monkeypatch, plan, planes)
    image = torch.as_tensor(np.random.default_rng(5).normal(size=(NX, NX)).astype(np.float32))
    vis = torch.as_tensor(VIS)
    dirty = core.grid_adjoint(UVW, FREQ, vis, None, NX, NX, CELL, CELL, EPS, plan=plan)
    model = core.degrid(UVW, FREQ, image, None, CELL, CELL, EPS, plan=plan)
    assert plan.layout is not None and len(plan.layout) > 2
    lhs = float((dirty.double() * image.double()).sum())
    rhs = float((model.conj().to(torch.complex128) * vis.to(torch.complex128)).real.sum())
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


@pytest.mark.parametrize("planes", [None, 5])
def test_spans_and_counts_while_profiling(planes, monkeypatch):
    """A profiled residual in blocks of ``planes`` planes: its band is the
    span ``wgridder.residual``, and inside it, for the whole stack or each
    block, ``wgridder.degrid`` then ``wgridder.grid`` with their
    ``wgridder.transform`` spans; ImagingPlan's counts (a call a direction,
    its blocks and planes) move only while the profiler records, and the
    outputs are those of an unprofiled call, bit for bit."""
    plan = _fresh_plan(monkeypatch)
    _force(monkeypatch, plan, planes)
    image, vis = torch.as_tensor(IMAGE)[None], torch.as_tensor(VIS)

    def call():
        return api.residual(UVW, FREQ, image, vis, [0], [NCHAN], CELL, epsilon=EPS)

    counts = [core.ImagingPlan.calls, core.ImagingPlan.blocks, core.ImagingPlan.planes]
    before = [c.value for c in counts]
    plain = call()
    assert [c.value for c in counts] == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = call()
    assert torch.equal(plain, traced)
    names = [e.name for e in prof.events() if e.name.startswith("wgridder.")]
    nblocks = 1 if planes is None else len(plan.layout)
    assert names.count("wgridder.residual") == 1
    assert names.count("wgridder.degrid") == names.count("wgridder.grid") == nblocks
    assert names.index("wgridder.degrid") < names.index("wgridder.grid")
    assert "wgridder.transform" in names
    nplanes = plan.nplanes if planes is None else int(plan.touched().sum())
    assert [c.value - b for c, b in zip(counts, before)] == [2, 2 * nblocks, 2 * nplanes]


def test_a_stack_that_fits_is_planned_whole_with_its_screens(monkeypatch):
    """A plan built where its stack fits holds the whole stack's
    ``WGridPlan`` and phase screens, and runs whole from then on, whatever
    free memory a call reads: the screens those a block makes for
    itself, bit for bit. A plan built where the stack does not fit keeps
    no screens and holds its blocks."""
    monkeypatch.setattr(core, "free_bytes", lambda device: 1e15)
    plan = _fresh_plan(monkeypatch)
    assert "whole" in plan._modules and plan.screen.stack is not None
    kept = plan.screen.stack
    monkeypatch.setattr(core, "free_bytes", lambda device: 1.0)
    core.degrid(UVW, FREQ, torch.as_tensor(IMAGE), None, CELL, CELL, EPS, plan=plan)
    assert plan.screen.stack is kept and plan.layout is None
    plan.screen.stack = None
    assert torch.equal(plan.screen(0, plan.nplanes), kept)
    assert torch.equal(plan.screen(3, 4), kept[3:7])
    blocked = _fresh_plan(monkeypatch)
    assert blocked.screen.stack is None and "whole" not in blocked._modules
    assert len(blocked.layout) > 2


def test_a_block_of_fewer_planes_than_a_window(plan):
    """A block of fewer than W planes runs on a stack of W (its
    ``WGridPlan`` holds a whole window): its degridding stack is the
    block's planes then zero planes, and ``block_bytes`` counts W grid
    planes for it."""
    img = core._tapered(plan, torch.as_tensor(IMAGE))
    planes = core._stack_of(plan, img, 3, 4)
    padded = core._stack_of(plan, img, 3, 4, plan.support)
    assert padded.shape[0] == plan.support
    assert torch.equal(padded[:4], planes) and not padded[4:].any()
    grid, crop = plan.nu * plan.nv * 8, plan.nx * plan.ny * 8
    w = plan.support
    assert core.block_bytes(plan, 1) - core.block_bytes(plan, 0) == 2 * grid + 3 * crop
    assert core.block_bytes(plan, w + 1) - core.block_bytes(plan, w) == 3 * grid + 3 * crop
