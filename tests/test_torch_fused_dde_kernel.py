"""The fused RIME's kernel route on the CPU: the rule that picks it, the
row plan and source block it takes, and the kernel's plain PyTorch
version (``ops/cuda_fused.fused_dde_reference``, what ``fused_dde`` runs
on CPU tensors) driven through the route's own operands.

The route is taken only on a CUDA state, so here ``RimeFactory``'s
kernel evaluation is called directly with the flags the rule gives for
the specification on a card. Bounds: against the plain float64
reference of the same float32 inputs 2e-6 of max (the bound of
``test_torch_dde_predict.py``: the float32 beam, the two-float phase, the
chain and the compensated sum); against the eager chain 1e-6 of max (the
same terms factored otherwise, a Kahan sum over sources against the
two-float pairwise tree); source blocks equal one block bit for bit (the
sum and its compensation carried from block to block).
"""

import numpy as np
import pytest
import torch

from africanus_tpu_torch.examples.custom_rime_term import ModelFlux
from africanus_tpu_torch.ops import cuda_fused
from africanus_tpu_torch.rime.fused import RimeFactory, RimeSpecification, core
from africanus_tpu_torch.rime.fused.terms import Phase
from test_torch_dde_predict import F32_BOUND, SPEC, _rel, float32, problem, reference

CORRS = {"linear": "[I,Q,U,V] -> [XX,XY,YX,YY]", "circular": "[I,Q,U,V] -> [RR,RL,LR,LL]"}
EAGER_BOUND = 1e-6
F32 = torch.float32


class MyPhase(Phase):
    """A subclass of a built-in term: the eager chain's."""


def _route(spec, device="cuda", dtype=F32, corrs=4, terms=None):
    return core.kernel_route(RimeSpecification(spec, terms=terms), device, dtype, corrs)


R = cuda_fused.Route


@pytest.mark.parametrize("spec,kw,want", [
    (SPEC, {}, R(True, True, True, False)),
    ("[Lp, Ep, Kpq, Gpq, Bpq, Eq, Lq]: " + CORRS["linear"], {}, R(True, True, True, True)),
    ("[Ep, Kpq, Gpq, Bpq, Eq]: " + CORRS["linear"], {}, R(True, False, True)),
    ("[Lp, Kpq, Bpq, Lq]: " + CORRS["circular"], {}, R(False, True, False)),
    ("(Kpq, Bpq): " + CORRS["linear"], {}, R(False, False, False)),
    ("(Kpq, Gpq, Bpq): " + CORRS["linear"], {}, R(False, False, True)),
    ("(Gpq, Bpq, Kpq): " + CORRS["linear"], {}, R(False, False, True)),
    (SPEC, {"dtype": torch.float64}, None),
    (SPEC, {"dtype": None}, None),
    (SPEC, {"device": "cpu"}, None),
    ("[Ep, Lp, Kpq, Gpq, Bpq, Eq, Lq]: " + CORRS["linear"], {}, None),
    ("(Kpq, Gpq, Gpq, Bpq): " + CORRS["linear"], {}, None),
    (SPEC, {"corrs": 2}, None),
    ("(Kpq, Bpq): [I,Q] -> [XX,YY]", {}, None),
    ("(Kpq, Cpq): " + CORRS["linear"], {"terms": {"C": ModelFlux}}, None),
    ("(Kpq, Bpq): " + CORRS["linear"], {"terms": {"K": MyPhase}}, None),
    ("[Ep, Lp, Kpq, Bpq, Eq, Lq]: " + CORRS["linear"], {}, None),
    ("[Ep, Kpq, Bpq]: " + CORRS["linear"], {}, None),
    ("[Ep, Kpq, Kpq, Bpq, Eq]: " + CORRS["linear"], {}, None),
    ("[Kpq, Ep, Bpq, Eq]: " + CORRS["linear"], {}, None),
])
def test_port_kernel_route_rule(spec, kw, want):
    assert _route(spec, **kw) == want


def test_port_route_reads_the_state(monkeypatch):
    """``RimeFactory.route`` passes the rule the state's device, its one
    real dtype and the beam's correlations; a CPU state takes the eager
    chain."""
    seen = []
    real = core.kernel_route
    monkeypatch.setattr(core, "kernel_route",
                        lambda *a: seen.append(a[1:]) or real(*a))
    args = float32(problem(seed=3, nant=6))
    factory = RimeFactory(SPEC)
    assert factory.route(factory.build_state(device="cpu", **args)) is None
    assert seen[-1] == (torch.device("cpu"), F32, 4)
    mixed = dict(args, uvw=args["uvw"].double())
    factory.route(factory.build_state(device="cpu", **mixed))
    assert seen[-1][1] is None


@pytest.mark.parametrize("ntime,nrow,nstat", [(1, 1, 4), (3, 300, 9), (5, 1000, 64),
                                               (2, 128, 7), (2, 4000, 394), (1, 500, 0)])
def test_port_row_plan(ntime, nrow, nstat):
    """Every row once; each tile of one dump, at most ROWS rows and
    MAX_STATIONS stations, and its rows' stations found through their
    local indices; a dump's rows cut into ROWS-row tiles where their
    stations fit, and in halves where they do not (394 random stations);
    no stations where the chain has no Jones (``nstat`` 0)."""
    rng = np.random.default_rng(nrow)
    t = rng.integers(0, ntime, nrow)
    left = right = None
    if nstat:
        left, right = rng.integers(0, nstat, nrow), rng.integers(0, nstat, nrow)
    order, tiles, stations, local = cuda_fused.row_plan(t, left, right)
    assert sorted(order.tolist()) == list(range(nrow))
    assert all(x.dtype == np.int32 for x in (order, tiles, stations, local))
    covered = []
    for i, (first, count, dump, nst) in enumerate(tiles):
        assert 1 <= count <= cuda_fused.ROWS
        rows = order[first:first + count]
        assert (t[rows] == dump).all()
        covered += rows.tolist()
        if not nstat:
            assert nst == 0 and not local.any()
            continue
        assert 1 <= nst <= cuda_fused.MAX_STATIONS
        mine = stations[i, :nst]
        assert (np.diff(mine) > 0).all()
        lp, lq = local[first:first + count] & 0xFFFF, local[first:first + count] >> 16
        assert (mine[lp] == left[rows]).all() and (mine[lq] == right[rows]).all()
        assert set(mine) == set(left[rows]) | set(right[rows])
    assert list(covered) == order.tolist()
    full = sum(-(-np.sum(t == d) // cuda_fused.ROWS) for d in range(ntime))
    assert len(tiles) == full if nstat <= cuda_fused.MAX_STATIONS else len(tiles) > full


def _kernel(spec, args, block=None):
    """The kernel route's evaluation of ``args`` (float32, on the CPU),
    with the flags ``spec`` takes on a card."""
    factory = RimeFactory(spec)
    state = factory.build_state(device="cpu", **args)
    route = core.kernel_route(factory.rime_spec, "cuda", F32)
    assert route is not None
    state["free_bytes"] = 1 << 40
    return factory._evaluate_kernel(state, route, block), factory, state


def _f64(args):
    return {k: (v.numpy().astype(np.complex128 if v.is_complex() else np.float64)
                if isinstance(v, torch.Tensor) else v) for k, v in args.items()}


@pytest.mark.parametrize("shape", ["gaussian", "point"])
@pytest.mark.parametrize("block", [None, 2])
def test_port_kernel_route_matches_reference(shape, block):
    """The DDE specification's kernel route (its plain version) against
    the float64 reference of the same float32 inputs; point sources as the
    specification without G, the reference's envelope at zero size."""
    args = float32(problem(seed=12, nsrc=5))
    spec = SPEC
    if shape == "point":
        args["gauss_shape"] = torch.zeros_like(args["gauss_shape"])
        spec = SPEC.replace("Gpq, ", "")
    got, _, _ = _kernel(spec, args, block)
    assert got.dtype == torch.complex64
    assert _rel(got.numpy(), reference(_f64(args))) <= F32_BOUND


def _feeds(args, nfeed, seed):
    """Two feeds with their own receptor angles, drawn per row and side."""
    rng = np.random.default_rng(seed)
    nrow = args["uvw"].shape[0]
    pa = args["beam_parangle"].numpy()[:, None, :] + rng.uniform(0, 1, (1, nfeed, 1))
    a, b = pa, pa + rng.uniform(0, 0.3, (1, nfeed, 1))
    feed = np.stack([np.stack([np.sin(a), np.cos(a)], -1),
                     np.stack([np.sin(b), np.cos(b)], -1)], -2)
    return dict(args, feed1=rng.integers(0, nfeed, nrow), feed2=rng.integers(0, nfeed, nrow),
                feed_parangle=torch.as_tensor(feed.astype(np.float32)))


@pytest.mark.parametrize("feed", ["linear", "circular"])
@pytest.mark.parametrize("convention", ["fourier", "casa"])
@pytest.mark.parametrize("left", ["[Ep, Lp", "[Lp, Ep", "[Lp", "[Ep", "("])
@pytest.mark.parametrize("shape", ["gaussian", "point"])
def test_port_kernel_route_matches_eager(feed, convention, left, shape):
    """The kernel route against the eager chain of the same state: linear
    and circular feeds, both conventions, every left side the kernel
    takes, gaussian and point sources (the specification with and
    without G), two feeds with feed1 ≠ feed2, 7 sources in blocks of 3
    (an odd last block), equal bit for bit to one block."""
    right = {"[Ep, Lp": "Lq, Eq]", "[Lp, Ep": "Eq, Lq]", "[Lp": "Lq]", "[Ep": "Eq]",
             "(": ")"}[left]
    middle = "Kpq, Gpq, Bpq" if shape == "gaussian" else "Kpq, Bpq"
    if left == "(":
        spec = f"({middle}): {CORRS[feed]}"
    else:
        spec = f"{left}, {middle}, {right}: {CORRS[feed]}"
    args = _feeds(float32(problem(seed=13, nsrc=7, ntime=3, nant=5)), 2, seed=14)
    args["convention"] = convention
    got, factory, state = _kernel(spec, args, 3)
    eager = factory.evaluate(state)
    assert _rel(got.numpy(), eager.numpy()) <= EAGER_BOUND
    one, _, _ = _kernel(spec, args, 7)
    assert torch.equal(got, one)


def test_port_kernel_block_rule():
    """The kernel route's block: every source where the route's bytes fit
    the budget, else the largest block that fits with the compensation
    buffer, made even over the blocks, at least 1."""
    args = float32(problem(seed=15, nsrc=9))
    factory = RimeFactory(SPEC)
    state = factory.build_state(device="cpu", **args)
    route = core.kernel_route(factory.rime_spec, "cuda", F32)
    shared, per = factory._kernel_lines(state, route)
    comp = state["uvw"].shape[0] * state["chan_freq"].shape[0] * 32
    assert factory.kernel_bytes(state, 9, route) == shared + 9 * per
    assert factory.kernel_bytes(state, 4, route) == shared + comp + 4 * per
    assert comp < 4 * per  # so a budget of comp + 5 blocks leaves out 9 sources
    for budget, want in ((shared + 9 * per, 9), (shared + comp + 5 * per, 5),
                         (shared + comp + 4.5 * per, 3), (shared + comp + per, 1),
                         (shared, 1)):
        assert factory._kernel_block(state, route, budget) == want


@pytest.mark.parametrize("convention", ["fourier", "casa"])
def test_port_pairs_plain_version(convention):
    """The pairs' plain version is the eager prologue's two functions:
    ``phase_dot_cycles`` and ``envelope_coordinates``, stacked; zeros
    without an envelope."""
    from africanus_tpu_torch.model.shape.gaussian_shape import envelope_coordinates
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    args = float32(problem(seed=16, nsrc=6))
    lm, uvw, shape = args["lm"], args["uvw"], args["gauss_shape"]
    got = cuda_fused.fused_pairs(lm, uvw, shape, convention)
    hi, lo = phase_dot_cycles(lm, uvw, convention)
    u1, v1 = envelope_coordinates(uvw, shape)
    assert torch.equal(got, torch.stack([hi, lo, u1, v1], -1))
    bare = cuda_fused.fused_pairs(lm, uvw, None, convention)
    assert torch.equal(bare[..., :2], got[..., :2]) and not bare[..., 2:].any()
