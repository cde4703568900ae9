"""The fused RIME's direction-dependent predict, ``[Ep, Lp, Kpq, Gpq,
Bpq, Lq, Eq]``, on the CPU at a small size: against the plain float64
reference (``testing/dde_reference.py``), the reference against the JAX
package's fused RIME, the source block the core chooses from a memory
budget, and the core's spans and counters.

Bounds: the port in float64 1e-10 of max against the reference (the same
formulas in another order); in float32 2e-6 of max against the reference
of the same float32 inputs: the float32 rounding of the beam's trilinear
weights and normalisation, the two-float phase, the chain's products and
the compensated source sum, which read 2.0e-7 to 4.4e-7 over seven seeds
of both routes (the float32 rounding of uvw and lm alone moves a phase of
thousands of radians by ~1e-4, hence the same inputs); blocks of the
chosen size equal the one-grid evaluation to 1e-12 of max in float64 and
4e-7 in float32 (a Kahan sum over blocks against the pairwise tree).
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from africanus_tpu.ops.cplx import to_numpy
from africanus_tpu.rime.fused import rime as jax_rime
from africanus_tpu_torch.rime.fused import RimeFactory, core, rime
from africanus_tpu_torch.testing.dde_reference import analytic_beam, dde_predict
from africanus_tpu_torch.utils import profiling

SPEC = "[Ep, Lp, Kpq, Gpq, Bpq, Lq, Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]"
BAND = (856e6, 1712e6)
F64_BOUND, F32_BOUND = 1e-10, 2e-6


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def problem(seed=5, nsrc=4, ntime=2, nant=6, nchan=16, route="cell"):
    """Numpy arguments of ``rime`` and the reference's dicts. ``route``
    "cell": the cube spans the band, pointing errors and scalings the same
    in every channel (the benchmark cell's route); "general": channels
    beyond both ends of the cube and per-channel pointing errors."""
    rng = np.random.default_rng(seed)
    a1, a2 = np.triu_indices(nant, 1)
    nbl = a1.size
    freq = np.linspace(*BAND, nchan)
    fmap = np.linspace(*BAND, 5)
    if route == "general":
        fmap = np.linspace(0.95e9, 1.6e9, 5)
    beam = analytic_beam(33, 0.05, fmap, 57.5 / 60 * np.pi / 180, 1.5e9,
                         0.02, 0.02).numpy()
    pa = rng.uniform(-np.pi, np.pi, ntime)[:, None].repeat(nant, 1)
    pe = rng.normal(scale=1e-4, size=(ntime, nant, 1, 2))
    pe = pe + np.zeros((1, 1, nchan, 1))
    if route == "general":
        pe = pe + rng.normal(scale=1e-4, size=(ntime, nant, nchan, 2))
    asc = (1 + rng.normal(scale=0.01, size=(nant, 1, 2))) + np.zeros((1, nchan, 1))
    feed = np.stack([np.sin(pa), np.cos(pa)], -1)[:, None, :, None, :].repeat(2, 3)
    args = dict(
        time=np.repeat(5.03e9 + 8.0 * np.arange(ntime), nbl),
        antenna1=np.tile(a1, ntime), antenna2=np.tile(a2, ntime),
        uvw=rng.uniform(-4000, 4000, (ntime * nbl, 3)), chan_freq=freq,
        lm=rng.uniform(-0.02, 0.02, (nsrc, 2)),
        stokes=np.column_stack([rng.uniform(0.1, 1, nsrc), rng.uniform(-0.05, 0.05, nsrc),
                                rng.uniform(-0.05, 0.05, nsrc), np.zeros(nsrc)]),
        spi=rng.normal(-0.7, 0.2, (nsrc, 1, 1)).repeat(4, 2),
        ref_freq=np.full(nsrc, 1.284e9),
        gauss_shape=np.column_stack([rng.uniform(1e-5, 3e-4, nsrc),
                                     rng.uniform(1e-5, 1e-4, nsrc),
                                     rng.uniform(0, np.pi, nsrc)]),
        beam=beam, beam_lm_extents=np.array([[-0.05, 0.05], [-0.05, 0.05]]),
        beam_freq_map=fmap, beam_parangle=pa, beam_point_errors=pe,
        beam_antenna_scaling=asc, feed_parangle=feed)
    return args


def reference(args):
    """The reference's visibilities of ``problem``'s arguments."""
    t = {k: torch.as_tensor(v) for k, v in args.items()}
    time_index = torch.as_tensor(np.unique(args["time"], return_inverse=True)[1])
    sky = {k: t[k] for k in ("lm", "stokes", "spi", "ref_freq", "gauss_shape")}
    rows = dict(uvw=t["uvw"], time=time_index, antenna1=t["antenna1"],
                antenna2=t["antenna2"])
    beam = dict(beam=t["beam"], extents=t["beam_lm_extents"],
                freq_map=t["beam_freq_map"], parangle=t["beam_parangle"],
                feed_angle=t["beam_parangle"], point_errors=t["beam_point_errors"],
                antenna_scaling=t["beam_antenna_scaling"])
    return dde_predict(sky, rows, t["chan_freq"], beam).numpy()


def float32(args):
    """The arguments as the benchmark passes them: floats float32, the
    beam complex64; the host columns as they are."""
    out = {}
    for k, v in args.items():
        if k in ("time", "antenna1", "antenna2"):
            out[k] = v
        elif np.iscomplexobj(v):
            out[k] = torch.as_tensor(v.astype(np.complex64))
        else:
            out[k] = torch.as_tensor(v.astype(np.float32))
    return out


@pytest.mark.parametrize("route", ["cell", "general"])
def test_port_matches_reference(route):
    args = problem(route=route)
    want = reference(args)
    got = rime(SPEC, **args, device="cpu")
    assert got.dtype == torch.complex128 and tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= F64_BOUND
    args32 = float32(args)
    got32 = rime(SPEC, **args32)
    assert got32.dtype == torch.complex64
    # held to the reference of the same float32 inputs
    want32 = reference({k: (v.numpy().astype(np.complex128 if v.is_complex() else np.float64)
                            if isinstance(v, torch.Tensor) else v)
                        for k, v in args32.items()})
    assert _rel(got32.numpy(), want32) <= F32_BOUND


def test_omissions_are_far_from_the_reference():
    """The pieces the benchmark's controls leave out move the result far
    beyond the float32 bound: E's off-diagonals and the pointing errors."""
    args = problem(seed=8)
    want = reference(args)
    no_leak = dict(args, beam=args["beam"] * np.eye(2))
    no_point = dict(args, beam_point_errors=np.zeros_like(args["beam_point_errors"]))
    assert _rel(reference(no_leak), want) > 20 * F32_BOUND
    assert _rel(reference(no_point), want) > 5 * F32_BOUND


@pytest.mark.parametrize("route", ["cell", "general"])
def test_reference_matches_jax(route):
    args = problem(seed=6, route=route)
    want = to_numpy(jax_rime(SPEC, args))
    assert _rel(reference(args), want) <= F64_BOUND


def _peak_bytes(fn):
    """(fn(), the CPU allocator's peak above its level when fn started),
    from a memory-profiled trace."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                profile_memory=True) as prof:
        out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            mem = [e["args"] for e in json.load(f)["traceEvents"]
                   if e.get("name") == "[memory]"]
    finally:
        os.unlink(path)
    base = mem[0]["Total Allocated"] - mem[0]["Bytes"]
    return out, max(m["Total Allocated"] for m in mem) - base


def _free(monkeypatch, budget):
    """Make ``budget`` the share of the free memory a block may take."""
    monkeypatch.setattr(core, "free_bytes", lambda device: budget / core.MEMORY_SHARE)


def test_chosen_block_stays_within_its_budget(monkeypatch):
    """Free memory of a few blocks' bytes, no block given: the chosen
    block's evaluation stays within the share it may take and within the
    core's estimate."""
    args = float32(problem(seed=7, nsrc=6, ntime=2, nant=8, nchan=64))
    factory = RimeFactory(SPEC)
    state = factory.build_state(device="cpu", **args)
    per = factory.evaluation_bytes(state, 2) - factory.evaluation_bytes(state, 1)
    chosen = []
    for budget in (factory.evaluation_bytes(state, 2) + per // 2,
                   factory.evaluation_bytes(state, 3) + per // 3,
                   factory.evaluation_bytes(state, 6)):
        _free(monkeypatch, budget)
        block = factory.source_block(state, budget)
        _, peak = _peak_bytes(lambda: factory.evaluate(state))
        assert peak <= budget
        assert peak <= factory.evaluation_bytes(state, block) + (1 << 16)
        chosen.append(block)
    assert chosen == [2, 3, 6]
    # 6 sources at most 5 a block: two blocks of 3, not 5 and a padded 1
    assert factory.source_block(state, factory.evaluation_bytes(state, 5)) == 3


@pytest.mark.parametrize("spec", [SPEC, "(Kpq, Gpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"])
@pytest.mark.parametrize("block", [5, None])
def test_estimate_bounds_the_peak(spec, block):
    """The core's estimate of an evaluation's bytes bounds what it takes,
    in blocks (the block's sums beside its chain) and in one grid (the
    pairwise tree's temporaries beside the chain), with a specification
    whose sum outweighs its chain (K·G·B) and one whose chain outweighs
    its sum (the DDE)."""
    factory = RimeFactory(spec)
    state = factory.build_state(device="cpu", **float32(problem(seed=11, nsrc=9)))
    _, peak = _peak_bytes(lambda: factory.evaluate(state, source_block=block))
    assert peak <= factory.evaluation_bytes(state, block) + (1 << 16)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chosen_block_equals_one_grid(monkeypatch, dtype):
    """With no block given and too little free memory for one grid of
    every source, the core evaluates in the block it chooses: the same
    bits as that block given by hand, and the one-grid sum to ulps."""
    args = problem(seed=9, nsrc=6)
    if dtype == "float32":
        args = float32(args)
    factory = RimeFactory(SPEC)
    state = factory.build_state(device="cpu", **args)
    one_grid = factory.evaluate(state)
    budget = factory.evaluation_bytes(state, 4)
    assert budget < factory.evaluation_bytes(state, None)
    _free(monkeypatch, budget)
    block = factory.source_block(state, budget)
    assert block == 3
    chosen = factory.evaluate(state)
    assert torch.equal(chosen, factory.evaluate(state, source_block=block))
    assert _rel(chosen.numpy(), one_grid.numpy()) <= (1e-12 if dtype == "float64" else 4e-7)


def _spans(prof):
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith("fused."))


def test_spans_and_counters_under_a_profiler():
    """Each call is one ``fused.call`` around ``fused.state`` and a
    ``fused.sample`` and ``fused.sum`` a block; the class's counters count
    the calls, blocks and state seconds while the profiler records, and
    nothing after; outputs are the same bits either way."""
    args = float32(problem(seed=10, nsrc=5))
    plain = rime(SPEC, **args, source_block=2)
    counts = (RimeFactory.calls.value, RimeFactory.blocks.value,
              RimeFactory.state_seconds.value)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = [rime(SPEC, **args, source_block=2) for _ in range(2)]
    assert all(torch.equal(o, plain) for o in outs)
    spans = _spans(prof)
    names = [n for _, _, n in spans]
    assert names.count("fused.call") == 2 and names.count("fused.state") == 2
    assert names.count("fused.sample") == 6 and names.count("fused.sum") == 6
    for s, e, n in spans:  # every stage inside a call
        if n != "fused.call":
            assert any(cs <= s and e <= ce for cs, ce, cn in spans if cn == "fused.call")
    assert RimeFactory.calls.value - counts[0] == 2
    assert RimeFactory.blocks.value - counts[1] == 6
    assert RimeFactory.state_seconds.value > counts[2]

    after = (RimeFactory.calls.value, RimeFactory.blocks.value,
             RimeFactory.state_seconds.value)
    assert profiling.span("fused.call") is profiling.span("fused.sum")
    assert torch.equal(rime(SPEC, **args, source_block=2), plain)
    assert (RimeFactory.calls.value, RimeFactory.blocks.value,
            RimeFactory.state_seconds.value) == after
