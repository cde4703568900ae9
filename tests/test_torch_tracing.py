"""The port's profiler spans and counters (``utils.profiling.span``,
``DeviceCount``, ``hogbom_clean.taken`` and ``SelfcalStep.plan_seconds``),
on the CPU at small sizes.

Under a ``torch.profiler`` each entry's Chrome trace holds its stage
spans nested in its ``*.call`` span; with no profiler a span is one
shared no-op that enters no ``record_function``; outputs are bitwise the
same either way. CLEAN's count of components taken is held to a plain
NumPy Hogbom loop, and holds no flag once the recording is over.
"""

import json

import numpy as np
import pytest
import torch

from africanus_tpu_torch.calibration.selfcal import (
    SelfcalStep, from_numpy as selfcal_from_numpy, make_data, selfcal_inputs,
)
from africanus_tpu_torch.deconv.hogbom import hogbom_clean
from africanus_tpu_torch.rime.flagship import (
    flagship_inputs, from_numpy as flagship_from_numpy,
)
from africanus_tpu_torch.utils import profiling

STAGES = {
    "flagship": ("flagship.sky", "flagship.gains", "flagship.contract"),
    "selfcal": ("selfcal.solve", "selfcal.residual", "selfcal.image",
                "selfcal.clean", "selfcal.predict"),
}


def _flagship():
    model, inputs = flagship_from_numpy(
        flagship_inputs(nsrc=3, ntime=2, nant=5, nchan=8, seed=11), "cpu")
    return lambda: model(*inputs)


def _selfcal():
    a = selfcal_inputs(nant=5, ntime=2, nchan=4, nsrc=3, ncorr=2, seed=12)
    a.update(make_data(a, "cpu"))
    step, data = selfcal_from_numpy(a, "cpu", npx=8, gn_iters=3)
    return lambda: step(data)


CALLS = {"flagship": _flagship, "selfcal": _selfcal}


@pytest.fixture(scope="module", params=sorted(CALLS))
def entry(request):
    return request.param, CALLS[request.param]()


def _profiled(fn, calls=1):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = [fn() for _ in range(calls)]
    return prof, outs


def test_traces_hold_the_stage_spans_under_each_call(entry, tmp_path):
    name, fn = entry
    with torch.no_grad():
        prof, _ = _profiled(fn, calls=2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    calls = [s for s in spans if s[0] == f"{name}.call"]
    assert len(calls) == 2
    stages = [s for s in spans if s[0] != f"{name}.call"]
    assert sorted(n for n, _, _ in stages) == sorted(STAGES[name] * 2)
    for call in calls:
        inside = [n for n, s, e in stages if call[1] <= s and e <= call[2]]
        assert inside == list(STAGES[name])  # each stage once, in order


def test_no_profiler_enters_no_record_function(entry, monkeypatch):
    name, fn = entry
    entered = []
    real = torch.profiler.record_function

    def counting(span_name, *args):
        entered.append(span_name)
        return real(span_name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("a") is profiling.span("b")
    with torch.no_grad():
        fn()
    assert entered == []
    with torch.no_grad():
        _profiled(fn)
    assert entered == [f"{name}.call", *STAGES[name]]


def test_outputs_bitwise_equal_with_and_without_a_profiler(entry):
    _, fn = entry
    with torch.no_grad():
        plain = fn()
        _, (traced,) = _profiled(fn)
    plain = plain if isinstance(plain, tuple) else (plain,)
    traced = traced if isinstance(traced, tuple) else (traced,)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def _numpy_hogbom_components(dirty, psf, gamma, frac, niter):
    """Components a plain Hogbom loop takes (reference clean.py:122)."""
    npix = dirty.shape[0]
    res = dirty.copy()
    flat = int(np.argmax(res))
    peak = res.flat[flat]
    thresh = frac * abs(peak)
    taken = 0
    for _ in range(niter + 1):
        if not abs(peak) > thresh:
            break
        taken += 1
        p, q = divmod(flat, npix)
        res = res - gamma * peak * psf[npix - 1 - p:2 * npix - 1 - p,
                                       npix - 1 - q:2 * npix - 1 - q]
        flat = int(np.argmax(res))
        peak = res.flat[flat]
    return taken


def _clean_image(npix=16):
    """A seeded (npix², (2·npix)²) dirty image and PSF: three gaussian
    sources on noise."""
    rng = np.random.default_rng(16)
    x = np.arange(2 * npix) - (npix - 1)
    psf = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 4.0)
    dirty = 0.05 * rng.standard_normal((npix, npix))
    for _ in range(3):
        p, q = rng.integers(2, npix - 2, 2)
        dirty += rng.uniform(0.5, 1.0) * psf[npix - 1 - p:2 * npix - 1 - p,
                                             npix - 1 - q:2 * npix - 1 - q]
    return dirty, psf


# (gamma, threshold, niter, whether the loop runs to niter + 1)
@pytest.mark.parametrize("gamma,frac,niter,runs_out", [
    (0.1, 0.2, 50, False), (0.5, 0.3, 40, False), (0.3, 0.05, 10, True)])
def test_hogbom_taken_counts_a_numpy_loops_components(gamma, frac, niter,
                                                      runs_out):
    dirty, psf = _clean_image()
    want = _numpy_hogbom_components(dirty, psf, gamma, frac, niter)
    assert 0 < want and (want == niter + 1) == runs_out
    args = (torch.from_numpy(dirty), torch.from_numpy(psf))
    kw = dict(gamma=gamma, threshold=frac, niter=niter)

    before = hogbom_clean.taken.read()
    hogbom_clean(*args, **kw)  # no profiler: nothing kept
    assert hogbom_clean.taken.read() == before

    _profiled(lambda: hogbom_clean(*args, **kw))
    true, kept = hogbom_clean.taken.read()
    assert kept - before[1] == niter + 1
    assert true - before[0] == want


def test_device_count_holds_no_flag_after_the_recording():
    dirty, psf = _clean_image()
    args = (torch.from_numpy(dirty), torch.from_numpy(psf))
    kw = dict(gamma=0.1, threshold=0.2, niter=50)
    want = _numpy_hogbom_components(dirty, psf, 0.1, 0.2, 50)
    count = hogbom_clean.taken
    before = count.read()
    _profiled(lambda: hogbom_clean(*args, **kw), calls=2)
    # held while the trace is read: one tensor of 51 running flags a call
    assert [tuple(f.shape) for f in count._flags] == [(51,)] * 2
    hogbom_clean(*args, **kw)  # the first call after: flags summed, let go
    assert count._flags == []
    assert all(n.dim() == 0 for n in count._sums.values())
    true, kept = count.read()
    assert (true - before[0], kept - before[1]) == (2 * want, 2 * 51)
    hogbom_clean(*args, **kw)
    assert count._flags == [] and count.read() == (true, kept)


def test_device_count_counts_1d_flag_tensors_beside_0d_flags():
    """Every element of a 1-D flags tensor counts as a flag, beside 0-d
    flags kept in the same recording; an empty tensor counts none."""
    count = profiling.DeviceCount()
    kept = [torch.tensor(True), torch.tensor([True, False, True, True]),
            torch.tensor(False), torch.zeros(0, dtype=torch.bool),
            torch.tensor([False, True])]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for f in kept:
            count.keep(f)
    assert len(count._flags) == len(kept)
    count.keep(torch.tensor([True, True]))  # the first keep after: folded
    assert count._flags == []
    assert count.read() == (5, 8)


def test_selfcal_step_counts_its_planning_seconds():
    before = SelfcalStep.plan_seconds
    _selfcal()
    assert SelfcalStep.plan_seconds > before >= 0.0
