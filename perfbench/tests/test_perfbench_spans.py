"""The program's spans read from a trace (``perfbench/spans.py``) and
the readers of the program's counters: by hand on a made-up Chrome
trace, unchanged readings of every existing metric with and without the
spans, and small runs of each entry on the CPU."""

import json
import os

import pytest

from perfbench import run as bench
from perfbench import spans, tracing

CELLS = ("meerkat64.gauss100", "skamid.selfcal_px64")
SEED = 2 ** 31 + 8765
with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
    PER_LAYER = [m["name"] for m in json.load(f)["per_layer"]]


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def program_spans():
    return [ev("user_annotation", "a.call", 1000, 80),
            ev("user_annotation", "a.x", 1005, 30),
            ev("user_annotation", "a.y", 1040, 35)]


def trace_events():
    """Two stages in one call; the harness's synchronise after it."""
    return [ev("user_annotation", "perfbench.window", 1000, 100),
            ev("cpu_op", "aten::mul", 1010, 10),
            ev("cuda_runtime", "cudaLaunchKernel", 1012, 4, corr=1),
            ev("cuda_runtime", "cudaLaunchKernel", 1030, 2, corr=2),
            ev("cuda_runtime", "cudaMemcpyAsync", 1045, 3, corr=3),
            ev("cuda_runtime", "cudaStreamSynchronize", 1050, 12),
            ev("cuda_runtime", "cudaLaunchKernel", 1070, 2, corr=4),
            ev("cuda_runtime", "cudaDeviceSynchronize", 1082, 18),
            ev("kernel", "void predict_kb_mma_kernel<0, true>(float const*)",
               1015, 20, corr=1),
            ev("kernel", "vectorized_elementwise_kernel", 1035, 5, corr=2),
            ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1048, 2,
               corr=3),
            ev("kernel", "reduce_kernel", 1072, 8, corr=4),
            ev("gpu_user_annotation", "a.x", 1015, 25)]


def test_spans_by_hand():
    events = trace_events() + program_spans()
    rec = tracing.read_trace(events, calls=1)
    table = spans.span_breakdown(events, rec)
    x, y, call = (table["stages"][n] for n in ("a.x", "a.y", "a.call"))
    assert x["device_ms"] == pytest.approx(0.025) and x["kernels"] == 2
    assert y["device_ms"] == pytest.approx(0.010) and y["kernels"] == 1
    assert call["device_ms"] == 0.0 and call["kernels"] == 0
    assert call["host_self_ms"] == pytest.approx(0.015)  # 80 less 30 and 35
    assert x["host_self_ms"] == pytest.approx(0.030)
    # idle 1000-1015 (mid 1007.5: a.x), 1040-1048 and 1050-1072 (a.y),
    # 1080-1100 (mid 1090: after the call)
    assert x["idle_ms"] == pytest.approx(0.015)
    assert y["idle_ms"] == pytest.approx(0.030)
    assert table["stages"][spans.OUTSIDE]["idle_ms"] == pytest.approx(0.020)
    assert table["busy_ms"] == pytest.approx(sum(
        r["device_ms"] for r in table["stages"].values()))
    # the stream sync and the copy to the host inside the call; the
    # harness's device sync after it is not counted
    assert table["syncs"] == {"a.y: cudaStreamSynchronize": 1.0,
                              "a.y: Memcpy DtoH (Device -> Pageable)": 1.0}
    assert table["copies"] == {"a.y: Memcpy DtoH (Device -> Pageable)": 1.0}
    read = spans.span_metrics(table)
    assert read == {"host.syncs_per_call": 2.0}  # no stage of an entry


def test_spans_change_no_existing_reading():
    bare = tracing.read_trace(trace_events(), calls=1)
    spanned = tracing.read_trace(trace_events() + program_spans(), calls=1)
    assert spanned.breakdown() == bare.breakdown()
    for rec in (bare, spanned):
        rec.issue_s, rec.peak_bytes = [0.001, 0.002], 2 ** 30
        rec.shapes = {"sources": 1, "rows": 1000, "chan": 1000, "corr": 4}
    for m in PER_LAYER:
        read = bench.load_module("metrics", m).read
        assert read(spanned) == read(bare), m


@pytest.mark.parametrize("name", CELLS)
def test_small_traced_run_reads_the_spans(name, small, monkeypatch):
    kept = []
    read = tracing.read_trace

    def keep(events, calls):
        kept.append(events)
        return read(events, calls)

    monkeypatch.setattr(tracing, "read_trace", keep)
    entry = bench.load_json("workloads", f"{name}.json")["entry"]
    res = spans.run_with_spans(name, SEED, 0.2, device="cpu",
                               overrides=small[entry])
    assert res["correct"] and list(res)[-2:] == ["span_breakdown", "checks"]
    table = res["span_breakdown"]
    prefix = name.split(".")[0].replace("meerkat64", "flagship").replace(
        "skamid", "selfcal")
    stages = {n for n in table["stages"] if n.startswith(prefix)}
    assert len(stages) == (4 if prefix == "flagship" else 6)
    assert all(table["stages"][n]["host_self_ms"] > 0 for n in stages)
    assert table["syncs_per_call"] == 0  # no runtime calls on the CPU
    # the program's spans leave the harness's own readings as they were
    events = kept[0]
    bare = [e for e in events if not (e.get("cat") == "user_annotation"
                                      and e["name"].startswith(prefix))]
    calls = table["calls"]
    assert (tracing.read_trace(bare, calls).breakdown()
            == tracing.read_trace(events, calls).breakdown())
    if prefix == "selfcal":
        assert set(table["metrics"]) == {"selfcal.solve.host_ms",
                                         "selfcal.clean.host_ms",
                                         "host.syncs_per_call"}
        assert 0 < res["metrics"]["selfcal.clean.taken_pct"]["value"] <= 100
        assert res["metrics"]["selfcal.plan_s"]["value"] > 0
    else:
        assert set(table["metrics"]) == {"host.syncs_per_call"}


def test_counter_readers_read_nothing_without_the_counters(monkeypatch):
    from africanus_tpu_torch.calibration.selfcal import SelfcalStep
    from africanus_tpu_torch.deconv.hogbom import hogbom_clean

    monkeypatch.delattr(hogbom_clean, "taken")
    monkeypatch.delattr(SelfcalStep, "plan_seconds")
    for m in ("selfcal.clean.taken_pct", "selfcal.plan_s"):
        assert bench.load_module("metrics", m).read(None) is None
