"""The program's own spans in a traced window: each stage's share of a
call, read from the same Chrome trace as the kernels.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout runs the cell as ``perfbench/run.py --trace
1`` does and prints its result line with one more key,
``span_breakdown`` (before ``checks``). The program names its stages
with ``record_function`` spans (``africanus_tpu_torch.utils.profiling``:
``flagship.call`` and ``selfcal.call`` around their stages). Each device
operation is given to the innermost span open on the host when the
runtime call that launched it was made (the two linked by the trace's
``correlation``), each idle stretch of the device to the innermost span
open at its middle; what no span holds is ``outside spans``. Per call:

- ``stages``: for each span, ``host_self_ms`` (its time less its child
  spans'), ``device_ms`` and ``kernels`` of what it launched, and
  ``idle_ms``;
- ``busy_ms``: the union of the device operations, which the stages'
  ``device_ms`` sum to where nothing overlaps;
- ``syncs_per_call`` and ``syncs`` (by span and name): the runtime's
  stream, device and event synchronisations made inside a ``*.call``
  span, and the device-to-host copies it launched;
- ``copies`` (by span and name): every copy a ``*.call`` span launched.

:func:`span_breakdown` and :func:`span_metrics` are what
``perfbench/tracing.py`` and ``perfbench/run.py`` are to call once they
carry the spans; :func:`run_with_spans` and :func:`main`, which run the
cell by wrapping ``tracing.read_trace``, and the helpers copied from
``tracing.py`` go then (ROADMAP's open items name that step).
"""

from __future__ import annotations

import heapq
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT  # the checkout, not perfbench/, heads the path
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import run as bench  # noqa: E402
from perfbench import tracing  # noqa: E402

__all__ = ["span_breakdown", "span_metrics", "run_with_spans"]

OUTSIDE = "outside spans"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def _x(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _interval(e):
    s = float(e["ts"]) * 1e-6
    return s, s + float(e.get("dur", 0)) * 1e-6


def _innermost(spans, times):
    """For each of ``times``, the name of the innermost of ``spans``
    ((name, start, end), nested) open then, or None: of those begun and
    not yet ended, the latest begun."""
    spans = sorted(spans, key=lambda sp: sp[1])
    out = [None] * len(times)
    live, k = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while k < len(spans) and spans[k][1] <= t:
            name, s, e = spans[k]
            heapq.heappush(live, (-s, e, name))
            k += 1
        while live and live[0][1] < t:
            heapq.heappop(live)
        out[i] = live[0][2] if live else None
    return out


def _self_seconds(spans):
    """{name: seconds} of each span less its child spans, summed by name."""
    out, stack = {}, []
    for name, s, e in sorted(spans, key=lambda sp: (sp[1], -sp[2])):
        while stack and stack[-1][2] <= s:
            stack.pop()
        out[name] = out.get(name, 0.0) + (e - s)
        if stack:
            parent = stack[-1][0]
            out[parent] -= e - s
        stack.append((name, s, e))
    return out


def span_breakdown(events, rec):
    """The per-call span table of the Chrome-trace ``events`` of the
    window that ``rec`` (:func:`perfbench.tracing.read_trace`) read."""
    spans = [(e["name"], *_interval(e)) for e in _x(events, ("user_annotation",))
             if e["name"] != tracing.WINDOW]
    spans = [sp for sp in spans if sp[1] < rec.w1 and sp[2] > rec.w0]
    calls = [sp for sp in spans if sp[0].endswith(".call")]
    launched = {e["args"]["correlation"]: _interval(e)[0]
                for e in _x(events, LAUNCH_CATS)
                if "correlation" in e.get("args", {})}
    ops = []
    for e in _x(events, tracing.DEVICE_CATS):
        s, end = _interval(e)
        if s < rec.w1 and end > rec.w0:
            ops.append((e, end - s, launched.get(e.get("args", {}).get(
                "correlation"))))

    per = 1.0 / rec.calls
    stages = {}

    def stage(name):
        return stages.setdefault(name or OUTSIDE, {
            "host_self_ms": 0.0, "device_ms": 0.0, "kernels": 0,
            "idle_ms": 0.0})

    for name, seconds in _self_seconds(spans).items():
        stage(name)["host_self_ms"] = 1e3 * seconds * per
    at_launch = _innermost(spans, [t if t is not None else -1.0
                                   for _, _, t in ops])
    for (e, dur, _), name in zip(ops, at_launch):
        row = stage(name)
        row["device_ms"] += 1e3 * dur * per
        row["kernels"] += e["cat"] == "kernel"
    gaps = rec.gaps()
    for (s, e), name in zip(gaps, _innermost(spans, [(s + e) / 2
                                                     for s, e in gaps])):
        stage(name)["idle_ms"] += 1e3 * (e - s) * per
    for row in stages.values():
        row["kernels"] *= per

    # synchronisations: runtime calls that wait, and copies to the host
    waits = [(e["name"], _interval(e)[0]) for e in _x(events, LAUNCH_CATS)
             if e["name"] in SYNC_CALLS]
    waits += [(e["name"], t) for e, _, t in ops
              if e["cat"] == "gpu_memcpy" and "DtoH" in e["name"]
              and t is not None]
    copies = [(e["name"], t) for e, _, t in ops
              if e["cat"] == "gpu_memcpy" and t is not None]
    syncs, copied = _in_calls(waits, calls, spans, per), _in_calls(
        copies, calls, spans, per)
    return {"calls": rec.calls, "stages": stages,
            "busy_ms": 1e3 * rec.busy_s * per,
            "syncs_per_call": sum(syncs.values()) if calls else None,
            "syncs": syncs, "copies": copied}


def _in_calls(found, calls, spans, per):
    """{"<innermost span>: <name>": count a call} of the (name, host
    time) in ``found`` that lie inside a ``*.call`` span."""
    times = [t for _, t in found]
    out = {}
    for (op, _), call, name in zip(found, _innermost(calls, times),
                                   _innermost(spans, times)):
        if call is not None:
            key = f"{name}: {op}"
            out[key] = out.get(key, 0) + 1
    return {k: n * per for k, n in out.items()}


# the readings a span gives, by the per-layer name each would take
SPAN_METRICS = {
    "flagship.sky.device_ms": ("flagship.sky", "device_ms"),
    "flagship.gains.device_ms": ("flagship.gains", "device_ms"),
    "flagship.sky.idle_ms": ("flagship.sky", "idle_ms"),
    "selfcal.solve.host_ms": ("selfcal.solve", "host_self_ms"),
    "selfcal.clean.host_ms": ("selfcal.clean", "host_self_ms"),
}


def span_metrics(table):
    """{name: value} of the readings of :data:`SPAN_METRICS` whose span
    is in ``table`` (:func:`span_breakdown`; device readings only where
    the device ran something), and ``host.syncs_per_call`` where a
    ``*.call`` span is."""
    device = table["busy_ms"] > 0
    out = {m: table["stages"][sp][key] for m, (sp, key) in SPAN_METRICS.items()
           if sp in table["stages"] and (device or key == "host_self_ms")}
    if table["syncs_per_call"] is not None:
        out["host.syncs_per_call"] = table["syncs_per_call"]
    return out


def run_with_spans(name, seed, seconds, **kw):
    """:func:`perfbench.run.run` with ``--trace 1``, its result with
    ``span_breakdown`` (and the readings of :func:`span_metrics` in it,
    under ``metrics``) put in before ``checks``."""
    tables, read = [], tracing.read_trace

    def read_and_keep(events, calls):
        rec = read(events, calls)
        tables.append(span_breakdown(events, rec))
        return rec

    tracing.read_trace = read_and_keep
    try:
        result = bench.run(name, seed, seconds, 1, **kw)
    finally:
        tracing.read_trace = read
    checks = result.pop("checks")
    result["span_breakdown"] = dict(tables[0],
                                    metrics=span_metrics(tables[0]))
    result["checks"] = checks
    return result


def main(argv=None):
    import argparse
    import json

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    result = run_with_spans(args.workload, args.seed, args.seconds)
    bench.refuse_forbidden()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
