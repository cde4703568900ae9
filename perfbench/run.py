"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by name:
``perfbench/workloads/<cell>.json`` (its configuration, entry, traffic
and the limits of its comparison), ``perfbench/configs/<config>.json``,
``perfbench/entries/<entry>.py``, and for ``--trace 1`` the metrics that
``BENCHMARK.json`` lists for the cell, ``perfbench/metrics/<metric>.py``.

A run builds its inputs on the device from the seed, warms up its own
shapes (set-up ends at the first timed call), then drives the entry in
a closed loop, one call in flight, for ``--seconds``: each call is timed
on the host clock until its outputs are complete. With ``--trace 1`` a
short profiled sub-window follows. Once the window has closed and the
peak memory is read, the program's state is freed and the outputs kept
from calls of the window are compared with the plain float64 reference.
The last line of standard output is the result (JSON); the numbers
compared, each beside its limit, are the last lines of standard error.
Where a module of JAX or the JAX package is loaded when the result is
due, the run prints no result and fails.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()


def _process_age():
    """Seconds since this process started (its start time in the kernel's
    clock ticks since boot, against the boot clock)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf(
        "SC_CLK_TCK")


_AGE0 = _process_age()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
        os.path.abspath(__file__)):
    sys.path[0] = ROOT  # the checkout, not perfbench/, heads the path
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every cache of the program inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import types  # noqa: E402

import torch  # noqa: E402

_T_IMPORTED = time.perf_counter()
FORBIDDEN = ("jax", "jaxlib", "flax", "africanus_tpu")
BENCH = os.path.join(ROOT, "perfbench")


def load_json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """``perfbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge(base, over):
    """``base`` with the keys of ``over`` put in, nested dicts merged."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def cell_spec(name, overrides=None):
    """(cell, configuration) of a cell, with ``overrides`` (``{"config":
    ..., "traffic": ...}``) merged in."""
    cell = load_json("workloads", f"{name}.json")
    cfg = load_json("configs", f"{cell['config']}.json")["sizes"]
    overrides = overrides or {}
    cell = merge(cell, {"traffic": overrides.get("traffic", {})})
    return cell, merge(cfg, overrides.get("config", {}))


def benchmark_entry(name):
    """(the cell's ``workloads`` entry, its end-to-end metrics, its
    per-layer metrics) from ``BENCHMARK.json``: each metric is read by
    ``perfbench/metrics/<name>.py``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(w for w in bench["workloads"] if w["name"] == name)

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return entry, mine(bench["end_to_end"]), mine(bench["per_layer"])


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_forbidden():
    """Fail, naming them, where modules of JAX or the JAX package are
    loaded (compared by whole top-level names)."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"perfbench: modules of JAX or the JAX package are "
                         f"loaded: {', '.join(found)}")


class Reservoir:
    """A uniform sample of ``size`` calls of the window, drawn from the
    seed without knowing how many calls there will be."""

    def __init__(self, size, seed):
        self.size, self.rng, self.kept = size, random.Random(seed), []

    def offer(self, i, out, keep):
        if len(self.kept) < self.size:
            self.kept.append(keep(i, out))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.size:
                self.kept[j] = keep(i, out)


def card():
    """The card's name and power limit (``nvidia-smi``)."""
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return text[0] if text else "nvidia-smi printed nothing"


def run(name, seed, seconds, trace, device="cuda", overrides=None,
        control=False):
    """One run of cell ``name``; returns the result's dict (its last key
    ``checks``). ``device="cpu"`` and ``overrides`` are for rehearsals and
    tests at small sizes: the command line always runs on the card.
    ``control`` puts the TF32 control in the program's place in the
    comparison, on the same kept calls, which ``correct`` then has to
    reject (``perfbench/calibrate.py``, ``perfbench/tests/``)."""
    from perfbench import tracing

    t_start = time.perf_counter()
    cell, cfg = cell_spec(name, overrides)
    traffic = cell["traffic"]
    entry_mod = load_module("entries", cell["entry"])
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        entry = entry_mod.setup(cfg, traffic, seed, device)
        sync()
        t_inputs = time.perf_counter()
        for i in range(traffic["warmup_calls"]):
            entry.keep(i, entry.call(i))
        sync()

        t_first = time.perf_counter()
        setup_s = t_first - _T0 + _AGE0
        sample = Reservoir(traffic["kept_calls"], seed)
        times, issue = [], []
        i = 0
        while True:
            t0 = time.perf_counter()
            out = entry.call(i)
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            times.append(t2 - t0)
            issue.append(t1 - t0)
            sample.offer(i, out, entry.keep)
            del out
            i += 1
            if t2 - t_first >= seconds:
                break
        window_s = t2 - t_first
        sync()
        peak = torch.cuda.max_memory_allocated() if on_card else 0

        record = None
        if trace:
            record = tracing.traced_window(entry, i, traffic["traced_calls"],
                                           sync, on_card)
            record.issue_s = issue
            record.peak_bytes = peak
            record.shapes = entry.shapes

    entry.release()
    if on_card:
        torch.cuda.empty_cache()
    with torch.no_grad():
        numbers = (entry.control_readings if control else entry.readings)(
            sample.kept)
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in entry_mod.NUMBERS}
    failed = sum(not (c["value"] <= c["limit"]) for c in checks.values())
    correct = failed == 0 and len(sample.kept) > 0

    result = {"correct": correct, "attempted": len(times), "failed": failed}
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": 1, "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    _, end_to_end, per_layer = benchmark_entry(name)
    metrics = {}
    if trace:
        read_from = record
        dev["busy_s"], dev["window_s"] = record.busy_s, record.window_s
        result["breakdown"] = record.breakdown()
    else:
        read_from = types.SimpleNamespace(times=times, window_s=window_s,
                                          vis_per_call=entry.vis_per_call,
                                          setup_s=setup_s)
    for m in per_layer if trace else end_to_end:
        value = load_module("metrics", m["name"]).read(read_from)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["card"] = card() if on_card else "cpu"
    result["setup_parts_s"] = {
        "start_to_torch": _T_IMPORTED - _T0 + _AGE0,
        "inputs_and_program": t_inputs - max(_T_IMPORTED, t_start),
        "warmup": t_first - t_inputs}
    result["checks"] = checks
    refuse_forbidden()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    entry, _, _ = benchmark_entry(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, args.trace)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    refuse_forbidden()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
