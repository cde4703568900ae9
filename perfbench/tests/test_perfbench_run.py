"""Runs of the harness: on the CPU at small sizes (the plain versions
stand in for the kernels), without a card, with the control in the
program's place, and with faults planted under the timed path."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import run as bench
from perfbench.tracing import read_trace

ROOT = bench.ROOT
CELLS = ("meerkat64.gauss100", "skamid.selfcal_px64", "meerkat64.cal1",
         "skamid.selfcal_px256")
SEED = 2 ** 31 + 4321


def entry_of(name):
    return bench.load_json("workloads", f"{name}.json")["entry"]


def small_run(name, small, **kw):
    return bench.run(name, SEED, 0.2, kw.pop("trace", 0), device="cpu",
                     overrides=small[entry_of(name)], **kw)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
         "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(name, trace, small):
    res = small_run(name, small, trace=trace)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if trace:
        assert "breakdown" in res and res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == {"vis_rate", "call_p95_ms", "setup_s"}


def test_rehearsal_loads_no_jax_and_reference_loads_no_port(small):
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from perfbench import run as bench\n"
        f"small = {json.dumps(small)}\n"
        f"for name in {list(CELLS)!r}:\n"
        "    e = bench.load_json('workloads', name + '.json')['entry']\n"
        "    assert bench.run(name, 5, 0.1, 0, device='cpu',"
        " overrides=small[e])['correct']\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "africanus_tpu_torch" in top
    assert not top & set(bench.FORBIDDEN)

    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n"
            "import perfbench.reference.rime, perfbench.reference.selfcal\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "africanus_tpu_torch" not in proc.stdout
    assert "'jax'" not in proc.stdout and "'africanus_tpu'" not in proc.stdout


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes(name, small):
    program = small_run(name, small)
    control = small_run(name, small, control=True)
    assert program["correct"] and not control["correct"]
    assert control["failed"] > 0
    assert set(control["checks"]) == set(program["checks"])


def _plant_jax_in_readings(monkeypatch):
    """Have the cell's entry load a module named ``jax`` once the window
    has closed, while its outputs are compared."""
    import types
    real = bench.load_module

    def load(kind, mod_name):
        mod = real(kind, mod_name)
        if kind == "entries":
            cls_setup = mod.setup

            def setup(*a, **k):
                entry = cls_setup(*a, **k)
                readings = entry.readings

                def planted(kept):
                    monkeypatch.setitem(sys.modules, "jax",
                                        types.ModuleType("jax"))
                    return readings(kept)
                entry.readings = planted
                return entry
            mod.setup = setup
        return mod
    monkeypatch.setattr(bench, "load_module", load)


def test_jax_loaded_after_the_window_gives_no_result(small, monkeypatch,
                                                      capsys):
    _plant_jax_in_readings(monkeypatch)
    with pytest.raises(SystemExit, match="jax"):
        small_run("meerkat64.cal1", small)
    assert capsys.readouterr().out == ""


def test_main_checks_for_jax_last(monkeypatch, capsys):
    import types

    def run(*a, **k):  # a result, with jax loaded as it was made
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
                "device": {}, "checks": {"vis_err": {"value": 0.0,
                                                     "limit": 1.0}}}
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "run", run)
    with pytest.raises(SystemExit, match="jax"):
        bench.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert capsys.readouterr().out == ""


def _flagship(monkeypatch, fault):
    import africanus_tpu_torch.rime.flagship as fl
    if fault == "answer_altered":
        real = fl.predict_kb

        def altered(*a, **k):
            out = real(*a, **k)
            out[:, 3] *= 1 + 1e-3
            return out
        monkeypatch.setattr(fl, "predict_kb", altered)
    else:  # half the rows left out: the first half's answers stand in
        real = fl.FlagshipPredict.forward

        def half(self, *a):
            out = real(self, *a)
            n = out.shape[0] // 2
            out[n:2 * n] = out[:n]
            return out
        monkeypatch.setattr(fl.FlagshipPredict, "forward", half)


def _selfcal(monkeypatch, fault):
    import africanus_tpu_torch.calibration.selfcal as sc
    if fault == "state_unchanged":
        real = sc.gauss_newton

        def unchanged(*a, **k):
            _, jhj, jhr, it = real(*a, **k)
            return a[4], jhj, jhr, it  # the starting gains
        monkeypatch.setattr(sc, "gauss_newton", unchanged)
    elif fault == "half_batch":
        real = sc.vis_to_im

        def half(vis, uvw, *a, **k):  # the first half of the rows, scaled up
            keep = torch.zeros_like(vis)
            n = vis.shape[0] // 2
            keep[:n] = 2 * vis[:n]
            return real(keep, uvw, *a, **k)
        monkeypatch.setattr(sc, "vis_to_im", half)
    elif fault == "clean_altered":
        real = sc.hogbom_clean

        def altered(*a, **k):
            model, res = real(*a, **k)
            return model, res + 1e-3 * res.abs().max()
        monkeypatch.setattr(sc, "hogbom_clean", altered)
    else:  # the re-predict altered where it is produced
        real = sc.im_to_vis

        def altered(*a, **k):
            out = real(*a, **k)
            out[:, 0] *= 1 + 1e-3
            return out
        monkeypatch.setattr(sc, "im_to_vis", altered)


@pytest.mark.parametrize("name,fault", [
    ("meerkat64.gauss100", "answer_altered"), ("meerkat64.gauss100", "half_rows"),
    ("meerkat64.cal1", "answer_altered"), ("meerkat64.cal1", "half_rows"),
    ("skamid.selfcal_px64", "state_unchanged"), ("skamid.selfcal_px64", "half_batch"),
    ("skamid.selfcal_px64", "clean_altered"), ("skamid.selfcal_px64", "model_altered"),
    ("skamid.selfcal_px256", "state_unchanged"), ("skamid.selfcal_px256", "half_batch"),
])
def test_planted_fault_is_not_correct(name, fault, small, monkeypatch):
    plant = _flagship if entry_of(name) == "flagship" else _selfcal
    plant(monkeypatch, fault)
    res = small_run(name, small)
    assert not res["correct"] and res["failed"] > 0


def test_end_to_end_readers_by_hand():
    import types
    win = types.SimpleNamespace(times=[0.001 * k for k in range(1, 21)],
                                window_s=0.25, vis_per_call=1000, setup_s=7.5)
    read = {m: bench.load_module("metrics", m).read(win)
            for m in ("vis_rate", "call_p95_ms", "setup_s")}
    assert read["vis_rate"] == pytest.approx(20 * 1000 / 0.25 / 1e6)
    assert read["call_p95_ms"] == pytest.approx(19.0)  # rank ceil(0.95·20) = 19
    assert read["setup_s"] == 7.5


def test_trace_reading_by_hand():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("user_annotation", "perfbench.window", 1000, 100),
              ev("kernel", "void (anonymous namespace)::predict_kb_mma_kernel<0, true>(float const*)", 1010, 30),
              ev("kernel", "vectorized_elementwise_kernel", 1030, 20),
              ev("gpu_memset", "Memset", 1080, 5),
              ev("kernel", "outside", 2000, 5),
              ev("cpu_op", "aten::polar", 1050, 30),
              ev("cuda_runtime", "cudaLaunchKernel", 1060, 5)]
    rec = read_trace(events, calls=2)
    assert rec.window_s == pytest.approx(100e-6)
    assert rec.busy_s == pytest.approx(45e-6)  # 1010-1050 and 1080-1085
    assert rec.kernel_seconds(lambda n: n.startswith("predict_kb")) == pytest.approx(30e-6)
    assert len(rec.kernels) == 2
    gaps = rec.breakdown()["idle_gaps"]
    # 1000-1010 (nothing traced), 1050-1080 (mid 1065: the launch), 1085-1100
    assert dict(gaps)["cudaLaunchKernel"] == pytest.approx(30e-6)
    assert dict(gaps)["host: no traced operation"] == pytest.approx(25e-6)
    rec.issue_s, rec.peak_bytes = [0.001, 0.003, 0.002], 2 ** 31
    rec.shapes = {"sources": 1, "rows": 1000, "chan": 1000, "corr": 4}
    read = {m: bench.load_module("metrics", m).read(rec) for m in (
        "device.idle_pct", "host.kernels_per_call", "host.issue_ms",
        "device.peak_gib", "gains_sky.device_ms", "predict_kb_roofline",
        "dft_adjoint_roofline")}
    assert read["device.idle_pct"] == pytest.approx(55.0)
    assert read["host.kernels_per_call"] == 1.0
    assert read["host.issue_ms"] == pytest.approx(2.0)
    assert read["device.peak_gib"] == 2.0
    assert read["gains_sky.device_ms"] == pytest.approx(0.010)
    assert read["dft_adjoint_roofline"] is None


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "meerkat64.cal1",
         "--seed", "3", "--seconds", "1", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_the_cells_size(name):
    """The TF32 control in the program's place, at the cell's own sizes
    and load on the card, comes out as not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = bench.run(name, SEED, 1.0, 0, control=True)
    assert res["attempted"] > 0 and not res["correct"] and res["failed"] > 0
