"""The direction-dependent cell, ``meerkat64pb.beam100``, on the CPU at a
small size: runs ``correct`` with and without a traced window, with its
per-layer readings, and ``correct`` rejects each of its three controls
in the program's place (TF32 arithmetic, E without its off-diagonal
terms, no pointing errors)."""

import functools
import json
import subprocess
import sys

import pytest

from perfbench import run as bench
from perfbench.work import fused_dde

CELL = "meerkat64pb.beam100"
SEED = 2 ** 31 + 4321
SMALL = {"config": {"nant": 6, "nchan": 32,
                    "layout": [{"count": 6, "box_m": 5657.0}],
                    "beam": {"npix": 33, "planes": 5}},
         "traffic": {"pool_chunks": 2, "kept_rows": 4, "kept_calls": 2,
                     "traced_calls": 2, "warmup_calls": 1,
                     "sky": {"count": 5}}}


def small_run(trace=0, **kw):
    return bench.run(CELL, SEED, 0.2, trace, device="cpu", overrides=SMALL, **kw)


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(trace):
    res = small_run(trace)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if trace:
        # no kernel runs on the CPU, so the roofline, the kernels, the idle
        # share and the peak have nothing to read
        metrics = res["metrics"]
        assert set(metrics) == {"fused.blocks_per_call", "fused.state.host_ms",
                                "host.issue_ms"}
        # five sources fit one grid on the CPU: one block a call
        assert metrics["fused.blocks_per_call"]["value"] == 1
        assert metrics["fused.state.host_ms"]["value"] > 0
    else:
        assert set(res["metrics"]) == {"vis_rate", "call_p95_ms", "setup_s"}


def _with_control(monkeypatch, control):
    """Have the cell's entry put ``control`` in the program's place."""
    real = bench.load_module

    def load(kind, name):
        mod = real(kind, name)
        if kind == "entries":
            setup = mod.setup

            def patched(*a, **k):
                entry = setup(*a, **k)
                entry.control_readings = functools.partial(
                    entry.control_readings, control=control)
                return entry
            mod.setup = patched
        return mod

    monkeypatch.setattr(bench, "load_module", load)


@pytest.mark.parametrize("control", ["tf32", "no_leakage", "no_pointing"])
def test_controls_are_rejected(monkeypatch, control):
    _with_control(monkeypatch, control)
    res = small_run(control=True)
    assert not res["correct"] and res["failed"] == 1
    value = res["checks"]["vis_err"]["value"]
    assert value > 3 * res["checks"]["vis_err"]["limit"]


def test_work_counts_the_map():
    sizes = fused_dde.shape({"sources": 100, "rows": 8064, "chan": 4096, "corr": 4,
                             "dde_times": 4, "dde_antennas": 64, "dde_spi": 1,
                             "beam_cube": (257, 257, 33)})
    ops, nbytes = fused_dde.count(**sizes)
    assert ops == 146 * 100 * 8064 * 4096 + 24 * 100 * 4 * 64 * 4096
    assert 8 * 8064 * 4096 * 4 < nbytes < 1.2 * 8 * 8064 * 4096 * 4
    least, bound = fused_dde.least_seconds(**sizes)
    assert bound == "operations" and 0.9e-3 < least < 1.1e-3
    assert fused_dde.shape({"sources": 1, "rows": 1, "chan": 1, "corr": 4}) is None


def test_references_load_neither_jax_nor_the_port():
    """The cell's reference imports no JAX and nothing of the port; the
    port's test copy of it no JAX and no module of the port's RIME or
    kernels (its package's ``__init__`` loads host utilities)."""
    code = (f"import sys; sys.path.insert(0, {bench.ROOT!r})\n"
            "import {}\n"
            "print(__import__('json').dumps(sorted(sys.modules)))\n")
    for module in ("perfbench.reference.dde",
                   "africanus_tpu_torch.testing.dde_reference"):
        proc = subprocess.run([sys.executable, "-c", code.format(module)],
                              capture_output=True, text=True, timeout=120,
                              cwd=bench.ROOT)
        assert proc.returncode == 0, proc.stderr[-2000:]
        loaded = json.loads(proc.stdout.splitlines()[-1])
        top = {m.split(".")[0] for m in loaded}
        assert not top & {"jax", "jaxlib", "flax", "africanus_tpu"}
        port = [m for m in loaded if m.startswith("africanus_tpu_torch")]
        if module.startswith("perfbench"):
            assert not port
        else:
            assert not [m for m in port if m.split(".")[1:2] in (["rime"], ["ops"])]
