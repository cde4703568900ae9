"""The w-stacking imaging cell, ``meerkat64ws.major5120``, on the CPU at a
small size (64² pixels of 60″, 6 antennas, 8 channels: a stack of ~36
planes of 128²) with the stack forced into blocks of 5 planes: runs
``correct`` with and without a traced window; faults planted in the
program come out not correct; both controls read over the limits; the
work counts match hand counts."""

import functools
import json
import subprocess
import sys
import types

import pytest
import torch

from perfbench import run as bench
from perfbench.work import degrid_wstack, grid_wstack

CELL = "meerkat64ws.major5120"
SEED = 2 ** 31 + 4321
NPIX, NANT, NCHAN = 64, 6, 8
SMALL = {"config": {"nant": NANT, "nchan": NCHAN,
                    "layout": [{"count": NANT, "box_m": 5657.0}],
                    "imaging": {"npix": NPIX, "cell_arcsec": 60.0}},
         "traffic": {"sky": {"count": 50}, "model": {"count": 45}, "kept_rows": 8,
                     "kept_pixels": {"corners": 16, "components": 16, "uniform": 32},
                     "traced_calls": 2, "warmup_calls": 2}}
PLANES = 5


@pytest.fixture(autouse=True)
def blocks_of_five(monkeypatch):
    """The stack in blocks of PLANES planes: the program reads a free
    memory that holds no more (``core.block_bytes`` of the small cell's
    sizes), and makes its plans afresh."""
    from africanus_tpu_torch.gridding.wgridder import core
    from africanus_tpu_torch.utils.plancache import LRUCache

    sizes = types.SimpleNamespace(complex_dtype=torch.complex64, nu=2 * NPIX, support=8,
                                  nv=2 * NPIX, nx=NPIX, ny=NPIX,
                                  nsamples=NANT * (NANT - 1) // 2 * 4 * NCHAN)
    per = core.block_bytes(sizes, 1) - core.block_bytes(sizes, 0)
    free = (core.block_bytes(sizes, PLANES) + per / 2) / core.MEMORY_SHARE
    monkeypatch.setattr(core, "free_bytes", lambda device: free)
    monkeypatch.setattr(core, "_MAKE_PLAN_CACHE", LRUCache(4))


def small_run(trace=0, **kw):
    return bench.run(CELL, SEED, 0.2, trace, device="cpu", overrides=SMALL, **kw)


@pytest.mark.parametrize("trace", [0, 1])
def test_small_run_is_correct(trace):
    res = small_run(trace)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    if trace:
        # no kernel runs on the CPU: the rooflines, the transform's device
        # time, the kernels, the idle share and the peak have nothing to read
        metrics = res["metrics"]
        assert set(metrics) == {"wgridder.plane_blocks_per_call", "host.issue_ms"}
        assert metrics["wgridder.plane_blocks_per_call"]["value"] > 3
    else:
        assert set(res["metrics"]) == {"vis_rate", "call_p95_ms", "setup_s"}


def _plant(monkeypatch, fault):
    from africanus_tpu_torch.gridding.wgridder import api, core
    if fault == "answer_altered":  # the dirty image altered where it is made
        real = core._image
        monkeypatch.setattr(core, "_image", lambda *a: real(*a) * (1 + 1e-3))
    elif fault == "half_rows":  # the first half of the rows gridded, scaled up
        real = api.grid_adjoint

        def half(uvw, freq, vis, *a, **k):
            keep = torch.zeros_like(vis)
            n = vis.shape[0] // 2
            keep[:n] = 2 * vis[:n]
            return real(uvw, freq, keep, *a, **k)
        monkeypatch.setattr(api, "grid_adjoint", half)
    else:  # a straddling sample's taps kept in the first block it meets only
        real = core.block_taps

        def first_only(p0, wsc, first, count, stack):
            start, taps = real(p0, wsc, first, count, stack)
            taps[:, p0 < first] = 0
            return start, taps
        monkeypatch.setattr(core, "block_taps", first_only)


@pytest.mark.parametrize("fault", ["answer_altered", "half_rows", "straddle_dropped"])
def test_planted_fault_is_not_correct(fault, monkeypatch):
    _plant(monkeypatch, fault)
    res = small_run()
    assert not res["correct"] and res["failed"] > 0


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


@pytest.mark.parametrize("control", ["float32", "no_w"])
def test_controls_read_over_the_limits(monkeypatch, control):
    _with_control(monkeypatch, control)
    res = small_run(control=True)
    assert not res["correct"] and res["failed"] == 2
    for check in res["checks"].values():
        assert check["value"] > 3 * check["limit"]


def test_work_counts_the_map():
    shapes = {"rows": 8064, "chan": 4096, "wstack_samples": 8064 * 4096,
              "wstack_support": 8, "wstack_planes": 90.0, "wstack_cells": 3.0e9,
              "wstack_grid": (10240, 10240)}
    assert grid_wstack.shape(shapes) == dict(N=8064 * 4096, R=8064, F=4096, W=8, P=90.0,
                                             G=10240 ** 2)
    assert degrid_wstack.shape(shapes) == dict(N=8064 * 4096, R=8064, F=4096, W=8, C=3.0e9)
    ops, nbytes = grid_wstack.count(N=3, R=2, F=5, W=4, P=2.5, G=7)
    assert ops == 3 * 4 ** 3 * 4
    # the values (complex64), uvw a row (3 float32), the frequencies
    # (float32), the touched planes (complex64 cells)
    assert nbytes == 3 * 8 + 2 * 12 + 5 * 4 + 2.5 * 7 * 8
    # the same, the cells the windows hold in place of the planes
    assert degrid_wstack.count(N=3, R=2, F=5, W=4, C=11) == (ops, 3 * 8 + 2 * 12 + 5 * 4
                                                           + 11 * 8)
    least, bound = grid_wstack.least_seconds(**grid_wstack.shape(shapes))
    assert bound == "bytes" and 0.02 < least < 0.025   # 90 planes of 839 MB
    assert grid_wstack.shape({"rows": 1, "chan": 1, "corr": 4}) is None
    assert degrid_wstack.shape({"rows": 1, "chan": 1, "corr": 4}) is None


def test_footprint_by_hand():
    """Two samples on a 16 × 16 grid of planes 0, 10, 20, … λ at W = 4:
    one window of 4 × 4 × 4 cells, one that wraps in u and overlaps the
    first in w; planes 0–4 held, the cells counted once."""
    cell, freq = 0.01, torch.tensor([2.99792458e8])   # ν/c = 1: uvw in λ
    # u·nu·cell = 16·0.01·u: u = 13 → x = 2.08 (window from 1); u = -0.625
    # → x = 15.9 (window 14, 15, 0, 1); w = 15 → plane 1.5 (window from
    # 0), w = 25 → 2.5 (window from 1)
    uvw = torch.tensor([[13.0, 13.0, 15.0], [-0.625, 13.0, 25.0]], dtype=torch.float64)
    planes, cells = grid_wstack.footprint(uvw, freq, 16, 16, cell, 4,
                                          torch.arange(8, dtype=torch.float64) * 10)
    assert planes == 5
    # u windows {1..4} and {14, 15, 0, 1} (overlap at u = 1), v {1..4} both:
    # planes 0: first only (16); 1-3: both (16 + 16 - 4 = 28); 4: second (16)
    assert cells == 16 + 3 * 28 + 16


def test_reference_loads_neither_jax_nor_the_port():
    code = (f"import sys; sys.path.insert(0, {bench.ROOT!r})\n"
            "import perfbench.reference.imaging\n"
            "print(__import__('json').dumps(sorted(sys.modules)))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=bench.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = {m.split(".")[0] for m in json.loads(proc.stdout.splitlines()[-1])}
    assert not top & {"jax", "jaxlib", "flax", "africanus_tpu", "africanus_tpu_torch"}


def test_a_kept_call_holds_its_own_model_visibilities(monkeypatch):
    """The model visibilities a kept call holds are those its
    ``api.residual`` degridded, and the call leaves ``api.degrid`` as it
    found it."""
    from africanus_tpu_torch.gridding.wgridder import api

    cell, cfg = bench.cell_spec(CELL, SMALL)
    entry = bench.load_module("entries", cell["entry"]).setup(cfg, cell["traffic"], SEED,
                                                              "cpu")
    seen, real = [], api.degrid

    def degrid(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]

    monkeypatch.setattr(api, "degrid", degrid)
    with torch.no_grad():
        kept = entry.keep(1, entry.call(1))
    assert api.degrid is degrid and len(seen) == 1
    assert kept[-1] is seen[0] and kept[-1].shape == (entry.nrow, entry.nchan)
