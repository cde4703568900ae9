"""The port's examples (africanus_tpu_torch/examples/) run as their users
run them, ``python -m africanus_tpu_torch.examples.<name> --device cpu``,
at small sizes: the JAX-free twin of tests/test_examples.py, with its
checks. This file runs the examples without a store or a FITS file;
tests/test_torch_examples_io.py runs the other five.

Each example defaults to ``--device cuda``, so every call here passes
``--device cpu``; without a card the default raises before any work
(the last test).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def run_example(name, *args, timeout=240):
    env = dict(os.environ)
    env.pop("AFRICANUS_TPU_FORCE_CPU", None)
    return subprocess.run(
        [sys.executable, "-m", f"africanus_tpu_torch.examples.{name}", *map(str, args)],
        capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)


def _ok(r):
    assert r.returncode == 0, r.stderr[-1500:]
    assert "device: cpu" in r.stdout
    return r.stdout


def test_port_predict_dft_example():
    out = _ok(run_example("predict_dft", "--nsrc", 10, "--nchan", 8, "--ntime", 2,
                          "--device", "cpu"))
    assert "throughput" in out and "predicted vis: (42, 8, 2) complex64" in out


def test_port_make_dirty_example():
    out = _ok(run_example("make_dirty", 48, 2000, "--device", "cpu"))
    assert "peak at (np.int64(24), np.int64(24))" in out
    # every source recovered within 10%
    lines = [ln for ln in out.splitlines() if "recovered" in ln]
    assert len(lines) == 3
    for line in lines:
        true = float(line.split("true")[1].split(",")[0])
        got = float(line.split("recovered")[1])
        assert abs(got - true) < 0.1 * true


def test_port_selfcal_example():
    out = _ok(run_example("selfcal", "--device", "cpu"))
    assert "CLEAN peak at pixel (np.int64(32), np.int64(32))" in out


def test_port_generate_gains_example(tmp_path):
    import numpy as np

    out = _ok(run_example("generate_gains", tmp_path / "g.npy", "--device", "cpu"))
    gains = np.load(tmp_path / "g.npy")
    assert gains.shape == (16, 7, 8, 3, 1) and gains.dtype == np.complex128
    assert np.abs(np.abs(gains) - 1).max() < 1e-12
    assert "|g|=1 check" in out


@pytest.mark.parametrize("name,marker", [
    ("predict_wsclean", "predicted vis: (210, 64, 1)"),
    ("predict_shapelet", "predicted vis: (168, 32, 4)"),
    ("apply_gains", "max rel err corrected vs uncorrupted"),
    ("custom_rime_term", "max rel err vs explicit composition"),
    ("fit_spi", "alpha error: mean"),
])
def test_port_more_examples(name, marker):
    assert marker in _ok(run_example(name, "--device", "cpu"))


def test_port_examples_default_to_the_card():
    """Without a card the default device raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    r = run_example("apply_gains")
    assert r.returncode != 0
    assert "no CUDA card" in r.stderr
