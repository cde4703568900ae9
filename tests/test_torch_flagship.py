"""Port parity for the slice as a whole: FlagshipPredict (the port's
flagship RIME predict) against the JAX package's
``__graft_entry__._predict_step`` on the same ``_flagship`` inputs, and
against the float64 numpy oracle.

Bounds: both sides are float32 with the compensated two-float phase and
differ in cos/sin/exp rounding and in the order of the f32 source sum;
the JAX package's own float32 error at config 2 is 2.30e-6 of max|V|
against float64 (BENCH_r05.json), so 5e-6 of max|V| is the bound here,
between the two packages and for each against the float64 oracle.
"""

import ast
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)  # __graft_entry__ lives at the repo root

from __graft_entry__ import _flagship, _predict_step  # noqa: E402

from africanus_tpu_torch.rime.flagship import (  # noqa: E402
    FlagshipPredict, flagship_inputs, from_numpy, predict_oracle_f64,
)

SHAPE = dict(nsrc=8, ntime=2, nant=7, nchan=16)
BOUND = 5e-6


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def args():
    return _flagship(rng=np.random.default_rng(3), **SHAPE)


def test_flagship_inputs_equal_graft_entry(args):
    ours = flagship_inputs(seed=3, **SHAPE)
    assert len(ours) == len(args)
    for a, b in zip(ours, args):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_matches_jax_predict_step(args):
    out = _predict_step(*args)
    want = np.asarray(out.re) + 1j * np.asarray(out.im)
    model, inputs = from_numpy(args, "cpu")
    got = model(*inputs)
    assert got.dtype == torch.complex64
    assert got.shape == want.shape == (args[1].size, SHAPE["nchan"], 4)
    assert _rel(got.numpy(), want) < BOUND


def test_matches_f64_oracle(args):
    model, inputs = from_numpy(args, "cpu")
    got = model(*inputs).numpy()
    ti = args[0] - args[0].min()
    want = predict_oracle_f64(ti, *args[1:])
    assert _rel(got, want) < BOUND


def test_row_chunks_share_the_module():
    """A second row chunk (later times, its own gain table) through the
    same module: time_index is normalised by its minimum, so the chunk's
    gain table starts at its first time."""
    first = flagship_inputs(seed=5, **SHAPE)  # the sky and chunk 0
    rows = flagship_inputs(seed=6, **SHAPE)   # chunk 1's uvw and gains
    _, _, _, lm, _, freq, stokes, spi, ref_freq, gshape, _ = first
    ti, a1, a2, _, uvw, _, _, _, _, _, gphase = rows
    chunk1 = (ti + SHAPE["ntime"], a1, a2, lm, uvw, freq, stokes, spi,
              ref_freq, gshape, gphase)
    model, _ = from_numpy(first, "cpu")
    _, inputs = from_numpy(chunk1, "cpu")
    got = model(*inputs).numpy()
    want = predict_oracle_f64(ti, *chunk1[1:])
    assert _rel(got, want) < BOUND


def test_module_holds_sky_as_buffers(args):
    model, _ = from_numpy(args, "cpu")
    assert isinstance(model, FlagshipPredict)
    names = dict(model.named_buffers())
    assert set(names) == {"lm", "stokes", "spi", "ref_freq", "gauss_shape"}
    assert all(x.dtype == torch.float32 for x in names.values())
    assert list(model.parameters()) == []
    sd = model.state_dict()
    assert set(sd) == set(names)


def test_port_imports_no_jax():
    """The port runs where there is no JAX: no module of it may import
    jax or the JAX package."""
    root = pathlib.Path(REPO) / "africanus_tpu_torch"
    sources = sorted(root.rglob("*.py")) + [pathlib.Path(REPO) / "chip_smoke.py"]
    assert len(sources) > 10
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "africanus_tpu",
                                   "__graft_entry__", "bench"), (path, name)
