"""The port's MS-shaped store (io/ms_store.py), row streamer
(parallel/chunked.py) and store predict example
(examples/predict_to_ms_store.py) against the JAX package on the CPU.

- a store written by either package opens in the other, bitwise, and
  the two write the same bytes for the same columns;
- ``stream_rows`` concat and sum against one-shot calls, as
  tests/test_parallel.py:112-160 does (concat exact; the chunked adjoint
  DFT sums rows in another order: rtol 1e-10), and against the JAX
  package's ``stream_rows`` on the same function;
- the example's ``predict_to_ms_store`` at the JAX example's demo size
  against the JAX example's own pipeline: MODEL_DATA within 2e-6 of max
  (both float32; the bound of the predict_kb route, as in
  tests/test_torch_wsclean.py).
"""

import importlib.util
import sys
from collections import namedtuple
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from africanus_tpu.io import MSStore as JaxStore
from africanus_tpu.parallel import stream_rows as jax_stream_rows
from africanus_tpu_torch.dft import vis_to_im
from africanus_tpu_torch.examples import predict_to_ms_store as example
from africanus_tpu_torch.io import MSStore
from africanus_tpu_torch.parallel import stream_rows
from africanus_tpu_torch.rime.phase import phase_delay

REPO = Path(__file__).resolve().parent.parent


def _columns(rng, nrow=20, nchan=4):
    return dict(
        TIME=np.repeat(np.arange(5.0), nrow // 5),
        ANTENNA1=np.arange(nrow, dtype=np.int32) % 3,
        UVW=rng.normal(size=(nrow, 3)),
        DATA=(rng.normal(size=(nrow, nchan, 2))
              + 1j * rng.normal(size=(nrow, nchan, 2))).astype(np.complex64),
        MODEL_DATA=np.zeros((nrow, nchan, 2), np.complex128),
        FLAG=rng.uniform(size=(nrow, nchan, 2)) < 0.3,
    )


SUBTABLES = dict(SPECTRAL_WINDOW=dict(CHAN_FREQ=np.linspace(1e9, 2e9, 4)),
                 FIELD=dict(PHASE_DIR=[np.float64(1.0), -0.5]),
                 ANTENNA=dict(POSITION=np.arange(9.0).reshape(3, 3), NAME=("a", "b", "c")))


@pytest.mark.parametrize("writer,reader", [(MSStore, JaxStore), (JaxStore, MSStore)],
                         ids=["port-to-jax", "jax-to-port"])
def test_port_store_opens_in_the_other_package(tmp_path, rng, writer, reader):
    cols = _columns(rng)
    writer.create(tmp_path / "ms", cols, SUBTABLES)
    st = reader(tmp_path / "ms")
    assert st.nrow == 20 and st.columns() == sorted(cols)
    assert st.subtables == {k: {n: np.asarray(v).tolist() for n, v in t.items()}
                            for k, t in SUBTABLES.items()}
    for name, want in cols.items():
        got = st.read(name)
        assert got.dtype == want.dtype
        assert_array_equal(got, want)
    assert_array_equal(st.read_pair("DATA")[..., 1], cols["DATA"].imag)

    # a row-slice write by the reader, read back by the writer
    new = (np.ones((5, 4, 2)) + 2j * np.arange(40).reshape(5, 4, 2)).astype(np.complex128)
    st.write("MODEL_DATA", new, slice(5, 10))
    back = writer(tmp_path / "ms").read("MODEL_DATA")
    assert_array_equal(back[5:10], new)
    assert not back[:5].any() and not back[10:].any()


def test_port_store_writes_the_same_bytes(tmp_path, rng):
    cols = _columns(rng)
    MSStore.create(tmp_path / "port", cols, SUBTABLES)
    JaxStore.create(tmp_path / "jax", cols, SUBTABLES)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_port_store_chunks_and_errors(tmp_path, rng):
    cols = _columns(rng)
    st = MSStore.create(tmp_path / "ms", cols, SUBTABLES)
    seen = 0
    for sl, uvw, data in st.iter_chunks(7, "UVW", "DATA"):
        assert uvw.shape[0] == data.shape[0] == sl.stop - sl.start
        assert_array_equal(uvw, cols["UVW"][sl])
        assert_array_equal(data, cols["DATA"][sl])
        seen += uvw.shape[0]
    assert seen == st.nrow
    with pytest.raises(KeyError):
        st.read("NOPE")
    with pytest.raises(ValueError, match="not a complex column"):
        st.read_pair("UVW")
    with pytest.raises(ValueError, match="not created as a complex column"):
        st.write("UVW", np.ones((20, 3), np.complex64))
    with pytest.raises(FileNotFoundError):
        MSStore(tmp_path / "missing")
    with pytest.raises(ValueError, match="rows"):
        MSStore.create(tmp_path / "bad", dict(A=np.zeros(3), B=np.zeros(4)))


# ------------------------------------------------------------- stream_rows

def test_port_stream_rows_concat_matches_full(rng):
    """Chunked phase delay == one-shot, and == the JAX streamer's."""
    import jax.numpy as jnp

    from africanus_tpu.rime.phase import phase_delay as jax_phase_delay

    nrow, nsrc, nchan = 100, 3, 4
    uvw = rng.normal(size=(nrow, 3)) * 100
    lm = torch.as_tensor(rng.normal(size=(nsrc, 2)) * 1e-3)
    freq = torch.as_tensor(np.linspace(1e9, 2e9, nchan))

    def fn(tree, valid):
        # (src, chunk, chan) -> row-leading for stitching
        return {"k": phase_delay(lm, tree["uvw"], freq).movedim(1, 0)}

    out = stream_rows(fn, {"uvw": uvw}, chunk=32, combine="concat", device="cpu")
    full = phase_delay(lm, torch.as_tensor(uvw), freq).movedim(1, 0).numpy()
    assert out["k"].shape == (nrow, nsrc, nchan)
    assert_array_equal(out["k"], full)

    def jfn(tree, valid):
        return {"k": jnp.moveaxis(jax_phase_delay(lm.numpy(), tree["uvw"],
                                                  freq.numpy()), 1, 0)}

    want = jax_stream_rows(jfn, {"uvw": uvw}, chunk=32, combine="concat")
    assert_allclose(out["k"], want["k"], rtol=1e-12, atol=1e-12)


def test_port_stream_rows_sum_matches_full(rng):
    """Chunked adjoint DFT == one-shot, the padded rows masked."""
    nrow, nsrc, nchan = 70, 4, 3
    uvw = rng.normal(size=(nrow, 3)) * 100
    lm = torch.as_tensor(rng.normal(size=(nsrc, 2)) * 1e-3)
    freq = np.linspace(1e9, 2e9, nchan)
    vis = rng.normal(size=(nrow, nchan, 1)) + 1j * rng.normal(size=(nrow, nchan, 1))
    flags = np.zeros((nrow, nchan, 1), bool)

    def fn(tree, valid):
        flg = ~valid[:, None, None] | tree["flags"]
        return vis_to_im(tree["vis"], tree["uvw"], lm, freq, flg)

    out = stream_rows(fn, {"uvw": uvw, "vis": vis, "flags": flags},
                      chunk=32, combine="sum", device="cpu")
    full = vis_to_im(torch.as_tensor(vis), torch.as_tensor(uvw), lm, freq,
                     torch.as_tensor(flags))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float64
    assert_allclose(out.numpy(), full.numpy(), rtol=1e-10)


def test_port_stream_rows_trees_and_row_axes(rng):
    """Tuples, lists and named tuples in and out; leaves that are tensors;
    ``valid`` marks the padded tail; row_axes False keeps the first
    chunk's leaf untrimmed."""
    Pair = namedtuple("Pair", "a b")
    x = rng.normal(size=(10, 2))
    y = torch.as_tensor(rng.integers(0, 9, 10))
    seen = []

    def fn(tree, valid):
        (a, [b]) = tree
        seen.append((a.shape, valid.clone()))
        return Pair(a * 2, [b + 1, valid.sum()[None].expand(4)])

    out = stream_rows(fn, (x, [y]), chunk=4, device="cpu",
                      row_axes=Pair(True, [True, False]))
    assert [s for s, _ in seen] == [(4, 2)] * 3
    assert seen[-1][1].tolist() == [True, True, False, False]
    assert isinstance(out, Pair)
    assert_array_equal(out.a, x * 2)
    assert_array_equal(out.b[0], y.numpy() + 1)
    assert out.b[1].tolist() == [4] * 4

    with pytest.raises(ValueError, match="leading row dim"):
        stream_rows(fn, (x, [y[:3]]), device="cpu")
    with pytest.raises(ValueError, match="at least one array"):
        stream_rows(fn, {}, device="cpu")
    with pytest.raises(ValueError, match="unknown combine"):
        stream_rows(fn, (x, [y]), combine="max", device="cpu")


def test_port_stream_rows_defaults_to_the_card():
    """Without a card the default device raises before any chunk runs."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    calls = []
    with pytest.raises(RuntimeError, match="no CUDA card"):
        stream_rows(lambda t, v: calls.append(t), {"a": np.zeros(3)})
    assert not calls


# ------------------------------------------------------------- the example

def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_predict_to_ms_store", REPO / "examples" / "predict_to_ms_store.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_port_example_matches_jax_pipeline(tmp_path, monkeypatch, capsys):
    """The JAX example's main() on its demo store and model, and the
    port's predict_to_ms_store on the same (its store bytes equal):
    MODEL_DATA agrees to 2e-6 of max."""
    jax_example = _jax_example()
    monkeypatch.setattr(sys, "argv", ["predict_to_ms_store.py", str(tmp_path / "jax")])
    jax_example.main()
    want = JaxStore(tmp_path / "jax").read("MODEL_DATA")

    example.make_store(tmp_path / "port")
    for name in ("UVW", "TIME", "ANTENNA1", "meta"):
        suffix = ".json" if name == "meta" else ".npy"
        assert ((tmp_path / "port" / (name + suffix)).read_bytes()
                == (tmp_path / "jax" / (name + suffix)).read_bytes())
    model = tmp_path / "model.txt"
    model.write_text(example.DEMO_MODEL)
    assert example.DEMO_MODEL == jax_example.DEMO_MODEL
    run = example.predict_to_ms_store(tmp_path / "port", model, chunk=500, device="cpu")
    got = MSStore(tmp_path / "port").read("MODEL_DATA")
    assert got.shape == want.shape == (1440, 64, 1) and got.dtype == np.complex64
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    assert run.nvis == got.size and len(run.slices) == 3 and run.launches == 0
    assert [sl.stop for sl in run.slices] == [500, 1000, 1440]
    for sl, d in zip(run.slices, run.digests):
        assert d == example.chunk_digest(got[sl])
        assert d == example.chunk_digest(JaxStore(tmp_path / "port").read_pair("MODEL_DATA", sl))
    assert set(run.stage_seconds[0]) == {"read", "predict", "copy", "write"}


def test_port_example_random_model_and_main(tmp_path, capsys):
    """A random component list parses back to its draws' kinds and
    positions (within 1 degree of the phase centre), and main() runs the
    whole pipeline on the CPU."""
    from africanus_tpu_torch.model.wsclean import load

    phase_dir = (1.0472, -0.8813)
    text = example.random_component_list(200, phase_dir, seed=3)
    sources = dict(load(iter(text.splitlines())))
    assert len(sources["Name"]) == 200
    kinds = np.array(sources["Type"])
    assert 30 < (kinds == "GAUSSIAN").sum() < 90
    assert {len(c) for c in sources["SpectralIndex"]} == {1, 2, 3}
    sky = example.sky_arrays(sources, phase_dir)
    assert np.hypot(*sky["lm"].T).max() < np.deg2rad(1.0) * 1.001
    assert (sky["gauss_shape"][kinds == "POINT"] == 0).all()
    assert (sky["gauss_shape"][kinds == "GAUSSIAN", 0] > 0).all()

    model = tmp_path / "model.txt"
    model.write_text(example.random_component_list(20, (1.0472, -0.8813)))
    example.main([str(tmp_path / "store"), "--model", str(model), "--device", "cpu",
                  "--chunk", "600"])
    out = capsys.readouterr().out
    assert "in 3 chunks" in out and "bitwise equal: True" in out


def test_port_example_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    example.make_store(tmp_path / "s", nant=4, ntime=2, nchan=4)
    (tmp_path / "m.txt").write_text(example.DEMO_MODEL)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        example.predict_to_ms_store(tmp_path / "s", tmp_path / "m.txt")
