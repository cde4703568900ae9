"""The port's sharded execution (africanus_tpu_torch/parallel) against the
JAX package's, on the same seeded numpy inputs: the mesh, the DFTs,
the RIME predict and calibration here; imaging, the residual with the
Perley-polyhedron pair and the beam, and the averagers in
``tests/test_torch_parallel_{imaging,pp,averaging}.py``.

Each test of ``tests/test_parallel.py`` has its counterpart: the JAX
function runs on its 8 virtual CPU devices (``tests/conftest.py``), the
port's on ``make_mesh(..., devices=["cpu"] * 8)`` — eight shards on the
one CPU device, each running the port's single-device function (the
kernels' plain versions). Tolerances are the JAX tests' own: 1e-9 for
the float64 DFTs, 1e-8 for ``sharded_rime_predict``, 1e-12 for the
calibration residual and 1e-8 for the gain products. ``stream_rows`` is
held in ``tests/test_torch_ms_store.py``; ``test_pack_shard_plans_
table_format`` has no counterpart (the port makes a plan a shard and
packs none).

Beyond the JAX tests: ``make_mesh()`` raises without a card; the
float32 DFT routes (``dft_forward``, ``predict_kb`` at ≥ 128 channels,
``dft_adjoint``) sharded against unsharded; the one-shard predict
against the (4, 2) mesh's.
"""
import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import africanus_tpu.parallel as jpar
from africanus_tpu.ops.cplx import Cplx, to_numpy
from africanus_tpu_torch import parallel as tpar
from africanus_tpu_torch.dft import im_to_vis, vis_to_im

C = 2.99792458e8
CPU8 = ["cpu"] * 8


def _jmesh(shape=(8,), names=("row",), **kw):
    return jpar.make_mesh(shape, names, **kw)


def _tmesh(shape=(8,), names=("row",), **kw):
    return tpar.make_mesh(shape, names, devices=CPU8, **kw)


@pytest.fixture
def problem(rng):
    S, R, F, Cc = 10, 64, 16, 2
    lm = rng.uniform(-0.01, 0.01, (S, 2))
    uvw = rng.uniform(-1000, 1000, (R, 3))
    freq = np.linspace(1e9, 2e9, F)
    img = rng.normal(size=(S, F, Cc))
    vis = rng.normal(size=(R, F, Cc)) + 1j * rng.normal(size=(R, F, Cc))
    return lm, uvw, freq, img, vis


# ------------------------------------------------------------ mesh

def test_port_make_mesh_strict_and_degrade():
    with pytest.raises(ValueError, match="devices"):
        _tmesh((16, 2), ("row", "chan"))
    for want, req in (((4, 2), (4, 4)), ((2, 4), (2, 8))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = _tmesh(req, ("row", "chan"), strict=False)
            j = _jmesh(req, ("row", "chan"), strict=False)
        assert dict(m.shape) == dict(j.shape) == dict(zip(("row", "chan"), want))
    m = _tmesh((4, 2), ("row", "chan"))
    assert m.axis_names == ("row", "chan") and m.devices.shape == (4, 2)
    assert all(d == torch.device("cpu") for d in m.devices.ravel())
    assert m.axis_devices("row") == [torch.device("cpu")] * 4


def test_port_make_mesh_needs_a_card(monkeypatch):
    """The default mesh is every CUDA card; with none it raises (no CPU
    fallback), and so does an explicit CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tpar.make_mesh((2,), ("row",), devices=["cuda:0"] * 2)


def test_port_mesh_helpers_match_jax(rng):
    for n, k in ((38612, 8), (64, 8), (5, 3), (0, 4)):
        assert tpar.pad_rows(n, k) == jpar.pad_rows(n, k)
    m = _tmesh((4, 2), ("row", "chan"))
    sh = tpar.row_sharding(m, 3, chan_axis=1)
    assert sh.mesh is m and sh.spec == ("row", "chan", None)
    jm = _jmesh((4, 2), ("row", "chan"))
    assert tuple(jpar.row_sharding(jm, 3, chan_axis=1).spec) == sh.spec
    assert tpar.replicated(m).spec == tuple(jpar.replicated(jm).spec) == ()
    a = rng.normal(size=(16, 3))
    (parts,) = tpar.shard_rows(m, a)
    assert len(parts) == 4 and all(p.shape == (4, 3) for p in parts)
    assert np.array_equal(torch.cat(parts).numpy(), a)
    with pytest.raises(ValueError, match="pad_rows"):
        tpar.shard_rows(m, a[:15])


# ------------------------------------------------------------ predict

def test_port_sharded_im_to_vis(problem):
    lm, uvw, freq, img, _ = problem
    want = to_numpy(jpar.sharded_im_to_vis(_jmesh(), img, uvw, lm, freq))
    got = tpar.sharded_im_to_vis(_tmesh(), img, uvw, lm, freq).numpy()
    assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_port_sharded_vis_to_im(problem):
    lm, uvw, freq, _, vis = problem
    flags = np.zeros(vis.shape, bool)
    flags[3, 2, 1] = True
    want = np.asarray(jpar.sharded_vis_to_im(_jmesh(), vis, uvw, lm, freq,
                                             flags))
    got = tpar.sharded_vis_to_im(_tmesh(), vis, uvw, lm, freq, flags).numpy()
    assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("nchan", [16, 128])
def test_port_sharded_dft_float32_routes(problem, nchan):
    """The float32 routes (plans made once, the delay bound over every
    row): the sharded forward equals the unsharded call row for row, the
    adjoint its sum of shard images to float32 rounding."""
    lm, uvw, _, img, vis = problem
    freq = np.linspace(1e9, 2e9, nchan, dtype=np.float32)
    rng = np.random.default_rng(7)
    img = rng.normal(size=(lm.shape[0], nchan, 2)).astype(np.float32)
    vis = (rng.normal(size=(uvw.shape[0], nchan, 2))
           + 1j * rng.normal(size=(uvw.shape[0], nchan, 2))).astype(np.complex64)
    lm32, uvw32 = torch.as_tensor(lm, dtype=torch.float32), uvw.astype(np.float32)
    mesh = _tmesh()
    got = tpar.sharded_im_to_vis(mesh, img, uvw32, lm32, freq)
    want = im_to_vis(torch.as_tensor(img), torch.as_tensor(uvw32), lm32, freq)
    assert got.dtype == torch.complex64
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    flags = np.zeros(vis.shape, bool)
    got = tpar.sharded_vis_to_im(mesh, vis, uvw32, lm32, freq, flags)
    want = vis_to_im(torch.as_tensor(vis), torch.as_tensor(uvw32), lm32, freq,
                     flags)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 3e-6 * float(want.abs().max())


def test_port_sharded_rime_predict_2d_mesh(problem, rng):
    lm, uvw, freq, img, _ = problem
    gs = np.abs(rng.normal(size=(lm.shape[0], 3))) * 1e-4
    want = to_numpy(jpar.sharded_rime_predict(_jmesh((4, 2), ("row", "chan")),
                                              lm, uvw, freq, img + 0j, gs))
    got = tpar.sharded_rime_predict(_tmesh((4, 2), ("row", "chan")), lm, uvw,
                                    freq, img + 0j, gs).numpy()
    assert_allclose(got, want, rtol=1e-8, atol=1e-9)
    one = tpar.sharded_rime_predict(tpar.make_mesh((1, 1), devices=["cpu"]),
                                    lm, uvw, freq, img + 0j, gs).numpy()
    assert np.abs(got - one).max() <= 1e-10 * np.abs(one).max()
    # without an envelope, on a row-only mesh
    want = to_numpy(jpar.sharded_rime_predict(_jmesh(), lm, uvw, freq, img + 0j))
    got = tpar.sharded_rime_predict(_tmesh(), lm, uvw, freq, img + 0j).numpy()
    assert_allclose(got, want, rtol=1e-8, atol=1e-9)


# ------------------------------------------------------------ calibration

def test_port_sharded_residual_vis_and_gauss_newton(rng):
    from africanus_tpu.calibration import chunkify_rows, corrupt_vis_ri

    nant, ntime, nchan = 5, 8, 3
    a1u, a2u = np.triu_indices(nant, 1)
    nbl = a1u.size
    ant1 = np.tile(a1u, ntime)
    ant2 = np.tile(a2u, ntime)
    time = np.repeat(np.arange(ntime, dtype=np.float64), nbl)
    nrow = time.size
    _, tbi, tbc = chunkify_rows(time, 1)

    true_phase = rng.uniform(-0.5, 0.5, (ntime, nant, nchan, 1, 1))
    gains = Cplx(np.cos(true_phase), np.sin(true_phase))
    model = Cplx(rng.normal(size=(nrow, nchan, 1, 1)) + 2.0,
                 rng.normal(size=(nrow, nchan, 1, 1)))
    data = corrupt_vis_ri(tbi, tbc, ant1, ant2, gains, model)
    flag = np.zeros((nrow, nchan, 1), bool)
    flag[7, 1] = True
    weight = np.ones((nrow, nchan, 1))
    jmesh = _jmesh()
    g_c, d_c, m_c = (np.asarray(x.re) + 1j * np.asarray(x.im)
                     for x in (gains, data, model))

    want = to_numpy(jpar.sharded_residual_vis(jmesh, tbi, tbc, ant1, ant2,
                                              gains, data, flag, model))
    got = tpar.sharded_residual_vis(_tmesh(), tbi, tbc, ant1, ant2, g_c, d_c,
                                    flag, m_c).numpy()
    assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="divide"):
        tpar.sharded_residual_vis(_tmesh((3,)), tbi, tbc, ant1, ant2, g_c, d_c,
                                  flag, m_c)

    jones0 = Cplx(np.ones((ntime, nant, nchan, 1, 1)),
                  np.zeros((ntime, nant, nchan, 1, 1)))
    gj, _, _, kj = jpar.sharded_gauss_newton(jmesh, tbi, tbc, ant1, ant2,
                                             jones0, data, flag, model, weight,
                                             tol=1e-10, maxiter=50)
    gt, jhj, jhr, kt = tpar.sharded_gauss_newton(
        _tmesh(), tbi, tbc, ant1, ant2, np.ones((ntime, nant, nchan, 1, 1),
                                                complex),
        d_c, flag, m_c, weight, tol=1e-10, maxiter=50)
    assert gt.device.type == "cpu" and gt.shape == jhj.shape == jhr.shape

    def prods(c):
        return c[:, a1u] * np.conj(c[:, a2u])

    assert_allclose(prods(gt.numpy()), prods(to_numpy(gj)), rtol=1e-8,
                    atol=1e-8)
    assert isinstance(kt, int) and abs(kt - int(kj)) <= 1


def test_port_parallel_exports_match_jax():
    assert sorted(tpar.__all__) == sorted(jpar.__all__)
    for name in jpar.__all__:
        assert callable(getattr(tpar, name)), name
