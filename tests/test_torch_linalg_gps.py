"""The port's Kronecker algebra (linalg/kronecker_tools.py) and GP
kernels (gps/) against the JAX package on the CPU.

- every function on numpy-seeded inputs in float64 at rtol 1e-12 and in
  float32 at 1e-5 of max (the JAX functions pin HIGHEST precision; both
  sum the same products in another order);
- the batched ``kron_matmat``/``kron_tensormat`` against dense
  ``np.kron`` (rtol 1e-12);
- ``kron_cholesky`` on a positive-definite factor, on the JAX package's
  float32 semidefinite factor (tests/test_linalg_gps.py:148: the same
  factor, 1e-6), and where the first Cholesky fails and the 1e6× jitter
  retry is taken (the JAX function's NaN test, the port's ``info``);
- ``exponential_squared`` in both modes and its three errors;
- ``abs_diff`` at 1-D and 3-D inputs above 25 rows, where
  ``torch.cdist``'s matmul expansion would lose the small distances;
- float32 products are full FP32: no TF32, "highest" matmul precision.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from africanus_tpu import gps as jgps
from africanus_tpu import linalg as jlin
from africanus_tpu_torch import gps, linalg


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _factors(rng, shapes, dtype):
    return [rng.normal(size=s).astype(dtype) for s in shapes]


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("shapes", [((3, 3), (4, 4), (2, 2)), ((7, 7),),
                                    ((5, 5), (6, 6))])
def test_port_kron_matvec_matches_jax(shapes, dtype, bound):
    rng = np.random.default_rng(len(shapes))
    K = _factors(rng, shapes, dtype)
    b = rng.normal(size=linalg.kron_N(K)).astype(dtype)
    assert linalg.kron_N(K) == jlin.kron_N(K)
    got = linalg.kron_matvec([torch.as_tensor(k) for k in K], torch.as_tensor(b))
    assert got.dtype == torch.as_tensor(b).dtype
    assert _rel(got, jlin.kron_matvec(K, b)) <= bound


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_port_kron_tensorvec_matches_jax(dtype, bound):
    rng = np.random.default_rng(3)
    K = _factors(rng, ((3, 2), (5, 4), (2, 3)), dtype)
    b = rng.normal(size=2 * 4 * 3).astype(dtype)
    got = linalg.kron_tensorvec(K, torch.as_tensor(b))
    assert got.shape == (30,)
    assert _rel(got, jlin.kron_tensorvec(K, b)) <= bound


@pytest.mark.parametrize("k", [1, 9, 64])
def test_port_kron_matmat_batched_matches_dense_and_jax(k):
    rng = np.random.default_rng(k)
    K = _factors(rng, ((3, 3), (4, 4), (5, 5)), np.float64)
    B = rng.normal(size=(60, k))
    dense = np.kron(np.kron(K[0], K[1]), K[2]) @ B
    got = linalg.kron_matmat(K, torch.as_tensor(B))
    assert got.shape == (60, k)
    assert_allclose(got.numpy(), dense, rtol=1e-12, atol=1e-12 * np.abs(dense).max())
    assert _rel(got, jlin.kron_matmat(K, B)) <= 1e-12
    got32 = linalg.kron_matmat([x.astype(np.float32) for x in K],
                               torch.as_tensor(B, dtype=torch.float32))
    assert got32.dtype == torch.float32 and _rel(got32, dense) <= 1e-5


@pytest.mark.parametrize("k", [1, 5])
def test_port_kron_tensormat_batched_matches_dense_and_jax(k):
    rng = np.random.default_rng(10 + k)
    K = _factors(rng, ((2, 3), (5, 4), (3, 2)), np.float64)
    B = rng.normal(size=(3 * 4 * 2, k))
    dense = np.kron(np.kron(K[0], K[1]), K[2]) @ B
    got = linalg.kron_tensormat(K, torch.as_tensor(B))
    assert got.shape == (30, k)
    assert_allclose(got.numpy(), dense, rtol=1e-12, atol=1e-12 * np.abs(dense).max())
    assert _rel(got, jlin.kron_tensormat(K, B)) <= 1e-12


def test_port_kron_promotes_like_jax():
    """float32 factors with float64 right-hand sides compute in float64,
    as jnp.matmul promotes."""
    rng = np.random.default_rng(4)
    K = _factors(rng, ((3, 3), (4, 4)), np.float32)
    b = rng.normal(size=12)
    got = linalg.kron_matvec(K, torch.as_tensor(b))
    assert got.dtype == torch.float64
    assert _rel(got, jlin.kron_matvec(K, b)) <= 1e-12


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_port_kron_cholesky_positive_definite(dtype, bound):
    rng = np.random.default_rng(6)
    K = []
    for n in (3, 4, 6):
        X = rng.normal(size=(n, n))
        K.append((X @ X.T + n * np.eye(n)).astype(dtype))
    got = linalg.kron_cholesky([torch.as_tensor(k) for k in K])
    want = jlin.kron_cholesky(K)
    for g, w, k in zip(got, want, K):
        assert g.dtype == torch.as_tensor(k).dtype
        assert _rel(g, w) <= bound
        assert _rel(g @ g.T, k) <= 10 * bound
    # the chol of the Kronecker product is the product of the chols
    dense = np.kron(np.kron(*[g.numpy() for g in got[:2]]), got[2].numpy())
    full = np.kron(np.kron(K[0], K[1]), K[2])
    assert _rel(dense @ dense.T, full) <= 10 * bound


def test_port_kron_cholesky_f32_semidefinite_matches_jax():
    """tests/test_linalg_gps.py:148's factor: ones((4, 4)) in float32,
    rank 1. The dtype-aware jitter makes it factor; the port's factor is
    the JAX package's."""
    A = np.ones((4, 4), np.float32)
    (L,) = linalg.kron_cholesky([torch.as_tensor(A)])
    (W,) = jlin.kron_cholesky([A])
    assert L.dtype == torch.float32 and bool(torch.isfinite(L).all())
    assert np.abs(L.numpy() - np.asarray(W)).max() <= 1e-6
    assert np.allclose(L.numpy() @ L.numpy().T, A, atol=1e-2)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_port_kron_cholesky_retry_matches_jax(dtype):
    """An indefinite factor (eigenvalues −1e-4·scale) fails at the base
    jitter: both packages take the factor at 1e6× the jitter (the JAX
    one sees NaNs, the port a nonzero info) and agree."""
    eps = np.finfo(dtype).eps
    A = (np.ones((4, 4)) - 1e4 * eps * np.eye(4)).astype(dtype)
    _, info = torch.linalg.cholesky_ex(torch.as_tensor(A) + 10 * eps * torch.eye(
        4, dtype=torch.as_tensor(A).dtype))
    assert int(info) != 0  # the first attempt fails
    (L,) = linalg.kron_cholesky([torch.as_tensor(A)])
    (W,) = jlin.kron_cholesky([A])
    assert bool(torch.isfinite(L).all())
    base = 10 * eps * np.abs(np.diag(A)).mean()
    retry = np.linalg.cholesky(A.astype(np.float64) + 1e6 * base * np.eye(4))
    bound = 1e-12 if dtype == np.float64 else 1e-5
    assert _rel(L, W) <= bound
    assert _rel(L, retry) <= bound


def test_port_kron_cholesky_caller_jitter():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(5, 5))
    A = X @ X.T
    (L,) = linalg.kron_cholesky([torch.as_tensor(A)], jitter=0.5)
    (W,) = jlin.kron_cholesky([A], jitter=0.5)
    assert _rel(L, W) <= 1e-12
    assert _rel(L @ L.T, A + 0.5 * np.eye(5)) <= 1e-12


@pytest.mark.parametrize("shape", [(40,), (40, 3), (31, 1)])
def test_port_abs_diff_matches_jax_above_25_rows(shape):
    """Above 25 rows ``torch.cdist`` would switch to the matmul expansion;
    the explicit difference keeps distances of 1e-9 on coordinates of
    ~1e3 (the expansion leaves ~1e-4 of noise there)."""
    rng = np.random.default_rng(len(shape))
    x = 1e3 + rng.normal(size=shape)
    xp = x + 1e-9 * rng.normal(size=shape)
    got = gps.abs_diff(torch.as_tensor(x), torch.as_tensor(xp))
    want = np.asarray(jgps.abs_diff(x, xp))
    assert got.shape == want.shape == (shape[0], shape[0])
    assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-18)
    diag = np.abs(x - xp) if len(shape) == 1 else np.linalg.norm(x - xp, axis=1)
    assert_allclose(np.diag(got.numpy()), diag, rtol=1e-6)
    assert np.diag(got.numpy()).max() < 1e-8


@pytest.mark.parametrize("dtype,bound", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_port_exponential_squared_matches_jax(dtype, bound):
    rng = np.random.default_rng(9)
    x = rng.uniform(size=(30, 2)).astype(dtype)
    xp = rng.uniform(size=(20, 2)).astype(dtype)
    got = gps.exponential_squared(torch.as_tensor(x), torch.as_tensor(xp), 0.7, 0.3)
    want = np.asarray(jgps.exponential_squared(x, xp, 0.7, 0.3))
    assert got.shape == (30, 20) and got.dtype == torch.as_tensor(x).dtype
    assert _rel(got, want) <= bound
    t = np.linspace(0.0, 1.0, 16)
    assert _rel(gps.exponential_squared(t, t, 0.25, 0.2),
                jgps.exponential_squared(t, t, 0.25, 0.2)) <= 1e-12


@pytest.mark.parametrize("n", [16, 33])
def test_port_exponential_squared_power_spectrum_matches_jax(n):
    x = np.linspace(-2.0, 3.0, n)[:, None]
    got = gps.exponential_squared(torch.as_tensor(x), torch.as_tensor(x), 1.3, 0.4,
                                  pspec=True)
    want = np.asarray(jgps.exponential_squared(x, x, 1.3, 0.4, pspec=True))
    assert got.shape == want.shape == (n,)
    assert_allclose(got.numpy(), want, rtol=1e-12)


def test_port_exponential_squared_power_spectrum_errors():
    x = np.linspace(0.0, 1.0, 8)[:, None]
    with pytest.raises(NotImplementedError, match="1D inputs"):
        gps.exponential_squared(np.hstack([x, x]), np.hstack([x, x]), 1.0, 1.0,
                                pspec=True)
    with pytest.raises(ValueError, match="x == xp"):
        gps.exponential_squared(x, x + 1.0, 1.0, 1.0, pspec=True)
    uneven = np.sort(np.random.default_rng(0).uniform(size=(8, 1)), axis=0)
    with pytest.raises(ValueError, match="uniform grid"):
        gps.exponential_squared(uneven, uneven, 1.0, 1.0, pspec=True)


def test_port_float32_products_are_full_fp32():
    """The kron products rely on full-FP32 matmuls: the port never turns
    TF32 on nor lowers the float32 matmul precision, not even on import
    of its examples."""
    import importlib
    import pkgutil

    import africanus_tpu_torch.examples as examples

    for info in pkgutil.iter_modules(examples.__path__):
        importlib.import_module(f"africanus_tpu_torch.examples.{info.name}")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    rng = np.random.default_rng(12)
    K = _factors(rng, ((64, 64), (32, 32)), np.float64)
    b = rng.normal(size=64 * 32)
    want = np.kron(K[0], K[1]) @ b
    got = linalg.kron_matvec([torch.as_tensor(k, dtype=torch.float32) for k in K],
                             torch.as_tensor(b, dtype=torch.float32))
    # full FP32 over 64 + 32 terms: ~1e-6 of max; TF32's 10-bit mantissa
    # would leave ~1e-3
    assert _rel(got, want) <= 1e-5
