"""Kronecker-structured linear algebra.

Port of ``africanus_tpu/linalg/kronecker_tools.py`` (reference
``africanus/linalg/kronecker_tools.py``: kron_matvec:29, kron_tensorvec,
kron_matmat, kron_cholesky:157): operate with A = K₀ ⊗ K₁ ⊗ … without
materialising the Kronecker product. Inputs are sequences of factor
matrices (tensors or arrays); the work runs on the right-hand side's
device.

The JAX package pins ``Precision.HIGHEST`` on every product, because
covariance factors carry a dynamic range that reduced-precision operands
corrupt. Here float32 products stay in full FP32 as long as TF32 is off
(``torch.backends.cuda.matmul.allow_tf32``, False by default) and the
float32 matmul precision is ``"highest"`` (the default): nothing in the
port changes either.

:func:`kron_matmat` and :func:`kron_tensormat` apply each factor to all
columns at once, as (k, G, N/G) batched products transposed on the last
two axes: the same map as the JAX package's loop over columns, without
one launch per column and factor.
"""

from __future__ import annotations

import math

import torch

__all__ = ["kron_N", "kron_matvec", "kron_tensorvec", "kron_matmat",
           "kron_tensormat", "kron_cholesky"]


def kron_N(x):
    """Total number of rows of the Kronecker product of the factors."""
    return math.prod(int(xi.shape[0]) for xi in x)


def _apply(A, X, shapes):
    """Apply each factor to the batched right-hand sides X (k, N): the
    row-major reshape to (k, G_d, rest), the product, then the transpose
    of the last two axes flattened back (a copy). Factors and right-hand
    sides are promoted to one dtype, as ``jnp.matmul`` promotes them."""
    k = X.shape[0]
    for Ad, (gd, rest) in zip(A, shapes):
        Ad = torch.as_tensor(Ad, device=X.device)
        dtype = torch.promote_types(Ad.dtype, X.dtype)
        Ad, X = Ad.to(dtype), X.to(dtype)
        X = torch.matmul(Ad, X.reshape(k, gd, rest)).transpose(1, 2).reshape(k, -1)
    return X


def _square_shapes(A, n):
    shapes = []
    for Ad in A:
        gd = int(Ad.shape[0])
        shapes.append((gd, n // gd))
    return shapes


def _rect_shapes(A):
    G = [int(Ad.shape[1]) for Ad in A]
    M = [int(Ad.shape[0]) for Ad in A]
    shapes = []
    for d in range(len(A)):
        rest = math.prod(G[i] if i > d else M[i] for i in range(len(A)) if i != d)
        shapes.append((G[d], rest))
    return shapes


def kron_matvec(A, b):
    """A @ b for square Kronecker factors A = [K0, K1, …], in linear time."""
    x = torch.as_tensor(b)
    return _apply(A, x.reshape(1, -1), _square_shapes(A, x.numel()))[0]


def kron_tensorvec(A, b):
    """A @ b for arbitrary (possibly rectangular) Kronecker factors."""
    x = torch.as_tensor(b)
    return _apply(A, x.reshape(1, -1), _rect_shapes(A))[0]


def kron_matmat(A, B):
    """Matrix product of a Kronecker-factored square matrix with a dense
    matrix: (kron(*A)) @ B, every column at once, without materialising
    the Kronecker product (reference ``linalg/kronecker_tools.py``).

    Parameters
    ----------
    A : sequence of (ni, ni) square factors
    B : (prod ni, k) dense right-hand sides

    Returns
    -------
    (prod ni, k) product.
    """
    B = torch.as_tensor(B)
    return _apply(A, B.T, _square_shapes(A, B.shape[0])).T


def kron_tensormat(A, B):
    """As :func:`kron_matmat` but for rectangular Kronecker factors
    (ni, mi): maps (prod mi, k) -> (prod ni, k)."""
    B = torch.as_tensor(B)
    return _apply(A, B.T, _rect_shapes(A)).T


def kron_cholesky(A, jitter=None):
    """Cholesky factors of each Kronecker factor: chol(⊗Kᵢ) = ⊗chol(Kᵢ).

    As in the JAX package, the jitter is dtype-aware (10·eps of the mean
    |diagonal|, or ``jitter``), and a factor whose Cholesky fails is
    replaced by the one at 1e6× the jitter. "Fails" is a nonzero
    ``info`` from ``torch.linalg.cholesky_ex`` (which returns a partial
    factor where the JAX function returns NaNs) or a NaN in the factor;
    both factors are computed and one is selected on the device, with no
    host sync."""
    out = []
    for Ad in A:
        Ad = torch.as_tensor(Ad)
        eye = torch.eye(Ad.shape[0], dtype=Ad.dtype, device=Ad.device)
        scale = Ad.diagonal().abs().mean()
        base = (10.0 * torch.finfo(Ad.dtype).eps) * scale \
            if jitter is None else jitter
        L, info = torch.linalg.cholesky_ex(Ad + base * eye)
        L_retry, _ = torch.linalg.cholesky_ex(Ad + (base * 1e6) * eye)
        failed = (info != 0) | torch.isnan(L).any()
        out.append(torch.where(failed, L_retry, L))
    return out
