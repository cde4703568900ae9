"""2x2 complex Jones-matrix products on complex tensors.

Port of ``africanus_tpu/ops/jones.py``. Torch has complex dtypes on
every device, so the products act on complex tensors whose trailing
dims are (2, 2), batched over the leading dims. Each output element is
the same two-term sum ``a[i,0]·b[0,k] + a[i,1]·b[1,k]`` as the JAX
package's component products, not a BLAS call.
"""

from __future__ import annotations

import torch

__all__ = ["mul2x2", "mul2x2_hr", "hermitian"]


def hermitian(a: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose over the trailing (2, 2) dims."""
    return a.transpose(-1, -2).conj()


def mul2x2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over trailing (2, 2) dims, batched over leading dims."""
    a0, a1 = a[..., :, 0, None], a[..., :, 1, None]  # (..., 2, 1) columns
    b0, b1 = b[..., None, 0, :], b[..., None, 1, :]  # (..., 1, 2) rows
    return a0 * b0 + a1 * b1


def mul2x2_hr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ bᴴ over trailing (2, 2) dims (right operand conjugate-transposed)."""
    return mul2x2(a, hermitian(b))
