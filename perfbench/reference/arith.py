"""The arithmetic the plain references run in.

``F64`` is the reference proper: float64 and complex128 throughout.
``TF32`` is the control that ``correct`` has to reject: the same code in
float32, with the operands of every product rounded to TF32 (10 stored
mantissa bits, to nearest, ties away from zero, as the tensor cores'
``cvt.rna.tf32.f32`` rounds) and float32 sums. A product of two TF32
numbers is exact in float32, so this is what a TF32 tensor-core
contraction computes, applied to every product of the chain but those
that form a phase: a geometric delay and its product with a frequency
stay in float32 (the references multiply them without :meth:`Arith.mul`),
since a phase of hundreds of cycles held in 10 bits is no precision any
implementation would choose.
"""

from __future__ import annotations

import torch

__all__ = ["Arith", "F64", "TF32", "tf32_round"]


def tf32_round(x):
    """``x`` (float32, or complex64 by parts) rounded to TF32."""
    if x.is_complex():
        return torch.view_as_complex(tf32_round(torch.view_as_real(x.resolve_conj())))
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """A precision: its real and complex dtypes, and how it multiplies."""

    def __init__(self, name, real, cplx, rounds):
        self.name, self.real, self.cplx, self.rounds = name, real, cplx, rounds

    def r(self, x):
        """``x`` as this precision holds a product's operand (a Python
        number is a constant of the formula and stays as it is)."""
        if self.rounds and isinstance(x, torch.Tensor):
            return tf32_round(x)
        return x

    def mul(self, a, b):
        return self.r(a) * self.r(b)

    def einsum(self, spec, a, b):
        """A contraction of two operands (products rounded, sums in the
        precision's own dtype; TF32 tensor-core mode stays off, so a
        float32 contraction sums in float32)."""
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.einsum(spec, self.r(a), self.r(b))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved

    def real_t(self, x):
        return x.to(self.real)

    def cplx_t(self, x):
        return x.to(self.cplx)


F64 = Arith("float64", torch.float64, torch.complex128, rounds=False)
TF32 = Arith("tf32", torch.float32, torch.complex64, rounds=True)
