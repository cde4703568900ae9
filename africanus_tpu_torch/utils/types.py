"""Dtype inference helpers.

Port of ``africanus_tpu/utils/types.py`` (reference
``africanus/util/type_inference.py`` infer_complex_dtype) on tensors.
"""

from __future__ import annotations

import torch

__all__ = ["complex_dtype_for", "real_dtype_for"]


def _real(dtype):
    return dtype.to_real() if dtype.is_complex else dtype


def real_dtype_for(*tensors):
    """Smallest real floating dtype covering every input's precision
    (complex inputs count as their component float): at least float32,
    float64 when an input is 64-bit."""
    result = torch.float32
    for x in tensors:
        result = torch.promote_types(result, _real(torch.as_tensor(x).dtype))
    return result


def complex_dtype_for(*tensors):
    """Smallest complex dtype covering every input's precision:
    complex64 for float32 inputs, complex128 when an input is 64-bit."""
    return real_dtype_for(*tensors).to_complex()
