"""Feed rotation (L Jones) matrices.

Port of ``africanus_tpu/rime/feeds.py`` (reference
``africanus/rime/feeds.py:14-76``): 2x2 rotation matrices from
parallactic angles, vectorised over any leading shape, as torch complex
tensors (``feed_rotation_ri`` is folded in).

linear:  [[cos pa, sin pa], [-sin pa, cos pa]]
circular: diag(e^{-i pa}, e^{+i pa})
"""

from __future__ import annotations

import torch

__all__ = ["feed_rotation"]


def feed_rotation(parallactic_angles, feed_type: str = "linear") -> torch.Tensor:
    """Feed rotation matrices from parallactic angles.

    Parameters
    ----------
    parallactic_angles : (...,) float tensor, radians (any leading
        shape, typically (time, ant))
    feed_type : {"linear", "circular"}

    Returns
    -------
    (..., 2, 2) complex tensor (complex64 for float32 angles, complex128
    for float64), on the angles' device.
    """
    pa = torch.as_tensor(parallactic_angles)
    if not pa.is_floating_point():
        raise ValueError(
            f"parallactic_angles has non-floating point type {pa.dtype}"
        )

    c = torch.cos(pa)
    s = torch.sin(pa)
    zero = torch.zeros_like(pa)

    if feed_type == "linear":
        re = torch.stack([torch.stack([c, s], dim=-1),
                          torch.stack([-s, c], dim=-1)], dim=-2)
        im = torch.zeros_like(re)
    elif feed_type == "circular":
        re = torch.stack([torch.stack([c, zero], dim=-1),
                          torch.stack([zero, c], dim=-1)], dim=-2)
        im = torch.stack([torch.stack([-s, zero], dim=-1),
                          torch.stack([zero, s], dim=-1)], dim=-2)
    else:
        raise ValueError(f"Invalid feed_type '{feed_type}'")

    return torch.complex(re, im)
