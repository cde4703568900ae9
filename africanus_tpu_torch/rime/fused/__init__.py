"""The fused RIME compiler (port of ``africanus_tpu/rime/fused``)."""

from africanus_tpu_torch.rime.fused.core import rime, RimeFactory, consolidate_args
from africanus_tpu_torch.rime.fused.specification import (
    RimeSpecification,
    RimeParseError,
    RimeSpecificationError,
)
from africanus_tpu_torch.rime.fused.terms import (
    Term,
    TermValue,
    term_mul,
    hermitian,
    Phase,
    Brightness,
    Gaussian,
    FeedRotation,
    BeamCubeDDE,
)

__all__ = [
    "rime", "RimeFactory", "consolidate_args",
    "RimeSpecification", "RimeParseError", "RimeSpecificationError",
    "Term", "TermValue", "term_mul", "hermitian",
    "Phase", "Brightness", "Gaussian", "FeedRotation", "BeamCubeDDE",
]
