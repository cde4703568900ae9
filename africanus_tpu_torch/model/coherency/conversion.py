"""Stokes ↔ correlation conversion driven by nested schemas.

Port of ``africanus_tpu/model/coherency/conversion.py`` (reference
``africanus/model/coherency/conversion.py``: convert:222,
convert_setup:144). The conversion *plan* — which input elements
combine, with which ±/±i weights, into each output element — is host
Python built from the schemas; the execution is one weighted sum of two
input columns per output element on torch tensors (complex where the
weights or the output are). The JAX package's split re/im
``convert_ri`` has no counterpart: torch has complex dtypes.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from africanus_tpu_torch.utils.casa_types import STOKES_ID_MAP

__all__ = [
    "convert",
    "DimensionMismatch",
    "MissingConversionInputs",
    "STOKES_TO_CORR",
    "CORR_TO_STOKES",
]


class DimensionMismatch(Exception):
    pass


class MissingConversionInputs(Exception):
    pass


# out = w1 * in1 + w2 * in2 ; (input1, input2) -> (w1, w2, complex_result)
# Complex result flag mirrors the reference lambdas' "+ 0j" promotions.
STOKES_TO_CORR = {
    "RR": {("I", "V"): (1, 1, True)},
    "RL": {("Q", "U"): (1, 1j, True)},
    "LR": {("Q", "U"): (1, -1j, True)},
    "LL": {("I", "V"): (1, -1, True)},
    "XX": {("I", "Q"): (1, 1, True)},
    "XY": {("U", "V"): (1, 1j, True)},
    "YX": {("U", "V"): (1, -1j, True)},
    "YY": {("I", "Q"): (1, -1, True)},
}

CORR_TO_STOKES = {
    "I": {("XX", "YY"): (0.5, 0.5, False), ("RR", "LL"): (0.5, 0.5, False)},
    "Q": {("XX", "YY"): (0.5, -0.5, False), ("RL", "LR"): (0.5, 0.5, False)},
    "U": {("XY", "YX"): (0.5, 0.5, False), ("RL", "LR"): (-0.5j, 0.5j, False)},
    "V": {("XY", "YX"): (-0.5j, 0.5j, False), ("RR", "LL"): (0.5, -0.5, False)},
}

CONVERSION_SCHEMA = {**STOKES_TO_CORR, **CORR_TO_STOKES}

_COMPLEX_OF = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def _element_indices_and_shape(schema):
    """Flatten a (possibly nested) corr/stokes schema.

    Returns ({name: position-tuple}, shape): every leaf name maps to its
    multi-dimensional position within the nested lists, and ``shape`` is
    the rectangular extent the nesting implies. Ragged nestings and
    repeated names are rejected; CASA integer stokes ids are accepted and
    mapped to their names.
    """
    if not isinstance(schema, (tuple, list)):
        schema = [schema]

    positions = OrderedDict()
    shape = []

    def leaf_name(leaf):
        if np.issubdtype(type(leaf), np.integer):
            try:
                return STOKES_ID_MAP[leaf]
            except KeyError:
                raise ValueError(f"unknown CASA stokes id {leaf!r}")
        if isinstance(leaf, str):
            return leaf
        raise TypeError(
            f"schema elements must be strings or CASA stokes ids, "
            f"got {leaf!r} ({type(leaf).__name__})"
        )

    def descend(node, pos):
        depth = len(pos)
        if depth == len(shape):
            shape.append(len(node))
        elif len(node) != shape[depth]:
            raise DimensionMismatch(
                f"ragged schema: level {depth} has both "
                f"{shape[depth]} and {len(node)} elements"
            )
        for i, element in enumerate(node):
            if isinstance(element, (tuple, list)):
                descend(element, pos + (i,))
            else:
                name = leaf_name(element)
                if name in positions:
                    raise ValueError(
                        f"schema names {name!r} more than once"
                    )
                positions[name] = pos + (i,)

    descend(schema, ())
    return positions, tuple(shape)


def _build_plan(input_schema, in_indices, in_shape, out_indices, out_shape,
                implicit_stokes):
    """Resolve each output element to (out_flat, in1, w1, in2, w2, cplx),
    preferring real inputs over implicit zero defaults."""

    def flat_idx(idx, shape):
        return int(np.ravel_multi_index(idx, shape))

    plan = []
    for okey, out_idx in out_indices.items():
        try:
            deps = CONVERSION_SCHEMA[okey]
        except KeyError:
            raise ValueError(
                f"Unknown output {okey}. "
                f"Known outputs: {list(CONVERSION_SCHEMA.keys())}"
            )

        can_default = implicit_stokes and okey in STOKES_TO_CORR
        best = None
        for (c1, c2), (w1, w2, cplx) in deps.items():
            c1_ok = c1 in in_indices
            c2_ok = c2 in in_indices
            if not (c1_ok or can_default) or not (c2_ok or can_default):
                continue
            priority = int(c1_ok) + int(c2_ok)
            entry = (
                flat_idx(out_idx, out_shape),
                flat_idx(in_indices[c1], in_shape) if c1_ok else None,
                w1,
                flat_idx(in_indices[c2], in_shape) if c2_ok else None,
                w2,
                cplx,
            )
            if best is None or priority > best[0]:
                best = (priority, entry)

        if best is None:
            raise MissingConversionInputs(
                f"no supplied input of '{input_schema}' yields output "
                f"'{okey}'; producible from these input "
                f"combinations: '{list(deps.keys())}'"
            )
        plan.append(best[1])
    return plan


def convert(input, input_schema, output_schema, implicit_stokes: bool = False):
    """Convert between Stokes parameters and correlations.

    Parameters
    ----------
    input : tensor whose trailing dims match ``input_schema``'s shape
    input_schema : (nested) list of stokes/correlation names or CASA ids,
        e.g. ``["I", "Q", "U", "V"]``
    output_schema : (nested) list, e.g. ``[["XX", "XY"], ["YX", "YY"]]``
    implicit_stokes : bool
        When converting stokes→correlation, substitute zero for missing
        stokes inputs (enables e.g. ``["I"] -> ["XX","XY","YX","YY"]``).

    Returns
    -------
    Tensor with leading dims of ``input`` and trailing dims of the output
    schema shape: complex64/complex128 when converting to correlations
    (or from complex input), else at least float32.
    """
    in_indices, in_shape = _element_indices_and_shape(input_schema)
    out_indices, out_shape = _element_indices_and_shape(output_schema)

    if tuple(input.shape[-len(in_shape):]) != in_shape:
        raise ValueError("input schema length differs from the trailing input dimension")

    # Flatten schema dims: trailing axes -> one axis indexed by flat position
    lead = tuple(input.shape[: -len(in_shape)])
    flat_in = input.reshape(lead + (int(np.prod(in_shape)),))

    plan = _build_plan(
        input_schema, in_indices, in_shape, out_indices, out_shape, implicit_stokes
    )
    any_complex = any(
        cplx or isinstance(w1, complex) or isinstance(w2, complex)
        for _, _, w1, _, w2, cplx in plan
    )

    real = torch.promote_types(input.dtype, torch.float32)
    if input.dtype.is_complex:
        out_dtype = input.dtype
    elif any_complex:
        out_dtype = _COMPLEX_OF[real]
    else:
        out_dtype = real

    # Execute: one linear combination per output element
    cols = [None] * int(np.prod(out_shape))
    zero = torch.zeros(lead, dtype=out_dtype, device=input.device)
    for out_flat, i1, w1, i2, w2, _ in plan:
        t1 = flat_in[..., i1] * w1 if i1 is not None else zero
        t2 = flat_in[..., i2] * w2 if i2 is not None else zero
        cols[out_flat] = (t1 + t2).to(out_dtype)

    out = torch.stack(cols, dim=-1)
    return out.reshape(lead + out_shape)
