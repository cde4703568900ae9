"""CASA Measurement Set v2.0 Stokes enumerations.

Mirrors casacore's Stokes.h ordering (see reference
``africanus/util/casa_types.py``); these integer IDs appear in the
POLARIZATION subtable's CORR_TYPE column and drive schema parsing in
:mod:`africanus_tpu_torch.model.coherency`. A copy of
``africanus_tpu/utils/casa_types.py`` (data only), so that the port
imports nothing of the JAX package.
"""

STOKES_TYPES = [
    "Undefined",
    "I",
    "Q",
    "U",
    "V",
    "RR",
    "RL",
    "LR",
    "LL",
    "XX",
    "XY",
    "YX",
    "YY",
    "RX",
    "RY",
    "LX",
    "LY",
    "XR",
    "XL",
    "YR",
    "YL",
    "PP",
    "PQ",
    "QP",
    "QQ",
    "RCircular",
    "LCircular",
    "Linear",
    "Ptotal",
    "Plinear",
    "PFtotal",
    "PFlinear",
    "Pangle",
]

STOKES_TYPE_MAP = {k: i for i, k in enumerate(STOKES_TYPES)}
STOKES_ID_MAP = {v: k for k, v in STOKES_TYPE_MAP.items()}
