"""Numerical sanitizers.

Port of ``africanus_tpu/utils/debug.py``. The reference's closest
analogue is its autouse numba NRT allocation-balance fixture
(africanus/conftest.py:10-18); the failure class guarded here is silent
NaN/Inf generation.

- ``assert_finite(**named_arrays)``: an explicit guard for pipeline
  boundaries, over tensors (on any device), numpy arrays and nests of
  them in dicts, tuples and lists. It reads the values on the host, so
  call it at host synchronisation points.
- ``debug_env_enabled()``: the opt-in switch ``AFRICANUS_TPU_DEBUG_NANS``,
  the same variable as the JAX package's.

The JAX package's ``debug_mode`` switches on ``jax_debug_nans`` (each
jitted computation re-run op by op to find the first NaN) and
``jax_disable_jit``. The port runs eagerly, so neither has a
counterpart: there is no jit to disable, and ``assert_finite`` at a
stage's end finds where NaNs appear.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["assert_finite", "debug_env_enabled"]


def debug_env_enabled():
    """True when the opt-in env switch is set (any non-empty value)."""
    return bool(os.environ.get("AFRICANUS_TPU_DEBUG_NANS"))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _non_finite(leaf):
    """How many values of ``leaf`` are not finite."""
    if isinstance(leaf, torch.Tensor):
        return int((~torch.isfinite(leaf)).sum())
    vals = np.asarray(leaf)
    return int(np.size(vals) - np.isfinite(vals).sum())


def assert_finite(**arrays):
    """Raise FloatingPointError naming every non-finite array.

    Reads the values on the host — call at host synchronisation points
    (the end of a pipeline stage).
    """
    bad = []
    for name, arr in arrays.items():
        for i, leaf in enumerate(_leaves(arr)):
            n = _non_finite(leaf)
            if n:
                bad.append(f"{name}[leaf {i}]: {n} non-finite values")
    if bad:
        raise FloatingPointError("; ".join(bad))
