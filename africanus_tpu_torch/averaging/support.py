"""Unique time/baseline support (host-side metadata).

A copy of ``africanus_tpu/averaging/support.py`` (numpy only; the port
imports nothing of the JAX package).

Equivalent of reference ``africanus/averaging/support.py`` (unique_time:58,
unique_baselines:79): inverse-index factorisations used by the averaging
mappers. These run on the host: mapping construction has data-dependent
output sizes and serial per-baseline loops.
"""

from __future__ import annotations

import numpy as np

__all__ = ["unique_time", "unique_baselines"]


def unique_time(time):
    """(unique_times, first_index, inverse_index, counts) for a float64
    time column."""
    time = np.asarray(time)
    utime, idx, inv, counts = np.unique(
        time, return_index=True, return_inverse=True, return_counts=True
    )
    return utime, idx, inv, counts


def unique_baselines(ant1, ant2):
    """(unique_baselines, first_index, inverse_index, counts) where unique
    baselines are (ant1, ant2) pairs packed for lexicographic uniqueness."""
    ant1 = np.asarray(ant1).astype(np.int64)
    ant2 = np.asarray(ant2).astype(np.int64)
    packed = (ant1 << 32) | ant2
    ubl_packed, idx, inv, counts = np.unique(
        packed, return_index=True, return_inverse=True, return_counts=True
    )
    ubl = np.stack([ubl_packed >> 32, ubl_packed & 0xFFFFFFFF], axis=1)
    return ubl, idx, inv, counts
