"""Shared averaging helpers (reference ``africanus/averaging/shared.py``).

A copy of ``africanus_tpu/averaging/shared.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

__all__ = ["merge_flags"]


def merge_flags(flag_row, flag):
    """Derive/validate row flags against per-visibility flags
    (reference shared.py:19).

    - both given: validate that flag_row[r] != 0 iff every flag[r] is set;
    - only flag_row: returned as-is;
    - only flag: row flags derived as all-correlations-flagged;
    - neither: None.
    """
    have_flag_row = flag_row is not None
    have_flag = flag is not None

    if have_flag_row and have_flag:
        flag = np.asarray(flag)
        all_flagged = (np.asarray(flag) != 0).reshape(flag.shape[0], -1).all(
            axis=1
        )
        if ((np.asarray(flag_row) != 0) != all_flagged).any():
            raise ValueError("flag_row contradicts the per-element flag array (mismatch)")
        return flag_row

    if have_flag_row:
        return flag_row

    if have_flag:
        flag = np.asarray(flag)
        return (
            (flag != 0).reshape(flag.shape[0], -1).all(axis=1)
        ).astype(np.uint8)

    return None
