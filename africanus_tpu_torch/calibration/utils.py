"""Calibration utilities: gain application and removal, residuals.

Port of ``africanus_tpu/calibration/utils.py`` (reference
``africanus/calibration/utils/``: check_type utils.py:11, chunkify_rows
utils.py:45, corrupt_vis.py:59, correct_vis.py:62, residual_vis.py:63,
compute_and_corrupt_vis.py:76) on complex tensors.

Gain modes follow the reference enumeration:
- DIAG_DIAG (0): jones (time, ant, chan, dir, corr), vis (row, chan, corr)
- DIAG (1):      jones (time, ant, chan, dir, 2),   vis (row, chan, 2, 2)
- FULL (2):      jones (time, ant, chan, dir, 2, 2), vis (row, chan, 2, 2)

Rows are contiguous per unique time, so each row's time bin is a
``torch.searchsorted`` over the bin starts; the rest is elementwise
complex arithmetic summed over the direction axis. Time-bin and antenna
indices may be numpy arrays or tensors; they are moved to the gains'
device.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.constants import minus_two_pi_over_c
from africanus_tpu_torch.ops import jones as j2

__all__ = [
    "DIAG_DIAG", "DIAG", "FULL", "check_type", "chunkify_rows",
    "corrupt_vis", "correct_vis", "residual_vis", "compute_and_corrupt_vis",
]

DIAG_DIAG = 0
DIAG = 1
FULL = 2


def check_type(jones, vis, vis_type="vis"):
    """Classify the gain mode from jones/vis dimension counts
    (reference utils.py:11-42)."""
    if vis_type == "vis":
        vis_ndim = (3, 4)
    elif vis_type == "model":
        vis_ndim = (4, 5)
    else:
        raise ValueError("Unknown vis_type")

    if vis.ndim == vis_ndim[0]:
        if jones.ndim != 5:
            raise RuntimeError(
                "Jones axes not compatible with visibility axes. "
                f"Expected length 5 but got length {jones.ndim}"
            )
        return DIAG_DIAG
    if vis.ndim == vis_ndim[1]:
        if jones.ndim == 5:
            return DIAG
        if jones.ndim == 6:
            return FULL
        raise RuntimeError("jones array rank does not match any supported mode")
    raise RuntimeError("vis array rank does not match any supported mode")


def chunkify_rows(time, utimes_per_chunk):
    """Row chunking aligned to unique times (reference utils.py:45-57).

    Host metadata: returns (row_chunks, time_bin_indices,
    time_bin_counts) with numpy int32 arrays.
    """
    if isinstance(time, torch.Tensor):
        time = time.cpu().numpy()
    utimes, counts = np.unique(np.asarray(time), return_counts=True)
    n_time = len(utimes)
    if utimes_per_chunk <= 0:
        utimes_per_chunk = n_time
    row_chunks = [
        int(np.sum(counts[i : i + utimes_per_chunk]))
        for i in range(0, n_time, utimes_per_chunk)
    ]
    tbi = np.zeros(n_time, dtype=np.int32)
    tbi[1:] = np.cumsum(counts)[:-1]
    return tuple(row_chunks), tbi, counts.astype(np.int32)


def _index(x, device):
    return torch.as_tensor(x, device=device).to(torch.int64)


def _row_time_index(time_bin_indices, nrow, device):
    """Per-row unique-time index from bin starts (bins are contiguous)."""
    tbi = _index(time_bin_indices, device)
    tbi = tbi - tbi.min()
    rows = torch.arange(nrow, device=device)
    return torch.searchsorted(tbi, rows, right=True) - 1


def _validate_corrs(*tensors):
    for x in tensors:
        if x.shape[-1] > 2:
            raise ValueError("at most 2 correlations are supported here")


def _row_gains(time_bin_indices, antenna1, antenna2, jones):
    """(gp, gq): each row's gains for its two antennas."""
    a1 = _index(antenna1, jones.device)
    a2 = _index(antenna2, jones.device)
    t = _row_time_index(time_bin_indices, a1.shape[0], jones.device)
    return jones[t, a1], jones[t, a2]


def _apply(mode, gp, x, gq):
    """Σ_dir G_p · X · G_qᴴ for one gain mode (the direction axis is 2)."""
    if mode == DIAG_DIAG:
        out = gp * x * gq.conj()
    elif mode == DIAG:
        out = gp[..., :, None] * x * gq.conj()[..., None, :]
    else:
        out = j2.mul2x2(gp, j2.mul2x2_hr(x, gq))
    return out.sum(dim=2)


def _keep(flag, ndim):
    """(row, chan, 1…) mask: False where any correlation of the cell is
    flagged."""
    keep = ~torch.any(flag.reshape(flag.shape[0], flag.shape[1], -1) != 0,
                      dim=-1)
    return keep.reshape(keep.shape + (1,) * (ndim - 2))


def corrupt_vis(time_bin_indices, time_bin_counts, antenna1, antenna2,
                jones, model):
    """Apply (possibly direction-dependent) gains to model visibilities:
    V_pq = Σ_s G_p,s · M_pq,s · G_q,sᴴ (reference corrupt_vis.py:59).

    jones : (time, ant, chan, dir, corr…) complex; model : (row, chan,
    dir, corr…) complex. Returns (row, chan, corr…) complex.
    """
    mode = check_type(jones, model, vis_type="model")
    _validate_corrs(model, jones)
    gp, gq = _row_gains(time_bin_indices, antenna1, antenna2, jones)
    return _apply(mode, gp, model, gq)


def _inv2x2(a):
    """Inverse over the trailing (2, 2) dims, as the JAX package writes
    it: the adjugate times conj(det)/|det|²."""
    a00, a01 = a[..., 0, 0], a[..., 0, 1]
    a10, a11 = a[..., 1, 0], a[..., 1, 1]
    det = a00 * a11 - a01 * a10
    inv_det = det.conj() / (det.real * det.real + det.imag * det.imag)
    return torch.stack([torch.stack([a11, -a01], -1),
                        torch.stack([-a10, a00], -1)], -2) * inv_det[..., None, None]


def correct_vis(time_bin_indices, time_bin_counts, antenna1, antenna2,
                jones, vis, flag):
    """Remove direction-independent gains: V_corrected = G_p⁻¹ V (G_qᴴ)⁻¹.
    Flagged (row, chan) cells are zeroed (reference correct_vis.py:111)."""
    mode = check_type(jones, vis)
    _validate_corrs(vis, jones)
    if jones.shape[3] > 1:
        raise ValueError(
            "cannot correct with direction-dependent jones (n_dir > 1)"
        )
    gp, gq = _row_gains(time_bin_indices, antenna1, antenna2, jones)
    gp, gq = gp[:, :, 0], gq[:, :, 0]  # single direction

    if mode == DIAG_DIAG:
        denom = gp * gq.conj()
    elif mode == DIAG:
        denom = gp[..., :, None] * gq.conj()[..., None, :]
    if mode != FULL:
        inv = 1.0 / (denom.real * denom.real + denom.imag * denom.imag)
        out = vis * (denom.conj() * inv)
    else:
        out = j2.mul2x2(_inv2x2(gp), j2.mul2x2(vis, _inv2x2(j2.hermitian(gq))))
    flag = torch.as_tensor(flag, device=vis.device)
    return torch.where(_keep(flag, out.ndim), out, torch.zeros_like(out))


def residual_vis(time_bin_indices, time_bin_counts, antenna1, antenna2,
                 jones, vis, flag, model):
    """Residual V − Σ_s G_p,s M_s G_q,sᴴ; flagged cells are zeroed
    (reference residual_vis.py:63, :108)."""
    out = vis - corrupt_vis(time_bin_indices, time_bin_counts, antenna1,
                            antenna2, jones, model)
    flag = torch.as_tensor(flag, device=vis.device)
    return torch.where(_keep(flag, out.ndim), out, torch.zeros_like(out))


def compute_and_corrupt_vis(time_bin_indices, time_bin_counts, antenna1,
                            antenna2, jones, model, uvw, freq, lm):
    """Predict from time-variable point-source models and corrupt with
    time-variable gains in one call (reference
    ``compute_and_corrupt_vis.py:76``).

    jones : (utime, ant, chan, dir, corr…) complex gains
    model : (utime, chan, dir, corr…) complex model coherencies
    uvw : (row, 3) metres; freq : (chan,) Hz; lm : (utime, dir, 2)

    Returns (row, chan, corr…) complex corrupted model visibilities.
    """
    mode = check_type(jones, model, vis_type="model")
    _validate_corrs(model, jones)
    device = jones.device
    nrow = _index(antenna1, device).shape[0]
    t = _row_time_index(time_bin_indices, nrow, device)

    l = lm[t, :, 0]  # noqa: E741  (row, dir)
    m = lm[t, :, 1]
    n = torch.sqrt(1.0 - l * l - m * m)
    dot = uvw[:, 0, None] * l + uvw[:, 1, None] * m + uvw[:, 2, None] * (n - 1.0)
    p = minus_two_pi_over_c * dot[:, None, :] * freq[None, :, None]  # (row, chan, dir)
    k = torch.complex(torch.cos(p) / n[:, None, :], torch.sin(p) / n[:, None, :])

    mrow = model[t]  # (row, chan, dir, corr…)
    k = k.reshape(k.shape + (1,) * (mrow.ndim - 3))
    gp, gq = _row_gains(time_bin_indices, antenna1, antenna2, jones)
    return _apply(mode, gp, mrow * k, gq)
