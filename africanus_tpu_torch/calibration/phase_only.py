"""Phase-only Gauss-Newton gain calibration.

Port of ``africanus_tpu/calibration/phase_only.py`` (reference
``africanus/calibration/phase_only/phase_only.py``: gauss_newton:243,
compute_jhj:110, compute_jhr:168, compute_jhj_and_jhr:30) on complex
tensors. DIAG_DIAG mode: the Jacobian of V_pq = g_p m g_q* with respect
to the phase of g_p is i·g_p·m·g_q*, so JᴴJ is |g_p m g_q*|² and
JᴴR = ∓i·conj(g_p m g_q*)·R.

The per-(time, antenna) sums of the normal equations are a gather, not
a scatter: the host plans, from the time-bin and antenna metadata, a
padded table of every bin's contributing baseline sides
(:func:`ant_gather_table`, a numpy copy of the JAX package's
``_bin_gather_table``), and each sum gathers its bin's row and adds it
up in a fixed order. ``index_add_`` on CUDA floats would sum with
atomics in an order that changes from run to run; the gather is
deterministic, and it is what the JAX package runs.

The JAX package's ``lax.while_loop`` becomes a Python loop of masked
iterations (see :func:`gauss_newton`).
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.calibration.utils import (
    DIAG_DIAG, _index, _keep, _row_time_index, check_type,
)

__all__ = ["ant_gather_table", "compute_jhj", "compute_jhr",
           "compute_jhj_and_jhr", "gauss_newton"]


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bin_gather_table(row_map, out_rows):
    """Host inverse of a row map: (out_rows, R) input-row indices and
    validity mask, R the largest bin (copy of
    ``averaging/time_and_channel_avg.py:_bin_gather_table_impl``)."""
    nrow = row_map.shape[0]
    order = np.argsort(row_map, kind="stable")
    counts = np.bincount(row_map, minlength=out_rows)
    r = max(int(counts.max()), 1) if nrow else 1
    starts = np.zeros(out_rows, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slot = np.arange(nrow) - starts[row_map[order]]
    row_sel = np.zeros((out_rows, r), np.int32)
    row_valid = np.zeros((out_rows, r), bool)
    row_sel[row_map[order], slot] = order
    row_valid[row_map[order], slot] = True
    return row_sel, row_valid


def ant_gather_table(time_bin_indices, time_bin_counts, antenna1, antenna2,
                     ntime, nant, device=None):
    """Per (time, ant) bin, the padded list of contributing baseline
    sides (side p = row, side q = row + nrow), planned on the host.

    Returns (sel, valid): (ntime·nant, R) int64 and bool tensors on
    ``device``. Metadata on the card is copied to the host (a sync):
    callers that solve repeatedly plan once and pass the table.
    """
    tbi = _numpy(time_bin_indices)
    tbc = _numpy(time_bin_counts)
    a1 = _numpy(antenna1).astype(np.int64)
    a2 = _numpy(antenna2).astype(np.int64)
    nrow = a1.shape[0]
    # chunked callers pass absolute row offsets: rebaseline like the
    # reference (phase_only.py:137)
    if tbi.size:
        tbi = tbi - tbi.min()
    t_row = np.zeros(nrow, np.int64)
    for ti, (s, c) in enumerate(zip(tbi, tbc)):
        t_row[int(s) : int(s) + int(c)] = ti
    bins = np.concatenate([t_row * nant + a1, t_row * nant + a2])
    sel, valid = _bin_gather_table(bins, ntime * nant)
    return (torch.as_tensor(sel.astype(np.int64), device=device),
            torch.as_tensor(valid, device=device))


def _bin_sum(table, contrib_p, contrib_q, out_shape):
    """Sum per-(time, ant) bins of the stacked side contributions, in
    the table's fixed slot order."""
    sel, valid = table
    x = torch.cat([contrib_p, contrib_q], dim=0)[sel]  # (bins, R, …)
    mask = valid.reshape(valid.shape + (1,) * (x.ndim - 2))
    return torch.where(mask, x, torch.zeros_like(x)).sum(dim=1).reshape(out_shape)


def _unflagged(flag, like):
    """(row, chan, 1, 1) mask of unflagged cells, in ``like``'s real dtype."""
    flag = torch.as_tensor(flag, device=like.device)
    return _keep(flag, 4).to(like.real.dtype)


def _jacobian(jones, time_bin_indices, antenna1, antenna2, model, flag):
    """g_p·m·conj(g_q) per row, zero at flagged cells."""
    a1 = _index(antenna1, jones.device)
    a2 = _index(antenna2, jones.device)
    t = _row_time_index(time_bin_indices, a1.shape[0], jones.device)
    jac = jones[t, a1] * model * jones[t, a2].conj()
    return jac * _unflagged(flag, jac)


def _table(table, time_bin_indices, time_bin_counts, antenna1, antenna2,
           jones):
    if table is not None:
        return table
    return ant_gather_table(time_bin_indices, time_bin_counts, antenna1,
                            antenna2, jones.shape[0], jones.shape[1],
                            jones.device)


def compute_jhj(time_bin_indices, time_bin_counts, antenna1, antenna2,
                jones, model, flag, table=None):
    """Diagonal of JᴴJ per (time, ant, chan, dir, corr): a real tensor
    (reference phase_only.py:110). ``table``: an
    :func:`ant_gather_table` already planned for this metadata."""
    if check_type(jones, model, vis_type="model") != DIAG_DIAG:
        # the reference zeroes the jacobian outside DIAG_DIAG
        return torch.zeros(jones.shape, dtype=jones.real.dtype,
                           device=jones.device)
    table = _table(table, time_bin_indices, time_bin_counts, antenna1,
                   antenna2, jones)
    jac = _jacobian(jones, time_bin_indices, antenna1, antenna2, model, flag)
    jac2 = jac.real * jac.real + jac.imag * jac.imag  # |i·jac|² == |jac|²
    return _bin_sum(table, jac2, jac2, jones.shape)


def compute_jhr(time_bin_indices, time_bin_counts, antenna1, antenna2,
                jones, residual, model, flag, table=None):
    """JᴴR per (time, ant, chan, dir, corr): a complex tensor
    (reference phase_only.py:168)."""
    if check_type(jones, model, vis_type="model") != DIAG_DIAG:
        return torch.zeros_like(jones)
    table = _table(table, time_bin_indices, time_bin_counts, antenna1,
                   antenna2, jones)
    jac = _jacobian(jones, time_bin_indices, antenna1, antenna2, model, flag)
    cjr = jac.conj() * residual[:, :, None, :]  # broadcast over dir
    # p-antenna: conj(i·jac)·r = −i·cjr ; q-antenna: conj(−i·jac)·r = +i·cjr
    jre = _bin_sum(table, cjr.imag, -cjr.imag, jones.shape)
    jim = _bin_sum(table, -cjr.real, cjr.real, jones.shape)
    return torch.complex(jre, jim)


def compute_jhj_and_jhr(time_bin_indices, time_bin_counts, antenna1,
                        antenna2, jones, residual, model, flag, table=None):
    """Gauss-Newton normal-equation terms of the phase-only solver:
    (jhj, jhr), both (utime, ant, chan, dir, corr), real and complex
    (reference ``phase_only/phase_only.py:30``; DIAG_DIAG only)."""
    if check_type(jones, residual) != DIAG_DIAG:
        raise NotImplementedError("only the DIAG_DIAG mode is implemented (reference parity)")
    table = _table(table, time_bin_indices, time_bin_counts, antenna1,
                   antenna2, jones)
    jhj = compute_jhj(time_bin_indices, time_bin_counts, antenna1, antenna2,
                      jones, model, flag, table)
    jhr = compute_jhr(time_bin_indices, time_bin_counts, antenna1, antenna2,
                      jones, residual, model, flag, table)
    return jhj, jhr


def gauss_newton(time_bin_indices, time_bin_counts, antenna1, antenna2,
                 jones, vis, flag, model, weight, tol=1e-4, maxiter=100,
                 table=None):
    """Phase-only Gauss-Newton solve (reference phase_only.py:243-308).

    jones : (time, ant, chan, dir, corr) complex starting gains
    vis : (row, chan, corr) complex data; model : (row, chan, dir, corr)
    flag : (row, chan, corr); weight : (row, chan, corr) real
    table : an :func:`ant_gather_table` planned for this metadata, or
        None to plan one here (a host sync when the metadata is on the card)

    The JAX package's ``while (eps > tol) & (k < maxiter)`` becomes
    ``maxiter`` masked iterations: once an iteration's largest update is
    ≤ ``tol``, later iterations change nothing. With ``tol <= 0`` the
    loop never waits for the device; with ``tol > 0`` it reads the test
    on the host once per iteration (a sync) to stop early.

    Returns (jones, jhj, jhr, iterations) — iterations a 0-d int64
    tensor.
    """
    if check_type(jones, vis) != DIAG_DIAG:
        raise NotImplementedError("only DIAG_DIAG mode is implemented (reference parity)")
    device = jones.device
    weight = torch.as_tensor(weight, device=device)
    sqrtw = torch.sqrt(weight)
    v = vis * sqrtw
    m = model * sqrtw[:, :, None]

    table = _table(table, time_bin_indices, time_bin_counts, antenna1,
                   antenna2, jones)
    # JᴴJ is phase-independent in DIAG_DIAG mode (|g| = 1): once
    jhj = compute_jhj(time_bin_indices, time_bin_counts, antenna1, antenna2,
                      jones, m, flag, table)
    safe = torch.where(jhj == 0.0, torch.ones_like(jhj), jhj)

    a1 = _index(antenna1, device)
    a2 = _index(antenna2, device)
    t = _row_time_index(time_bin_indices, a1.shape[0], device)
    # flags ride the model: a masked jac is zero at flagged cells, so
    # conj(jac)·r vanishes there whatever r is
    mk = m * _unflagged(flag, m)

    phases = torch.atan2(jones.imag, jones.real)
    jhr = torch.zeros_like(jones)
    k = torch.zeros((), dtype=torch.int64, device=device)
    running = torch.ones((), dtype=torch.bool, device=device)
    for _ in range(maxiter):
        g = torch.polar(torch.ones_like(phases), phases)
        jac = g[t, a1] * mk * g[t, a2].conj()  # (row, chan, dir, corr)
        r = v - jac.sum(dim=2)
        cjr = jac.conj() * r[:, :, None, :]
        # p-antenna: conj(i·jac)·r = −i·cjr ; q-antenna: +i·cjr
        new_jhr = torch.complex(_bin_sum(table, cjr.imag, -cjr.imag, jones.shape),
                                _bin_sum(table, -cjr.real, cjr.real, jones.shape))
        # 0.5·Re(JHR/JHJ) phase update (reference :301); zero JHJ guarded
        update = 0.5 * torch.where(jhj == 0.0, torch.zeros_like(jhj),
                                   new_jhr.real / safe)
        phases = torch.where(running, phases + update, phases)
        jhr = torch.where(running, new_jhr, jhr)
        k = k + running.to(torch.int64)
        running = running & (update.abs().amax() > tol)
        if tol > 0 and not bool(running):
            break
    return torch.polar(torch.ones_like(phases), phases), jhj, jhr, k
