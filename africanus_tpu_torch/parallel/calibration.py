"""Sharded calibration: residual application and phase-only solving.

Port of ``africanus_tpu/parallel/calibration.py``. The reference
parallelises calibration with dask over row chunks cut on unique-time
boundaries (``chunkify_rows``; calibration/utils/dask.py and
phase_only/dask.py) — the per-chunk solves are independent because
gains are per (time, antenna) and every row of a time bin lives in one
chunk. The port keeps that decomposition: time bins are split into one
group per device of the mesh, each device runs the port's Gauss-Newton
solve on its own rows, and the per-bin gains concatenate back on the
host. :func:`sharded_residual_vis` is the row-parallel residual on
bin-aligned shards.
"""

from __future__ import annotations

import numpy as np
import torch

from africanus_tpu_torch.calibration.phase_only import gauss_newton
from africanus_tpu_torch.calibration.utils import residual_vis
from africanus_tpu_torch.parallel.mesh import rows_on, shard_slice, to_host

__all__ = ["sharded_residual_vis", "sharded_gauss_newton"]


def _bin_shards(time_bin_indices, time_bin_counts, nshard):
    """Split time bins into ``nshard`` contiguous groups with equal bin
    counts (rows per group may differ; bins must divide evenly)."""
    tbi = np.asarray(time_bin_indices)
    tbc = np.asarray(time_bin_counts)
    nbins = tbi.shape[0]
    if nbins % nshard:
        raise ValueError(f"{nbins} time bins must divide over {nshard} "
                         f"shards")
    per = nbins // nshard
    groups = []
    for s in range(nshard):
        bins = shard_slice(s, per)
        row0 = int(tbi[bins.start])
        row1 = int(tbi[bins.stop - 1] + tbc[bins.stop - 1])
        groups.append((bins, row0, row1))
    return groups


def sharded_residual_vis(mesh, time_bin_indices, time_bin_counts,
                         antenna1, antenna2, jones, vis, flag, model):
    """residual_vis with rows sharded over the mesh "row" axis.

    Shards are cut on time-bin boundaries (each shard carries whole
    bins, like the reference's chunkify_rows contract) and must carry
    equal row counts; the gains' time axis shards alongside. Returns the
    residual on the mesh's first device.
    """
    tbi, tbc = to_host(time_bin_indices), to_host(time_bin_counts)
    a1, a2 = to_host(antenna1), to_host(antenna2)
    devices = mesh.axis_devices("row")
    groups = _bin_shards(tbi, tbc, len(devices))
    rows_per = {r1 - r0 for _, r0, r1 in groups}
    if len(rows_per) != 1:
        raise ValueError("bin groups must carry equal row counts "
                         f"(got {sorted(rows_per)}); pad the time axis")
    parts = []
    for d, (bins, r0, r1) in zip(devices, groups):
        rows = slice(r0, r1)
        parts.append(residual_vis(
            tbi[bins] - r0, tbc[bins], a1[rows], a2[rows],
            rows_on(jones, bins, d), rows_on(vis, rows, d), rows_on(flag, rows, d),
            rows_on(model, rows, d)).to(mesh.first))
    return torch.cat(parts)


def sharded_gauss_newton(mesh, time_bin_indices, time_bin_counts,
                         antenna1, antenna2, jones, vis, flag, model,
                         weight, tol=1e-4, maxiter=100):
    """Phase-only Gauss-Newton solve parallelised over time-bin groups.

    Gains are per (time, antenna): bins are independent, so each device
    of the mesh solves its own bin group (the reference's dask
    time-chunk decomposition, phase_only/dask.py) with the port's
    :func:`~africanus_tpu_torch.calibration.phase_only.gauss_newton`.
    Returns (jones, jhj, jhr, the largest iteration count over groups):
    the groups' results concatenated on the host (CPU tensors).
    """
    tbi, tbc = to_host(time_bin_indices), to_host(time_bin_counts)
    a1, a2 = to_host(antenna1), to_host(antenna2)
    devices = list(mesh.devices.ravel())
    groups = _bin_shards(tbi, tbc, len(devices))

    parts = []
    for d, (bins, r0, r1) in zip(devices, groups):
        rows = slice(r0, r1)
        parts.append(gauss_newton(
            tbi[bins] - r0, tbc[bins], a1[rows], a2[rows],
            rows_on(jones, bins, d), rows_on(vis, rows, d), rows_on(flag, rows, d),
            rows_on(model, rows, d), rows_on(weight, rows, d), tol=tol,
            maxiter=maxiter))
    gains, jhj, jhr = (torch.cat([p[i].cpu() for p in parts]) for i in range(3))
    iters = max(int(p[3]) for p in parts)
    return gains, jhj, jhr, iters
