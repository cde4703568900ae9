"""Make a dirty image with the w-stacking gridder.

Port of ``examples/make_dirty.py`` (the reference's dirty-image scripts
and the wgridder ``dirty`` pipeline): the visibilities of three point
sources are computed exactly, then imaged through
:func:`africanus_tpu_torch.gridding.wgridder.core.grid_adjoint`, whose
spread is the ``grid_wstack`` kernel on the card. Reports the recovered
source peaks.

    python -m africanus_tpu_torch.examples.make_dirty [nx] [nrow]
        [--device cuda|cpu]

The visibilities are float64 sums rounded to complex64, as in the JAX
example, so the gridder runs in float32.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from africanus_tpu_torch.constants import c as C
from africanus_tpu_torch.examples.launches import counts, describe, device_name, since, sync
from africanus_tpu_torch.gridding.wgridder.core import grid_adjoint
from africanus_tpu_torch.ops._build import plan_device

__all__ = ["NCHAN", "EPSILON", "dirty_inputs", "point_source_vis", "make_dirty",
           "main"]

NCHAN = 4
EPSILON = 1e-5


def dirty_inputs(nx=256, nrow=20000, seed=0):
    """The JAX example's observation: (uvw (nrow, 3), freq (4,), cell,
    srcs) — uvw filling the grid at the top channel, w shrunk 5×, and
    three point sources as (x pixel, y pixel, flux) offsets from the
    centre."""
    cell = 1.0 * np.pi / 180.0 / nx
    freq = 1e9 + np.arange(NCHAN) * (2e8 / NCHAN)
    rng = np.random.default_rng(seed)
    uvw = (rng.uniform(size=(nrow, 3)) - 0.5) / (cell * freq[-1] / C)
    uvw[:, 2] *= 0.2
    srcs = [(0, 0, 2.0), (nx // 5, -nx // 7, 1.0), (-nx // 3, nx // 4, 0.5)]
    return uvw, freq, cell, srcs


def point_source_vis(uvw, freq, cell, srcs, device):
    """(row, chan) complex64 visibilities of ``srcs``, summed in float64
    on ``device``: dirty(x, y) = Σ Re[V e^{+2πi(ux + vy − w(n−1))}], so a
    source at +x needs V = e^{−iφ}."""
    f64 = torch.float64
    uvw = torch.as_tensor(uvw, dtype=f64, device=device)
    scale = torch.as_tensor(freq, dtype=f64, device=device) / C
    x = torch.tensor([s[0] * cell for s in srcs], dtype=f64, device=device)
    y = torch.tensor([s[1] * cell for s in srcs], dtype=f64, device=device)
    amp = torch.tensor([s[2] for s in srcs], dtype=f64, device=device)
    n = torch.sqrt(1.0 - x**2 - y**2)
    u, v, w = (uvw[:, i, None, None] * scale[None, :, None] for i in range(3))
    ph = -2.0 * np.pi * (u * x + v * y - w * (n - 1.0))
    return torch.complex((amp * torch.cos(ph)).sum(-1).float(),
                         (amp * torch.sin(ph)).sum(-1).float())


def make_dirty(uvw, freq, vis, nx, cell, epsilon=EPSILON):
    """The (nx, nx) dirty image of ``vis`` (row, chan) complex on its
    device, w-stacking on; ``uvw`` and ``freq`` are host arrays (the
    plan reads them there)."""
    return grid_adjoint(uvw, freq, vis, None, nx, nx, cell, cell, epsilon, True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("nx", nargs="?", type=int, default=256)
    p.add_argument("nrow", nargs="?", type=int, default=20000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = plan_device(args.device)
    nx = args.nx
    uvw, freq, cell, srcs = dirty_inputs(nx, args.nrow)
    vis = point_source_vis(uvw, freq, cell, srcs, device)
    before = counts()
    t0 = time.perf_counter()
    dirty = make_dirty(uvw, freq, vis, nx, cell)
    sync(device)
    dt = time.perf_counter() - t0
    dirty = dirty.cpu().numpy()

    nvis = args.nrow * NCHAN
    print(f"device: {device_name(device)} (float32); {describe(since(before))}")
    print(f"dirty {dirty.shape} from {nvis} vis in {dt:.2f}s (incl. plan)")
    for (px, py, a) in srcs:
        val = dirty[nx // 2 + px, nx // 2 + py] / nvis
        print(f"  source at ({px:+4d},{py:+4d}): true {a:.2f}, "
              f"recovered {val:.3f}")
    peak = np.unravel_index(np.argmax(dirty), dirty.shape)
    print(f"peak at {peak} (expect ({nx // 2}, {nx // 2}))")


if __name__ == "__main__":
    main()
