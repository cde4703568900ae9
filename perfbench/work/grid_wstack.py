"""The work of one call's w-stack gridding, counted from the map
G[p, u, v] = Σ_samples wsc_p · ψ_u · ψ_v · V over each sample's W × W × W
taps (W planes, W rows, W columns), whatever computes it and in however
many blocks of planes.

- Operations: W³ taps a sample, each a complex-by-real multiply-accumulate
  (2 multiplies, 2 adds): 4·W³.
- Bytes: the samples' values read once (complex64), uvw read once a row
  (3 float32) and the frequencies once (float32); the touched planes of
  the (nu, nv) complex64 grid written once.

:func:`footprint` counts, from the samples, the planes and the cells of
the stack their windows hold: this map's planes and ``degrid_wstack``'s
cells.
"""

import torch
import torch.nn.functional as F

from perfbench import peaks

KEYS = {"rows", "chan", "wstack_samples", "wstack_support", "wstack_planes",
        "wstack_grid"}


def shape(shapes):
    """The map's sizes from an entry's problem sizes, or None where it has
    no w-stack."""
    if not KEYS <= set(shapes):
        return None
    nu, nv = shapes["wstack_grid"]
    return dict(N=shapes["wstack_samples"], R=shapes["rows"], F=shapes["chan"],
                W=shapes["wstack_support"], P=shapes["wstack_planes"], G=nu * nv)


def count(N, R, F, W, P, G):
    """(operations, bytes) of one call: ``N`` samples of ``R`` rows and
    ``F`` channels, support ``W``, ``P`` touched planes of ``G`` cells."""
    ops = 4.0 * W ** 3 * N
    nbytes = 8.0 * N + 12.0 * R + 4.0 * F + 8.0 * P * G
    return ops, nbytes


def least_seconds(**sizes):
    """(seconds, which bound) the card needs at least for one call."""
    ops, nbytes = count(**sizes)
    t_ops, t_bytes = ops / peaks.TF32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def footprint(uvw, freq, nu, nv, cell, support, w_planes):
    """(planes, cells) of a w-stack that the windows of the samples of
    ``uvw`` (rows, 3) metres × ``freq`` (chan,) Hz hold: a plane where
    some sample's w-window meets it, a cell (plane, u, v) where some
    sample's W × W × W window holds it. The stack is ``nu`` × ``nv``
    cells for an image of ``cell`` radians, its planes at ``w_planes``
    (evenly spaced, λ); a window starts at floor(x) − (W/2 − 1) along
    each axis, x = (u·ν/c·nu·cell mod nu) or (w·ν/c − w_0)/dw, and wraps
    in u and v. Computed in float64 on ``uvw``'s device, a plane at a
    time."""
    w = support
    scale = freq.to(torch.float64) / 2.99792458e8
    coords = [(uvw[:, k, None].to(torch.float64) * scale).reshape(-1) for k in range(3)]
    start = [torch.floor(torch.remainder(x * (n * cell), n)).long() - (w // 2 - 1)
             for x, n in zip(coords[:2], (nu, nv))]
    base = torch.remainder(start[0], nu) * nv + torch.remainder(start[1], nv)
    w0, dw = float(w_planes[0]), float(w_planes[1] - w_planes[0])
    p0 = torch.floor((coords[2] - w0) / dw).long() - (w // 2 - 1)
    dtype = torch.float16 if uvw.is_cuda else torch.float32
    planes = cells = 0
    for q in range(int(p0.min()), int(p0.max()) + w):
        hit = base[(p0 <= q) & (p0 > q - w)]
        if not hit.numel():
            continue
        marks = torch.zeros(nu * nv, dtype=dtype, device=uvw.device)
        marks[hit] = 1
        padded = F.pad(marks.view(1, 1, nu, nv), (w - 1, 0, w - 1, 0), mode="circular")
        planes += 1
        cells += int(torch.count_nonzero(F.max_pool2d(padded, w, stride=1)))
    return planes, cells
