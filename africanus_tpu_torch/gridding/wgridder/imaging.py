"""w-stacked imaging at fixed geometry: the dirty image and the model
visibilities of every major cycle, on one plan.

Twin of the JAX package's ``bench.py`` config 4 (``config4_imaging``,
:879-1013 — its BDA leg is not part of this module): a dirty image
(``grid_adjoint``) and a degrid (``degrid_ri``) on one plan made once.

:func:`imaging_inputs` makes the bench's seeded numpy data, same draws;
:func:`from_numpy` builds the module; :func:`dirty_oracle_f64` is the
bench's explicit w-aware DFT (the reference's own oracle,
``gridding/wgridder/tests/test_wgridder.py``), in float64.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from africanus_tpu_torch.constants import c as lightspeed
from africanus_tpu_torch.gridding.wgridder.core import _degrid, _grid, build_plan

__all__ = ["WStackImaging", "imaging_inputs", "from_numpy", "dirty_oracle_f64"]

# the bench's field of view (1 degree) and accuracy check shape
# (bench.py:892, :985-990): 400 samples, 32² image, 4x cells, 2 channels
_FOV = np.pi / 180
_CHECK_ROWS, _CHECK_NX, _CHECK_CELL_FACTOR, _CHECK_CHANS = 400, 32, 4, 2


class WStackImaging(nn.Module):
    """Dirty images and model visibilities at fixed uvw and frequencies.

    Builds its own
    :class:`~africanus_tpu_torch.gridding.wgridder.core.ImagingPlan`
    (``self.plan``, float32; ``.to()`` moves it) in ``__init__``, on
    ``device``: the card unless the caller asks for ``"cpu"`` (raises
    where there is no card).
    :meth:`forward` grids (row, chan) complex64 visibilities into the
    (nx, ny) dirty image; :meth:`degrid` predicts (row, chan) complex64
    visibilities of an (nx, ny) image. On the card both run the kernels
    of ``csrc/wgrid.cu``, in blocks of planes where the stack does not fit
    (as ``core.grid_adjoint`` and ``core.degrid``).
    """

    def __init__(self, uvw, freq, nx, ny, cellx, celly=None, epsilon=1e-4,
                 do_wstacking=True, device="cuda"):
        super().__init__()
        celly = cellx if celly is None else celly
        self.nrow, self.nchan = len(uvw), len(freq)
        self.plan = build_plan(uvw, freq, nx, ny, cellx, celly, epsilon,
                               do_wstacking, device=device)

    def forward(self, vis):
        v = vis.reshape(-1).to(self.plan.complex_dtype).contiguous()
        return _grid(self.plan, v)

    def degrid(self, image):
        return _degrid(self.plan, image).reshape(self.nrow, self.nchan)


def imaging_inputs(nrow, nchan, nx, seed, w_div=20):
    """Seeded numpy inputs, equal to ``bench.py:888-904`` with
    ``default_rng(seed)`` (config 4 is nrow 100_000, nchan 8, nx 512,
    seed 4): uvw uniform in ±(umax, umax, umax/w_div) metres with umax
    at 0.9 of the grid's Nyquist extent at the top frequency, and
    unit-normal complex visibilities; then, from the same generator, the
    bench's accuracy problem (:985-990).

    Returns a dict: uvw (nrow, 3) and freq (nchan,) float32, vis (nrow,
    nchan) complex64, cell (rad), nx, image (nx, nx) float32 (from
    ``default_rng(seed + 1)``, the bench's degrid image) and "check",
    the accuracy problem: uvw (400, 3) float64, freq (2,) float64, vis
    (400, 2) complex128, nx 32, cell.
    """
    rng = np.random.default_rng(seed)
    cell = _FOV / nx
    freq = np.linspace(0.856e9, 1.712e9, nchan)
    umax = 0.9 / (2 * cell * freq[-1] / lightspeed)
    uvw = rng.uniform(-1, 1, (nrow, 3)) * np.array([umax, umax, umax / w_div])
    vis = (rng.normal(size=(nrow, nchan))
           + 1j * rng.normal(size=(nrow, nchan)))
    cells = cell * _CHECK_CELL_FACTOR
    uvw_s = ((rng.uniform(size=(_CHECK_ROWS, 3)) - 0.5)
             / (cells * freq[-1] / lightspeed))
    image = np.random.default_rng(seed + 1).normal(size=(nx, nx))
    return {
        "uvw": uvw.astype(np.float32),
        "freq": freq.astype(np.float32),
        "vis": vis.astype(np.complex64),
        "cell": cell,
        "nx": nx,
        "image": image.astype(np.float32),
        "check": {"uvw": uvw_s, "freq": freq[:_CHECK_CHANS],
                  "vis": vis[:_CHECK_ROWS, :_CHECK_CHANS], "nx": _CHECK_NX,
                  "cell": cells},
    }


def from_numpy(args, device, do_wstacking=True):
    """Carry an :func:`imaging_inputs` problem over to the port: returns
    ``(module, vis, image)``, the :class:`WStackImaging` on ``device``
    (ε = 1e-4 as the bench; its plan built from the float32 uvw and
    frequencies, as the bench plans) and the complex64 visibilities and
    float32 image it takes."""
    nx = args["nx"]
    module = WStackImaging(args["uvw"], args["freq"], nx, nx, args["cell"],
                           do_wstacking=do_wstacking, device=device)
    return (module, torch.as_tensor(args["vis"]).to(device),
            torch.as_tensor(args["image"]).to(device))


def dirty_oracle_f64(uvw, freq, vis, nx, cell):
    """The explicit w-aware DFT dirty image (nx, nx) in float64
    (``bench.py:995-1007``): Σ Re(V·e^{2πi·(ν/c)(u·x + v·y − w·(n−1))})/n
    over rows and channels. O(row·chan·nx²)."""
    uvw = np.asarray(uvw, np.float64)
    vis = np.asarray(vis)
    x, y = np.meshgrid(*[-nx / 2 + np.arange(nx)] * 2, indexing="ij")
    x, y = x * cell, y * cell
    eps2 = x**2 + y**2
    nm1 = -eps2 / (np.sqrt(1.0 - eps2) + 1.0)
    ref = np.zeros((nx, nx))
    for c in range(len(freq)):
        ph = (freq[c] / lightspeed) * (
            x[None] * uvw[:, 0, None, None]
            + y[None] * uvw[:, 1, None, None]
            - uvw[:, 2, None, None] * nm1[None]
        )
        ref += (vis[:, c, None, None] * np.exp(2j * np.pi * ph)).real.sum(0)
    return ref / (nm1 + 1)
