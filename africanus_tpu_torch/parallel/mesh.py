"""Device mesh construction and sharding helpers.

Port of ``africanus_tpu/parallel/mesh.py``. The JAX package's sharded
functions are single-controller: the caller passes whole arrays and
gets whole results, and ``shard_map`` splits the work over a
``jax.sharding.Mesh``. The port keeps that API with one process driving
a :class:`Mesh` of ``torch.device`` s: a ``sharded_*`` function splits
its operands along the mesh axes, runs the port's single-device
function on each shard on that shard's device, and reduces (the JAX
``psum``) by summing the shard partials in shard order on the mesh's
first device — a fixed order, so reruns are bitwise equal. No
``torch.distributed``: ranks would change every signature, and the
target is one card.

A device may appear more than once: ``devices=[cpu] * 8`` is the
counterpart of the JAX tests' 8 virtual CPU devices (torch has one CPU
device), and ``[cuda:0] * 8`` runs eight shards on one card, one after
another.

Axis conventions for radio-interferometry workloads:
- ``"row"``  — baselines×time rows: the data-parallel axis. Embarrassingly
  parallel for predict (the source dim is contracted locally).
- ``"chan"`` — frequency channels: also embarrassingly parallel for
  predict/averaging; the natural second axis for 2D meshes.
- Antenna-indexed arrays (gains, DDE Jones) are *replicated* — the
  reference's "antenna dimension must not be chunked" contract
  (rime/dask_predict.py:478-489).
- Source-dimension reductions under row sharding stay local; image-space
  reductions (vis_to_im, gridding) sum over "row".
"""

from __future__ import annotations

import warnings
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from africanus_tpu_torch.ops._build import plan_device

__all__ = [
    "Mesh",
    "NamedSharding",
    "make_mesh",
    "row_sharding",
    "replicated",
    "shard_rows",
    "pad_rows",
]


class Mesh:
    """An ndarray of ``torch.device`` s with named axes.

    ``devices`` is the object ndarray, ``axis_names`` the tuple of names
    and ``shape`` the ordered {name: size}, as in ``jax.sharding.Mesh``.
    """

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices, self.axis_names = devices, axis_names

    @property
    def shape(self):
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return self.devices.size

    @property
    def first(self):
        """The device that holds reductions and whole results."""
        return self.devices.flat[0]

    def axis_devices(self, name):
        """The devices along axis ``name``, the other axes at index 0:
        where shards split along only that axis run."""
        index = [0] * self.devices.ndim
        index[self.axis_names.index(name)] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, {list(self.devices.flat)})"


# a mesh and, per array dimension, the mesh axis that splits it (None:
# replicated) — jax.sharding.NamedSharding(mesh, PartitionSpec(*spec))
NamedSharding = namedtuple("NamedSharding", ["mesh", "spec"])


def make_mesh(mesh_shape=None, axis_names=("row", "chan"), devices=None,
              strict=True):
    """Build a Mesh over the available devices.

    Parameters
    ----------
    mesh_shape : optional tuple — defaults to all devices on the first axis.
    axis_names : mesh axis names (default ("row", "chan")).
    devices : optional explicit device list (names or ``torch.device`` s;
        one may repeat). None means every CUDA card, and raises where
        there is none: nothing falls back to the CPU, which a caller asks
        for with ``devices=["cpu"] * n``.
    strict : if True (the default), raise when ``mesh_shape`` needs more
        devices than are available — sharded pipelines should not
        silently run under-parallelised. ``strict=False`` (for smoke
        tests / dryruns) degrades to the largest factorisation that
        fits, preserving the requested per-axis proportions as closely
        as possible, with a warning.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: there is no CUDA card (torch.cuda.is_available() "
                "is False); pass devices=[\"cpu\"] * n for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [plan_device(d) for d in devices]
    if mesh_shape is None:
        mesh_shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(s) for s in mesh_shape)
    n = int(np.prod(mesh_shape))
    if n > len(devices):
        if strict:
            raise ValueError(
                f"mesh {mesh_shape} needs {n} devices, have {len(devices)}"
            )
        mesh_shape = _best_fitting_shape(mesh_shape, len(devices))
        n = int(np.prod(mesh_shape))
        warnings.warn(
            f"requested mesh needs more devices than the {len(devices)} "
            f"available; degraded to {mesh_shape}",
            stacklevel=2,
        )
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices[:n]
    return Mesh(dev_array.reshape(mesh_shape), axis_names)


def _best_fitting_shape(requested, ndev):
    """Largest-product mesh shape fitting ``ndev`` devices, closest in
    log-space to the requested per-axis proportions (e.g. (2, 4) on 4
    devices becomes (2, 2), not (2, 1))."""
    naxes = len(requested)

    best = None

    def rec(axis, shape, remaining):
        nonlocal best
        if axis == naxes:
            cand = tuple(shape)
            size = int(np.prod(cand))
            skew = sum(
                (np.log(c) - np.log(r)) ** 2
                for c, r in zip(cand, requested)
            )
            # ties in size/skew prefer larger leading axes (row-major)
            key = (size, -skew, cand)
            if best is None or key > best[0]:
                best = (key, cand)
            return
        d = 1
        while d <= remaining and d <= requested[axis]:
            shape.append(d)
            rec(axis + 1, shape, remaining // d)
            shape.pop()
            d += 1
        return

    rec(0, [], ndev)
    return best[1]


def row_sharding(mesh, ndim, row_axis=0, chan_axis=None):
    """NamedSharding placing ``row_axis`` on the mesh "row" axis (and
    optionally ``chan_axis`` on "chan"), all other dims replicated."""
    spec = [None] * ndim
    spec[row_axis] = "row"
    if chan_axis is not None and "chan" in mesh.axis_names:
        spec[chan_axis] = "chan"
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh):
    """Fully-replicated NamedSharding over ``mesh``.

    The reference requires antenna-indexed arrays to be unchunked
    (``rime/dask_predict.py:478-489``); the mesh analogue is full
    replication, so gather-by-antenna stays local to every device.
    """
    return NamedSharding(mesh, ())


def pad_rows(n_rows, n_shards):
    """Number of zero rows to append so ``n_rows`` divides evenly over
    ``n_shards`` (the shards are equal; padded rows carry zero
    visibilities/weights so reductions are unaffected).

    Returns
    -------
    int in [0, n_shards).
    """
    return (-n_rows) % n_shards


def check_rows(nrow, nshard, what="rows"):
    """Raise unless ``nrow`` divides over ``nshard`` shards; return the
    rows a shard."""
    if nrow % nshard:
        raise ValueError(f"{what} {nrow} must divide over {nshard} shards "
                         f"(pad with zero-weight rows: pad_rows)")
    return nrow // nshard


def to_host(x):
    """``x`` (numpy array or tensor) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(x):
    """``x`` as a tensor: a tensor stays where it is, an array becomes a
    CPU tensor of its dtype."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def shard_slice(s, per):
    """The rows of shard ``s`` when each shard holds ``per`` rows."""
    return slice(s * per, (s + 1) * per)


def rows_on(x, index, device, keep_host=False):
    """``x[index]`` (``x`` a numpy array, a tensor or a tuple of them) as
    tensors on ``device``; None stays None. With ``keep_host`` a numpy
    array's rows stay a host array (for callers that plan on the host)."""
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return type(x)(rows_on(v, index, device, keep_host) for v in x)
    if keep_host and not isinstance(x, torch.Tensor):
        return np.asarray(x)[index]
    return as_tensor(x[index]).to(device)


def split(x, n, device_of, axis=0):
    """The ``n`` equal pieces of ``x`` (numpy array or tensor) along
    ``axis``, piece ``s`` as a tensor on ``device_of(s)``."""
    per = x.shape[axis] // n
    pieces = []
    for s in range(n):
        index = [slice(None)] * x.ndim
        index[axis] = shard_slice(s, per)
        pieces.append(rows_on(x, tuple(index), device_of(s)))
    return pieces


def shard_rows(mesh, *arrays, row_axis=0):
    """Each array's row shards: a list, shard ``s`` a tensor on the
    ``s``-th device of the mesh's "row" axis. Rows must divide over the
    axis (:func:`pad_rows`)."""
    devices = mesh.axis_devices("row")
    out = []
    for a in arrays:
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a)
        check_rows(a.shape[row_axis], len(devices))
        out.append(split(a, len(devices), devices.__getitem__, row_axis))
    return tuple(out)
