"""Kernel launch counts and the device's name, as the examples print them.

Every kernel wrapper of the port counts its launches in ``.launches``
(on CPU tensors the wrappers run their plain versions and count
nothing). An example snapshots the counts before its work and prints
what was launched since, so that a run which quietly took a plain route
on the card shows it.
"""

from __future__ import annotations

import torch

from africanus_tpu_torch.ops.cuda_beam import beam_blend, beam_blend_cell, beam_interp
from africanus_tpu_torch.ops.cuda_dft import dft_adjoint, dft_forward
from africanus_tpu_torch.ops.cuda_fused import fused_dde, fused_pairs
from africanus_tpu_torch.ops.cuda_grid2d import degrid_2d, grid_2d
from africanus_tpu_torch.ops.cuda_gridtab import degrid_table, grid_table
from africanus_tpu_torch.ops.cuda_hogbom import hogbom
from africanus_tpu_torch.ops.cuda_predict import predict_kb
from africanus_tpu_torch.ops.cuda_wgrid import degrid_wstack, grid_wstack

__all__ = ["WRAPPERS", "counts", "since", "describe", "device_name", "sync"]

WRAPPERS = (predict_kb, dft_forward, dft_adjoint, grid_wstack, degrid_wstack,
            grid_2d, degrid_2d, grid_table, degrid_table, beam_interp,
            beam_blend, beam_blend_cell, hogbom, fused_pairs, fused_dde)


def counts():
    """{wrapper name: launches so far}."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def since(before):
    """{wrapper name: launches since ``before``} of the wrappers that
    launched."""
    return {k: v - before[k] for k, v in counts().items() if v != before[k]}


def describe(launched):
    """One line naming each kernel launched, or saying none was."""
    if not launched:
        return "kernel launches: none"
    return "kernel launches: " + ", ".join(f"{k} {v}" for k, v in launched.items())


def device_name(device):
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
