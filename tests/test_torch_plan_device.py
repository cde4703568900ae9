"""The port's plan builders hold their plans on the card unless the caller
asks for the CPU: ``device`` defaults to ``"cuda"``, and a call without a
device where there is no card raises instead of returning a CPU plan.
On a machine with a card the same call returns a plan on the current
card."""

import inspect

import numpy as np
import pytest
import torch

from africanus_tpu_torch.gridding.perleypolyhedron import pp_tile_plan
from africanus_tpu_torch.gridding.wgridder import make_plan
from africanus_tpu_torch.gridding.wgridder.core import build_plan
from africanus_tpu_torch.gridding.wgridder.imaging import WStackImaging
from africanus_tpu_torch.ops._build import plan_device
from africanus_tpu_torch.ops.cuda_gridtab import TableGridPlan
from africanus_tpu_torch.ops.cuda_wgrid import WGridPlan

_RNG = np.random.default_rng(8)
_UVW = _RNG.uniform(-300, 300, (40, 3))
_FREQ = np.array([1.0e9, 1.2e9])
_CELL = 2e-5


def _calls():
    z = np.zeros(4)
    return {
        "make_plan": (make_plan, lambda **kw: make_plan(
            _UVW, _FREQ, 16, 16, _CELL, _CELL, 1e-4, **kw).wgrid),
        "build_plan": (build_plan, lambda **kw: build_plan(
            _UVW, _FREQ, 16, 16, _CELL, _CELL, 1e-4, **kw).wgrid),
        "pp_tile_plan": (pp_tile_plan, lambda **kw: pp_tile_plan(
            _UVW, 3e8 / _FREQ, np.zeros(2, int), 32, 10.0, (0.0, 0.0), (0.0, 0.0),
            7, 63, "rotate", **kw)),
        "WGridPlan": (WGridPlan, lambda **kw: WGridPlan(
            z, z, z + 2.5, z + 2.5, z, np.ones((1, 4)), 16, 16, 1, 6, 13.8, **kw)),
        "TableGridPlan": (TableGridPlan, lambda **kw: TableGridPlan(
            z, z, z, z, z, 16, 1, 7, 63, **kw)),
        "WStackImaging": (WStackImaging, lambda **kw: WStackImaging(
            _UVW, _FREQ, 16, 16, _CELL, **kw).plan.wgrid),
    }


@pytest.mark.parametrize("name", ["make_plan", "build_plan", "pp_tile_plan",
                                  "WGridPlan", "TableGridPlan", "WStackImaging"])
def test_plan_builder_defaults_to_the_card(name):
    builder, call = _calls()[name]
    assert inspect.signature(builder).parameters["device"].default == "cuda"
    assert call(device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert call().device == plan_device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


def test_plan_device_resolves_the_card_index():
    """One name a device: "cuda" is the current card's index (the
    make_plan cache key); the CPU stays the CPU."""
    assert plan_device("cpu") == torch.device("cpu")
    assert plan_device(torch.device("cpu")) == torch.device("cpu")
    if torch.cuda.is_available():
        here = torch.device("cuda", torch.cuda.current_device())
        assert plan_device("cuda") == plan_device(f"cuda:{here.index}") == here
    else:
        for d in ("cuda", "cuda:0", torch.device("cuda")):
            with pytest.raises(RuntimeError, match="no CUDA card"):
                plan_device(d)
