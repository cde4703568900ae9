"""The traffic generator repeats by seed, and its sizes never depend on
the seed."""

import math

import pytest
import torch

from perfbench import traffic as tr
from perfbench import run as bench

SEED = 2 ** 31 + 77


def draw(name, seed):
    cell, cfg = bench.cell_spec(name)
    cfg = dict(cfg, nant=7, layout=[{"count": 7, "box_m": 5657.0}])
    gen = tr.generator(seed, "cpu")
    pos = tr.antennas(cfg, gen)
    obs = tr.observation(cfg, pos, tr.track_start(cfg, gen, 3), 3)
    sky = tr.sky(cell["traffic"]["sky"], gen)
    return [pos, *obs.values(), *sky.values()]


def entry_inputs(name, seed, small):
    """Every input tensor a cell's set-up draws, at a small size."""
    cell, cfg = bench.cell_spec(name, small[bench.cell_spec(name)[0]["entry"]])
    e = bench.load_module("entries", cell["entry"]).setup(
        cfg, cell["traffic"], seed, "cpu")
    if cell["entry"] == "flagship":
        return [*e.sky.values()] + [x for c in e.chunks for x in c.values()]
    return [e.lm, e.image, e.model, *e.draws, *e.obs.values()]


def test_same_seed_same_inputs(small):
    for name in ("meerkat64.gauss100", "skamid.selfcal_px64", "meerkat64.cal1"):
        a, b = entry_inputs(name, SEED, small), entry_inputs(name, SEED, small)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        c = entry_inputs(name, SEED + 1, small)
        assert [x.shape for x in a] == [x.shape for x in c]


def test_other_seed_other_values_same_sizes():
    a, b = draw("meerkat64.gauss100", SEED), draw("meerkat64.gauss100", SEED + 1)
    assert [x.shape for x in a] == [x.shape for x in b]
    assert not torch.equal(a[0], b[0])


def test_observation_geometry():
    _, cfg = bench.cell_spec("meerkat64.gauss100")
    cfg = dict(cfg, nant=5, layout=[{"count": 5, "box_m": 5657.0}])
    pos = tr.antennas(cfg, tr.generator(1, "cpu"))
    obs = tr.observation(cfg, pos, 100, 2)
    assert obs["uvw"].shape == (20, 3) and obs["time"].tolist() == [100] * 10 + [101] * 10
    # Earth rotation keeps a baseline's length
    base = pos[obs["antenna1"]] - pos[obs["antenna2"]]
    assert torch.allclose(obs["uvw"].double().norm(dim=1), base.norm(dim=1),
                          rtol=1e-6)


def test_drawn_sky_is_physical():
    cell, _ = bench.cell_spec("meerkat64.gauss100")
    spec = cell["traffic"]["sky"]
    sky = tr.sky(spec, tr.generator(SEED, "cpu"))
    i, q, u, v = sky["stokes"].double().unbind(1)
    assert (i >= spec["flux_jy"][0] * (1 - 1e-6)).all()
    assert (i <= spec["flux_jy"][1] * (1 + 1e-6)).all()
    assert ((q * q + u * u).sqrt() <= spec["pol_frac_max"] * i * (1 + 1e-6)).all()
    assert (v == 0).all()
    # one index for the four Stokes parameters: |P| <= I over the band
    assert (sky["spi"] == sky["spi"][:, :, :1]).all()
    emaj, emin, angle = sky["gauss_shape"].unbind(1)
    assert (emin <= emaj).all() and (emaj >= spec["major_rad"][0] * (1 - 1e-6)).all()
    assert (angle >= 0).all() and (angle <= math.pi).all()


def test_power_law_counts():
    x = tr.power_law(tr.generator(SEED, "cpu"), 200000, 0.001, 1.0, 1.5)
    assert x.min() >= 0.001 and x.max() <= 1.0
    # N(>S) / N(>S0) = (S/S0)^-1.5, less the share above the upper end
    share = float((x > 0.01).double().mean())
    want = (10.0 ** -1.5 - 1000.0 ** -1.5) / (1 - 1000.0 ** -1.5)
    assert abs(share - want) < 0.003


def test_layout_groups():
    _, cfg = bench.cell_spec("skamid.selfcal_px64")
    pos = tr.antennas(cfg, tr.generator(SEED, "cpu"))
    assert pos.shape == (cfg["nant"], 3)
    first, rest = cfg["layout"]
    n = first["count"]
    assert (pos[:n, :2].abs() <= first["box_m"] / 2).all()
    r = pos[n:, :2].norm(dim=1)
    lo, hi = rest["radius_m"]
    assert (r >= lo * (1 - 1e-9)).all() and (r <= hi * (1 + 1e-9)).all()
    assert (pos[:, 2].abs() <= cfg["height_m"]).all()
    with pytest.raises(ValueError, match="do not hold"):
        tr.antennas(dict(cfg, nant=cfg["nant"] + 1), tr.generator(SEED, "cpu"))
