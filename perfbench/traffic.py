"""The one generator of the benchmark's inputs, driven by the data in a
configuration file and a cell's ``traffic`` parameters.

Everything is drawn from ``--seed`` by one ``torch.Generator`` on the
run's device, in a few large calls: an array's antenna positions (group
by group), its uvw by Earth rotation over a track, sky models (drawn
from counts and distributions, or listed component by component), DIE
gain phases, and noise. The same seed on
the same device gives the same inputs; the sizes never depend on it.
"""

from __future__ import annotations

import math

import torch

__all__ = ["EARTH_ROTATION", "generator", "frequencies", "antennas",
           "observation", "track_start", "sky", "power_law", "uniform",
           "normal"]

EARTH_ROTATION = 7.2921159e-5  # rad / s, sidereal


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any
    integer: taken modulo 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def uniform(gen, shape, lo, hi, dtype=torch.float32):
    x = torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)
    return x * (hi - lo) + lo


def normal(gen, shape, sigma, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype) * sigma


def frequencies(cfg, device):
    """(chan,) float32 channel frequencies, evenly over the band's ends."""
    lo, hi = cfg["band_hz"]
    return torch.linspace(lo, hi, cfg["nchan"], dtype=torch.float64,
                          device=device).to(torch.float32)


def antennas(cfg, gen):
    """(ant, 3) float64 equatorial antenna positions (metres), drawn
    group by group from the configuration's ``layout``. A group has a
    ``count`` and either ``box_m`` (uniform in a square of that side) or
    ``radius_m`` [lo, hi] (log-uniform in radius, uniform in azimuth);
    heights are uniform within ±``height_m``. The counts add up to
    ``nant``."""
    groups = cfg["layout"]
    if sum(g["count"] for g in groups) != cfg["nant"]:
        raise ValueError(f"the layout's groups do not hold {cfg['nant']} antennas")
    out = []
    for g in groups:
        n = g["count"]
        if "box_m" in g:
            xy = uniform(gen, (n, 2), -g["box_m"] / 2, g["box_m"] / 2,
                         torch.float64)
        else:
            lo, hi = (math.log(r) for r in g["radius_m"])
            r = torch.exp(uniform(gen, (n,), lo, hi, torch.float64))
            az = uniform(gen, (n,), 0.0, 2 * math.pi, torch.float64)
            xy = torch.stack([r * torch.cos(az), r * torch.sin(az)], dim=1)
        z = uniform(gen, (n, 1), -cfg["height_m"], cfg["height_m"],
                    torch.float64)
        out.append(torch.cat([xy, z], dim=1))
    return torch.cat(out, dim=0)


def track_start(cfg, gen, ndumps):
    """The first dump (an int) of ``ndumps`` consecutive dumps, drawn
    uniformly within the configuration's track."""
    total = int(round(cfg["track_s"] / cfg["dump_s"]))
    if ndumps > total:
        raise ValueError(f"{ndumps} dumps do not fit a track of {total}")
    x = torch.randint(0, total - ndumps + 1, (1,), generator=gen,
                      device=gen.device)
    return int(x.item())


def observation(cfg, pos, first_dump, ndumps):
    """Every cross baseline at dumps ``first_dump ..`` of the track, rows
    time-major: a dict of ``uvw`` (row, 3) float32 metres, ``time``
    (row,) int64 dump index, ``antenna1`` and ``antenna2`` (row,) int64.
    The hour angle runs over the track centred on transit; uvw is the
    baseline rotated to the declination ``dec_deg``."""
    device = pos.device
    a1, a2 = torch.triu_indices(cfg["nant"], cfg["nant"], 1, device=device)
    dumps = torch.arange(first_dump, first_dump + ndumps, device=device)
    time = dumps.repeat_interleave(a1.numel())
    ant1, ant2 = a1.repeat(ndumps), a2.repeat(ndumps)
    lx, ly, lz = (pos[ant1] - pos[ant2]).unbind(1)
    h = EARTH_ROTATION * (time.to(torch.float64) * cfg["dump_s"]
                          - cfg["track_s"] / 2)
    dec = math.radians(cfg["dec_deg"])
    sd, cd = math.sin(dec), math.cos(dec)
    sh, ch = torch.sin(h), torch.cos(h)
    uvw = torch.stack([sh * lx + ch * ly,
                       -sd * ch * lx + sd * sh * ly + cd * lz,
                       cd * ch * lx - cd * sh * ly + sd * lz], dim=1)
    return {"uvw": uvw.to(torch.float32), "time": time, "antenna1": ant1,
            "antenna2": ant2}


def power_law(gen, n, lo, hi, slope):
    """``n`` fluxes in [lo, hi] whose counts fall as N(>S) ∝ S^−slope."""
    x = torch.rand((n,), generator=gen, device=gen.device, dtype=torch.float64)
    return lo * (1 - x * (1 - (lo / hi) ** slope)) ** (-1.0 / slope)


def sky(spec, gen, nspi=1):
    """A sky model as float32 tensors: ``lm`` (src, 2), ``stokes`` (src,
    4), ``spi`` (src, nspi, 4), ``ref_freq`` (src,), ``gauss_shape``
    (src, 3) (FWHM major, FWHM minor, position angle; radians).

    ``spec`` either lists ``components`` (each with ``lm``, ``stokes``,
    ``spi``, ``ref_freq``, ``gauss_shape``) or draws ``count`` of them:
    lm uniform within ±``lm_max``; Stokes I from counts N(>S) ∝
    S^−``count_slope`` over ``flux_jy``; linear polarisation a fraction
    uniform in [0, ``pol_frac_max``] of I at a uniform angle, V = 0, so
    that |P| ≤ I; one spectral index a component, normal about
    ``spi_mean`` with ``spi_sigma``, for all four Stokes parameters (the
    fractional polarisation holds over the band); one ``ref_freq``; a
    major axis log-uniform over ``major_rad``, the minor axis that times
    an axis ratio uniform over ``axis_ratio``, the angle uniform."""
    device = gen.device
    if "components" in spec:
        comps = spec["components"]

        def col(key):
            return torch.tensor([c[key] for c in comps], dtype=torch.float32,
                                device=device)

        return {"lm": col("lm"), "stokes": col("stokes"), "spi": col("spi"),
                "ref_freq": col("ref_freq"), "gauss_shape": col("gauss_shape")}
    n = spec["count"]
    lm = uniform(gen, (n, 2), -spec["lm_max"], spec["lm_max"])
    i = power_law(gen, n, *spec["flux_jy"], spec["count_slope"])
    p = i * uniform(gen, (n,), 0.0, spec["pol_frac_max"], torch.float64)
    chi = uniform(gen, (n,), 0.0, math.pi, torch.float64)
    stokes = torch.stack([i, p * torch.cos(2 * chi), p * torch.sin(2 * chi),
                          torch.zeros_like(i)], dim=1)
    alpha = spec["spi_mean"] + normal(gen, (n, nspi, 1), spec["spi_sigma"])
    lo, hi = (math.log(x) for x in spec["major_rad"])
    emaj = torch.exp(uniform(gen, (n,), lo, hi, torch.float64))
    emin = emaj * uniform(gen, (n,), *spec["axis_ratio"], torch.float64)
    angle = uniform(gen, (n,), 0.0, math.pi, torch.float64)
    return {
        "lm": lm,
        "stokes": stokes.to(torch.float32),
        "spi": alpha.expand(n, nspi, 4).contiguous(),
        "ref_freq": torch.full((n,), float(spec["ref_freq"]),
                               dtype=torch.float32, device=device),
        "gauss_shape": torch.stack([emaj, emin, angle], dim=1).to(torch.float32),
    }
