"""The port's beam DDE modules (rime/fast_beam_cubes.py, feeds.py,
transform.py, parangles.py; utils/astrometry.py, fits.py, beams.py;
testing/beam_factory.py) against the JAX package on the CPU.

- every route of beam_cube_dde / beam_cube_dde_fr, both feed types, in
  float64 against the JAX package's XLA 8-gather path (≤ 1e-12 of max),
  and in float32 against its Pallas routes in interpret mode (rtol 1e-5,
  atol 1e-6, tests/test_beam.py:230's tolerance), with the same route
  detected on the same inputs;
- the small modules (freq_grid_interp, feed_rotation, transform_sources,
  parallactic angles and astrometry, FITS beams) against their twins.
"""

import logging
import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from africanus_tpu.ops.cplx import to_numpy
from africanus_tpu.rime.fast_beam_cubes import (
    beam_cube_dde_fr_ri, beam_cube_dde_ri, freq_grid_interp as jax_freq_grid_interp,
)
from africanus_tpu.rime.feeds import feed_rotation as jax_feed_rotation
from africanus_tpu.rime.parangles import parallactic_angles as jax_parangles
from africanus_tpu.rime.transform import transform_sources as jax_transform
from africanus_tpu.testing.beam_factory import beam_factory as jax_beam_factory
from africanus_tpu.utils import astrometry as jax_astrometry
from africanus_tpu.utils.beams import load_beam_cube as jax_load_beam_cube
from africanus_tpu_torch.rime import (
    beam_cube_dde, beam_cube_dde_fr, feed_rotation, freq_grid_interp,
    parallactic_angles, transform_sources,
)
from africanus_tpu_torch.testing import beam_factory
from africanus_tpu_torch.utils import astrometry
from africanus_tpu_torch.utils.beams import beam_filenames, load_beam_cube
from africanus_tpu_torch.utils.fits import read_fits, write_fits

TOL32 = dict(rtol=1e-5, atol=1e-6)
MJD0_SEC = 58849.0 * 86400.0  # ~2020-01-01 00:00 UTC


def _t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ problems

def _problem(kind, seed=8, nsrc=3, ntime=2, nant=3, nchan=6):
    """A 10 x 10 x 8 2x2 beam (tests/test_beam.py's cube) and inputs that
    satisfy one route's condition: "invariant" (channel-constant pointing
    errors and scalings, frequencies inside the cube), "in_cell"
    (per-channel errors far below the 4.4e-3 cube cell) or "general"
    (errors comparable to the cell, frequencies outside the cube)."""
    rng = np.random.default_rng(seed)
    lw, mh, nud = 10, 10, 8
    beam = (rng.normal(size=(lw, mh, nud, 2, 2))
            + 1j * rng.normal(size=(lw, mh, nud, 2, 2)))
    extents = np.array([[-0.02, 0.02], [-0.02, 0.02]])
    fmap = np.linspace(0.9e9, 1.6e9, nud)
    lm = rng.uniform(-0.015, 0.015, (nsrc, 2))
    pa = rng.uniform(-np.pi, np.pi, (ntime, nant))
    freq = np.linspace(fmap[0], fmap[-1], nchan)
    if kind == "invariant":
        pe = np.broadcast_to(rng.normal(scale=1e-4, size=(ntime, nant, 1, 2)),
                             (ntime, nant, nchan, 2)).copy()
        asc = np.broadcast_to(rng.uniform(0.9, 1.1, (nant, 1, 2)),
                              (nant, nchan, 2)).copy()
    elif kind == "in_cell":
        pe = rng.normal(scale=2e-6, size=(ntime, nant, nchan, 2))
        asc = 1.0 + rng.normal(scale=1e-6, size=(nant, nchan, 2))
    else:
        pe = rng.normal(scale=5e-3, size=(ntime, nant, nchan, 2))
        asc = rng.uniform(0.9, 1.1, (nant, nchan, 2))
        freq = np.linspace(0.85e9, 1.75e9, nchan)
    return beam, extents, fmap, lm, pa, pe, asc, freq


def _port(args, feed_type, dtype=np.complex128, **flags):
    beam = _t(args[0].astype(dtype))
    rest = [_t(a) for a in args[1:]]
    if feed_type is None:
        return beam_cube_dde(beam, *rest, **flags).numpy()
    return beam_cube_dde_fr(beam, *rest, feed_type=feed_type, **flags).numpy()


def _f32(args):
    """The inputs in float32 (complex64 beam), as the bench hands them to
    the Pallas routes: both packages then form the cube coordinates in
    float32."""
    return (args[0].astype(np.complex64),) + tuple(a.astype(np.float32)
                                                   for a in args[1:])


def _jax(args, feed_type, **kw):
    if feed_type is None:
        return to_numpy(beam_cube_dde_ri(*args, **kw))
    return to_numpy(beam_cube_dde_fr_ri(*args, feed_type=feed_type, **kw))


ROUTES = {"chan_invariant": dict(chan_invariant=True),
          "cell_residual": dict(chan_invariant=False, cell_residual=True),
          "general": dict(chan_invariant=False, cell_residual=False)}


@pytest.mark.parametrize("kind,route", [
    ("invariant", "chan_invariant"), ("invariant", "cell_residual"),
    ("invariant", "general"), ("in_cell", "cell_residual"),
    ("in_cell", "general"), ("general", "general")])
@pytest.mark.parametrize("feed_type", [None, "linear", "circular"])
def test_routes_match_xla_f64(kind, route, feed_type):
    """Each route, where its condition holds, equals the JAX package's
    XLA 8-gather path in float64 (the float64 kernel instances' plain
    versions)."""
    args = _problem(kind)
    want = _jax(args, feed_type, use_pallas=False)
    got = _port(args, feed_type, **ROUTES[route])
    assert got.shape == want.shape == (3, 2, 3, 6, 2, 2)
    assert got.dtype == np.complex128
    assert _rel(got, want) <= 1e-12


def _routes(caplog):
    """The routes the two packages logged, in call order."""
    port, jax_ = [], []
    for r in caplog.records:
        msg = r.getMessage()
        if r.name == "africanus_tpu_torch.rime.fast_beam_cubes":
            port.append(msg.split(": ")[1].split(" route")[0])
        elif r.name == "africanus_tpu.rime.fast_beam_cubes" and "pallas path" in msg:
            inv = "chan_invariant=True" in msg
            cell = "cell_residual=True" in msg
            jax_.append("chan_invariant" if inv else
                        "cell_residual" if cell else "general")
    return port, jax_


@pytest.mark.parametrize("kind,route", [("invariant", "chan_invariant"),
                                        ("in_cell", "cell_residual"),
                                        ("general", "general")])
@pytest.mark.parametrize("feed_type", [None, "linear", "circular"])
def test_routes_match_pallas_interpret(caplog, kind, route, feed_type):
    """float32: the port (plain versions of the kernels) against the JAX
    package's Pallas beam kernels in interpret mode, both detecting the
    route from the same inputs."""
    args = _f32(_problem(kind))
    with caplog.at_level(logging.DEBUG):
        want = _jax(args, feed_type, use_pallas=True, interpret=True)
        got = _port(args, feed_type, dtype=np.complex64)
    assert got.dtype == np.complex64
    assert _routes(caplog) == ([route], [route])
    assert_allclose(got, want.reshape(got.shape), **TOL32)


def test_forced_cell_route_extrapolates_like_jax():
    """Outside its condition the cell-residual route extrapolates the cell
    polynomial, as the JAX package's does (it then differs from the
    general route)."""
    args = _f32(_problem("general", nchan=5))
    want = _jax(args, "linear", use_pallas=True, interpret=True,
                cell_residual=True)
    got = _port(args, "linear", dtype=np.complex64, **ROUTES["cell_residual"])
    assert_allclose(got, want.reshape(got.shape), **TOL32)
    assert _rel(got, _port(args, "linear", dtype=np.complex64)) > 1e-3


def test_beam_cube_dde_checks():
    args = list(_problem("invariant"))
    small = _t(np.zeros((1, 10, 8, 4), np.complex64))
    with pytest.raises(ValueError, match=">= 2"):
        beam_cube_dde(small, *[_t(a) for a in args[1:]])
    with pytest.raises(ValueError, match="2x2"):
        beam_cube_dde_fr(_t(args[0][..., 0, :]), *[_t(a) for a in args[1:]])


def test_port_beam_cube_dde_hands_out_its_kernel_operands():
    """``operands`` receives each wrapper's positional operands: on the
    chan-invariant route, beam_interp's raw sums feed beam_blend, whose
    output is the result."""
    from africanus_tpu_torch.ops import cuda_beam as cb

    args = _f32(_problem("invariant"))
    ops = {}
    got = beam_cube_dde(_t(args[0]), *[_t(a) for a in args[1:]], operands=ops)
    assert set(ops) == {"beam_interp", "beam_blend"}
    raw = cb.beam_interp(*ops["beam_interp"])
    assert torch.equal(raw, ops["beam_blend"][0])
    assert torch.equal(cb.beam_blend(*ops["beam_blend"]).reshape(got.shape), got)


# ------------------------------------------------------------ small modules

def test_freq_grid_interp_matches_jax():
    fmap = np.linspace(0.9e9, 1.6e9, 8)
    freq = np.array([1.0e9, 1.23e9, 0.5e9, 2.0e9, fmap[3], fmap[0], fmap[-1]])
    got = freq_grid_interp(_t(freq), _t(fmap)).numpy()
    assert_allclose(got, np.asarray(jax_freq_grid_interp(freq, fmap)), rtol=0, atol=0)


def test_freq_grid_interp_reference_vectors():
    """tests/test_beam.py:291 (ref rime/tests/test_fast_beams.py:130-151)."""
    freqs = np.array([0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1])
    fmap = np.array([0.5, 0.56, 0.7, 0.91, 1.0])
    fd = freq_grid_interp(_t(freqs), _t(fmap)).numpy()
    assert_allclose(fd[:, 0], [0.8, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.1], atol=1e-7)
    assert fd[:, 2].astype(np.int32).tolist() == [0, 0, 1, 2, 2, 2, 3, 3]
    assert_allclose(fd[:, 1], [1.0, 1.0, 0.71428571, 1.0, 0.52380952,
                               0.04761905, 0.0, 0.0], atol=1e-7)


@pytest.mark.parametrize("feed_type", ["linear", "circular"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_feed_rotation_matches_jax(rng, feed_type, dtype):
    pa = rng.uniform(-np.pi, np.pi, (3, 4)).astype(dtype)
    got = feed_rotation(_t(pa), feed_type)
    assert got.shape == (3, 4, 2, 2)
    assert got.dtype == (torch.complex64 if dtype == np.float32 else torch.complex128)
    assert_allclose(got.numpy(), np.asarray(jax_feed_rotation(pa, feed_type)),
                    rtol=1e-6 if dtype == np.float32 else 1e-15, atol=0)


def test_feed_rotation_checks(rng):
    with pytest.raises(ValueError, match="feed_type"):
        feed_rotation(_t(rng.uniform(size=3)), "bogus")
    with pytest.raises(ValueError, match="non-floating"):
        feed_rotation(torch.arange(3), "linear")


def test_transform_sources_matches_jax(rng):
    nsrc, ntime, na, nchan = 5, 3, 4, 6
    lm = rng.uniform(-0.01, 0.01, (nsrc, 2))
    pa = rng.uniform(-np.pi, np.pi, (ntime, na))
    pe = rng.normal(scale=1e-4, size=(ntime, na, 2))
    scale = rng.uniform(0.9, 1.1, (na, nchan))
    freq = np.linspace(0.8e9, 1.7e9, nchan)
    got = transform_sources(*(_t(x) for x in (lm, pa, pe, scale, freq)))
    assert got.shape == (3, nsrc, ntime, na, nchan) and got.dtype == torch.float64
    want = np.asarray(jax_transform(lm, pa, pe, scale, freq))
    assert_allclose(got.numpy(), want, rtol=1e-15, atol=1e-20)
    # the sequential quirk: m' uses the rotated l'
    l0, m0 = lm[0]
    c, s = np.cos(pa[0, 0]), np.sin(pa[0, 0])
    lr = l0 * c - m0 * s
    assert_allclose(got[1, 0, 0, 0, 0].item(),
                    (lr * s + m0 * c + pe[0, 0, 1]) * scale[0, 0], rtol=1e-14)
    with pytest.raises(ValueError, match="pointing_errors shape"):
        transform_sources(_t(lm), _t(pa), _t(pe[:, :2]), _t(scale), _t(freq))
    with pytest.raises(ValueError, match="channel counts"):
        transform_sources(_t(lm), _t(pa), _t(pe), _t(scale), _t(freq[:2]))


def test_parallactic_angles_numpy_and_test_backends(wsrt_ants):
    fc = np.array([1.0, np.deg2rad(-5.0)])
    times = MJD0_SEC + np.linspace(0.0, 3600.0, 16)
    got = parallactic_angles(times, wsrt_ants, fc)
    assert isinstance(got, np.ndarray) and got.shape == (16, len(wsrt_ants))
    assert_allclose(got, jax_parangles(times, wsrt_ants, fc, backend="numpy"),
                    rtol=0, atol=0)
    test = parallactic_angles(_t(times), _t(wsrt_ants), _t(fc), backend="test")
    assert_allclose(test.numpy(), np.asarray(
        jax_parangles(times, wsrt_ants, fc, backend="test")), rtol=1e-15)


def test_parallactic_angles_torch_matches_jax_x64(wsrt_ants):
    fc = np.array([1.0, np.deg2rad(-5.0)])
    times = MJD0_SEC + np.linspace(0.0, 86164.0, 37)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # float64: no warning
        got = parallactic_angles(_t(times), _t(wsrt_ants), _t(fc), backend="torch")
    assert got.dtype == torch.float64
    want = np.asarray(jax_parangles(times, wsrt_ants, fc, backend="jax"))
    assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert_allclose(got.numpy(), parallactic_angles(times, wsrt_ants, fc),
                    rtol=0, atol=1e-12)


def test_parallactic_angles_checks(wsrt_ants):
    times = MJD0_SEC + np.arange(2) * 30.0
    with pytest.raises(ValueError, match="standard backends"):
        parallactic_angles(times, wsrt_ants, np.zeros(2), backend="bogus")
    with pytest.raises(ValueError, match="field_centre shape"):
        parallactic_angles(times, wsrt_ants, np.zeros(3))
    with pytest.warns(UserWarning, match="lose ~512 s"):
        parallactic_angles(_t(times.astype(np.float32)), _t(wsrt_ants),
                           _t(np.zeros(2)), backend="torch")


def test_astrometry_torch_and_numpy_match_jax(wsrt_ants):
    times = MJD0_SEC + np.linspace(0.0, 86400.0, 9)
    for name in ("gmst_from_mjd_seconds", "gast_from_mjd_seconds"):
        want = np.asarray(getattr(jax_astrometry, name)(times))
        assert_allclose(getattr(astrometry, name)(_t(times)).numpy(), want,
                        rtol=0, atol=1e-12)
        assert_allclose(getattr(astrometry, name)(times, np), want, rtol=0, atol=1e-12)
    for got, want in zip(astrometry.itrf_to_geodetic(_t(wsrt_ants)),
                         jax_astrometry.itrf_to_geodetic(wsrt_ants)):
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14, atol=1e-9)
    for got, want in zip(astrometry.precess_j2000_to_date(1.0, -0.3, _t(times)),
                         jax_astrometry.precess_j2000_to_date(1.0, -0.3, times)):
        assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    # parallactic_angle: transit zero, antisymmetry, Python numbers in
    lat, dec = np.deg2rad(52.9), np.deg2rad(-10.0)
    assert abs(float(astrometry.parallactic_angle(0.0, dec, lat))) < 1e-12
    p = astrometry.parallactic_angle(np.deg2rad(20.0), dec, lat)
    assert p.dtype == torch.float64
    assert_allclose(float(p), -float(astrometry.parallactic_angle(
        np.deg2rad(-20.0), dec, lat)), rtol=1e-12)


def test_fits_roundtrip_and_filenames(tmp_path, rng):
    data = rng.normal(size=(3, 5, 7))
    path = tmp_path / "test.fits"
    write_fits(path, data, [("CTYPE1", "X", "l axis"), ("CRVAL1", -1.5),
                            ("OBJECT", "beam"), ("FLAG", True)])
    header, out = read_fits(path)
    assert header["NAXIS1"] == 7 and header["CTYPE1"] == "X" and header["FLAG"] is True
    assert_allclose(out, data, rtol=0, atol=0)
    fn = beam_filenames("beam_$(CORR)_$(REIM).fits", [5, 8])
    assert fn["rr"] == ("beam_RR_RE.fits", "beam_RR_IM.fits")
    with pytest.raises(ValueError, match="Invalid correlation type"):
        beam_filenames("beam_$(corr)_$(reim).fits", [999])


@pytest.mark.parametrize("polarisation", ["linear", "circular"])
def test_beam_factory_and_load_match_jax(tmp_path, polarisation):
    """The port's beam factory writes the JAX package's files byte for
    byte; both packages load the same cube from them, which the port's
    beam_cube_dde then interpolates."""
    freq = np.linspace(0.856e9, 1.712e9, 16)
    port_schema = tmp_path / "port_$(corr)_$(reim).fits"
    jax_schema = tmp_path / "jax_$(corr)_$(reim).fits"
    files = beam_factory(polarisation, frequency=freq, npix=17, schema=port_schema,
                         rng=np.random.default_rng(5))
    jax_files = jax_beam_factory(polarisation, frequency=freq, npix=17,
                                 schema=jax_schema, rng=np.random.default_rng(5))
    for corr, pair in files.items():
        for a, b in zip(pair, jax_files[corr]):
            assert open(a, "rb").read() == open(b, "rb").read()
    corrs = [9, 10, 11, 12] if polarisation == "linear" else [5, 6, 7, 8]
    beam, ext, fmap = load_beam_cube(port_schema, corrs)
    jbeam, jext, jfmap = jax_load_beam_cube(port_schema, corrs)
    assert beam.shape == (17, 17, 33, 4)
    for a, b in ((beam, jbeam), (ext, jext), (fmap, jfmap)):
        assert_allclose(a, b, rtol=0, atol=0)
    nchan = 4
    e = beam_cube_dde(_t(beam), _t(ext), _t(fmap), _t(np.zeros((1, 2))),
                      _t(np.zeros((1, 1))), _t(np.zeros((1, 1, nchan, 2))),
                      _t(np.ones((1, nchan, 2))), _t(freq[:nchan]))
    # the field centre reads the cube's centre, where the factory writes
    # cos(0)³ = 1 to both the real and the imaginary file: |1 + 1j|
    assert e.shape == (1, 1, 1, nchan, 4) and bool(torch.isfinite(e.real).all())
    assert_allclose(e.abs().numpy(), np.sqrt(2.0), rtol=1e-12)
