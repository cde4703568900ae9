"""Port parity for the slice as a whole: SelfcalStep (the config-5
selfcal step of bench.py:1145-1179) against the same step assembled
from the JAX package's functions, on the same data, at a small size
(8 antennas, 2 times, 8 channels, 5 sources, 2 correlations, a 16²
image).

The data are made by the JAX package (im_to_vis_ri + corrupt_vis_ri, as
bench.py:1130-1137) and carried over as (re, im) numpy pairs. Two cases:
"converged", the bench's own, whose model holds every source; and
"unmodelled-source", whose model lacks the last source, so that the
residual holds it and the dirty image is far from zero (max 0.11 here,
against 3e-4 converged). Bounds (both sides float32):
- gains, JᴴJ: 1e-5 relative — f32 rounding through 10 Gauss-Newton
  iterations, with sums in other orders;
- converged: JᴴR, the dirty image and CLEAN's images 1e-5 of the scale
  they are made from (max JᴴJ; the dirty image of |data|) — after the
  solve they are rounding noise, so only their size and CLEAN's
  components are held;
- unmodelled-source: JᴴR and the three images 1e-5 of their own max
  (measured: ≤ 4.6e-7), and the same CLEAN components;
- the re-predict: 3e-6·max|V|, the DFT bound of tests/test_dft.py.
The port's own model data (make_data) agree with the JAX package's
within the same DFT bound, and the f64 oracles and the bench's
gain-product check are held against the port at this size.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from africanus_tpu.calibration.phase_only import gauss_newton_ri
from africanus_tpu.calibration.utils import corrupt_vis_ri
from africanus_tpu.deconv.hogbom import hogbom_clean
from africanus_tpu.dft import im_to_vis_ri, vis_to_im_ri
from africanus_tpu.ops.cplx import Cplx

from africanus_tpu_torch.calibration.selfcal import (
    SelfcalStep, from_numpy, gain_product_error, grid_lm, im_to_vis_oracle_f64,
    make_data, selfcal_inputs, vis_to_im_oracle_f64,
)

SHAPE = dict(nant=8, ntime=2, nchan=8, nsrc=5, ncorr=2)
NPX, GN_ITERS = 16, 10


def _np(c):
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _pair(c):
    return np.asarray(c.re), np.asarray(c.im)


def _jax_model(a, nsrc):
    """The JAX package's (row, chan, 1, corr) model of the first ``nsrc``
    sources."""
    m = im_to_vis_ri(a["image"][:nsrc], a["uvw"], a["lm"][:nsrc],
                     a["frequency"])
    return Cplx(np.asarray(m.re)[:, :, None, :], np.asarray(m.im)[:, :, None, :])


@pytest.fixture(scope="module")
def args():
    """selfcal_inputs with the JAX package's model and data."""
    a = selfcal_inputs(seed=5, **SHAPE)
    model = _jax_model(a, SHAPE["nsrc"])
    phase = a["true_phase"]
    data = corrupt_vis_ri(a["time_bin_indices"], a["time_bin_counts"],
                          a["antenna1"], a["antenna2"],
                          Cplx(np.cos(phase), np.sin(phase)), model)
    return dict(a, model=_pair(model), data=_pair(data))


def _jax_step(a):
    """bench.py:1145-1179 with the JAX package, returning its outputs."""
    meta = (a["time_bin_indices"], a["time_bin_counts"], a["antenna1"],
            a["antenna2"])
    model, data = Cplx(*a["model"]), Cplx(*a["data"])
    gains, jhj, jhr, _ = gauss_newton_ri(
        *meta, Cplx(*a["jones0"]), data, a["flag"], model, a["weight"],
        tol=0.0, maxiter=GN_ITERS)
    vmod = corrupt_vis_ri(*meta, gains, model)
    resid = Cplx(data.re - vmod.re, data.im - vmod.im)
    resid_i = Cplx(resid.re.sum(-1, keepdims=True),
                   resid.im.sum(-1, keepdims=True))
    im = vis_to_im_ri(resid_i, a["uvw"], grid_lm(NPX), a["frequency"],
                      a["flag"][..., :1])
    nvis = a["uvw"].shape[0] * a["frequency"].shape[0]
    dirty = im.sum(axis=(1, 2)).reshape(NPX, NPX) / nvis
    psf = jnp.zeros((2 * NPX, 2 * NPX), jnp.float32).at[NPX - 1, NPX - 1].set(1.0)
    clean, res = hogbom_clean(dirty, psf, gamma=0.1, threshold=0.2, niter=50)
    re_model = im_to_vis_ri(a["image"], a["uvw"], a["lm"], a["frequency"])
    return (_np(gains), np.asarray(jhj), _np(jhr), np.asarray(dirty),
            np.asarray(clean), np.asarray(res), _np(re_model))


def _max_err(got, want):
    return np.abs(got - want).max()


@pytest.mark.parametrize("unmodelled", [False, True],
                         ids=["converged", "unmodelled-source"])
def test_step_matches_jax(args, unmodelled):
    if unmodelled:
        args = dict(args, model=_pair(_jax_model(args, SHAPE["nsrc"] - 1)))
    want = _jax_step(args)
    step, data = from_numpy(args, "cpu", npx=NPX, gn_iters=GN_ITERS)
    got = [x.numpy() for x in step(data)]
    names = ["gains", "jhj", "jhr", "dirty", "clean", "residual", "re_model"]
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert np.all(np.isfinite(g)), name
    gains, jhj, jhr, dirty, clean, res, re_model = got
    wg, wjhj, wjhr, wdirty, wclean, wres, wre = want
    assert _max_err(gains, wg) <= 1e-5
    assert _max_err(jhj, wjhj) <= 1e-5 * np.abs(wjhj).max()
    images = ((dirty, wdirty), (clean, wclean), (res, wres))
    if unmodelled:
        assert np.abs(wdirty).max() >= 0.05  # the source is in the residual
        assert _max_err(jhr, wjhr) <= 1e-5 * np.abs(wjhr).max()
        for g, w in images:
            assert _max_err(g, w) <= 1e-5 * np.abs(w).max()
    else:
        assert _max_err(jhr, wjhr) <= 1e-5 * np.abs(wjhj).max()
        # the scale the images are made from: the dirty image of |data|
        d = args["data"][0] + 1j * args["data"][1]
        scale = np.abs(d).sum() / (d.shape[0] * d.shape[1])
        for g, w in images:
            assert _max_err(g, w) <= 1e-5 * scale
    assert (wclean != 0).sum() > 0
    np.testing.assert_array_equal(clean != 0, wclean != 0)  # same components
    assert np.abs(re_model - wre).max() <= 3e-6 * np.abs(wre).max()


def test_make_data_matches_jax(args):
    a = {k: v for k, v in args.items() if k not in ("model", "data")}
    ours = make_data(a, "cpu")
    for key in ("model", "data"):
        got = ours[key][0] + 1j * ours[key][1]
        want = args[key][0] + 1j * args[key][1]
        assert got.shape == want.shape and got.dtype == np.complex64
        assert np.abs(got - want).max() <= 3e-6 * np.abs(want).max()


def test_step_against_oracles_and_truth(args):
    """The checks chip_smoke.py runs at config 5, here at a small size:
    the two DFTs against their float64 oracles, and a 40-iteration solve
    against the true gains (bench.py:1257-1266's 1e-5)."""
    step, data = from_numpy(args, "cpu", npx=NPX, gn_iters=40)
    assert gain_product_error(step(data)[0], args["true_phase"]) <= 1e-5

    from africanus_tpu_torch.dft import im_to_vis, vis_to_im

    d = args["data"][0] + 1j * args["data"][1]
    got = vis_to_im(data, step.uvw, step.grid_lm, step.frequency,
                    step.flag).numpy()
    want = vis_to_im_oracle_f64(d, args["uvw"], grid_lm(NPX), args["frequency"])
    assert np.abs(got - want).max() <= 3e-6 * np.abs(want).max()
    got = im_to_vis(step.image, step.uvw, step.lm, step.frequency).numpy()
    want = im_to_vis_oracle_f64(args["image"], args["uvw"], args["lm"],
                                args["frequency"])
    assert np.abs(got - want).max() <= 3e-6 * np.abs(want).max()


def test_selfcal_inputs_layout(args):
    nrow = SHAPE["ntime"] * SHAPE["nant"] * (SHAPE["nant"] - 1) // 2
    assert args["uvw"].shape == (nrow, 3) and args["uvw"].dtype == np.float32
    assert args["time_bin_indices"].tolist() == [0, nrow // 2]
    assert args["jones0"][0].shape == (2, 8, 8, 1, 2)
    again = selfcal_inputs(seed=5, **SHAPE)
    for key in ("lm", "uvw", "image", "true_phase"):
        np.testing.assert_array_equal(again[key], args[key])
    step, _ = from_numpy(args, "cpu", npx=NPX)
    assert isinstance(step, SelfcalStep)
    assert list(step.parameters()) == []
    assert {"uvw", "model", "jones0", "psf", "gather_sel"} <= set(
        dict(step.named_buffers()))
