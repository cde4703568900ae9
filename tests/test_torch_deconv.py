"""Port parity: africanus_tpu_torch.deconv.hogbom against
africanus_tpu.deconv.hogbom.

CLEAN must take the same components in the same order as the JAX
package's while-loop: argmax of the residual (not of its magnitude),
first index on ties, up to niter + 1 components, the PSF window
[npix−1−p : 2npix−1−p]. Both sides run float64 with the same
elementwise update, so the pixels picked are compared exactly and the
images within 1e-12 of their peak. restore is host scipy on both sides:
1e-12.
"""

import numpy as np
import pytest
import torch

from africanus_tpu.deconv.hogbom import find_peak as jax_find_peak
from africanus_tpu.deconv.hogbom import hogbom_clean as jax_hogbom_clean
from africanus_tpu.deconv.hogbom import restore as jax_restore

from africanus_tpu_torch.deconv.hogbom import (
    find_peak, fit_2d_gaussian, hogbom_clean, restore,
)


def _psf(npix, width=1.5):
    """(2npix, 2npix) gaussian PSF peaking at (npix−1, npix−1)."""
    x = np.arange(2 * npix) - (npix - 1)
    return np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / (2 * width ** 2))


def _sky(rng, npix, nsrc=4):
    dirty = rng.normal(scale=0.01, size=(npix, npix))
    psf = _psf(npix)
    for _ in range(nsrc):
        p, q = rng.integers(0, npix, 2)
        dirty += rng.uniform(0.5, 2.0) * psf[npix - 1 - p:2 * npix - 1 - p,
                                             npix - 1 - q:2 * npix - 1 - q]
    return dirty, psf


@pytest.mark.parametrize("npix,gamma,threshold,niter",
                         [(16, 0.1, 0.2, 50), (24, 0.3, 0.05, 200),
                          (16, 0.1, "default", "default"), (12, 0.5, 0.0, 7)])
def test_hogbom_matches_jax(rng, npix, gamma, threshold, niter):
    dirty, psf = _sky(rng, npix)
    wc, wr = (np.asarray(x) for x in jax_hogbom_clean(dirty, psf, gamma,
                                                       threshold, niter))
    gc, gr = hogbom_clean(torch.from_numpy(dirty), torch.from_numpy(psf),
                          gamma, threshold, niter)
    assert gc.dtype == torch.float64
    np.testing.assert_array_equal(gc.numpy() != 0, wc != 0)  # same pixels
    scale = np.abs(dirty).max()
    assert np.abs(gc.numpy() - wc).max() <= 1e-12 * scale
    assert np.abs(gr.numpy() - wr).max() <= 1e-12 * scale


def test_hogbom_takes_niter_plus_one_components():
    """With a delta PSF at the reference's centre and a threshold of 0,
    every iteration takes one component from the brightest pixel:
    niter + 1 of them (the reference's ``i <= niter``)."""
    npix, niter = 8, 5
    psf = np.zeros((2 * npix, 2 * npix))
    psf[npix - 1, npix - 1] = 1.0
    dirty = np.zeros((npix, npix))
    dirty.reshape(-1)[:10] = np.arange(10, 0, -1) * 10.0  # distinct, falling
    gc, gr = hogbom_clean(torch.from_numpy(dirty), torch.from_numpy(psf),
                          gamma=1.0, threshold=0.0, niter=niter)
    taken = np.flatnonzero(gc.numpy())
    np.testing.assert_array_equal(taken, np.arange(niter + 1))
    wc, _ = jax_hogbom_clean(dirty, psf, 1.0, 0.0, niter)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_hogbom_ties_take_first_index_and_signed_max():
    """Ties go to the first flat index; the peak is the signed maximum,
    so a deeper negative pixel is never picked."""
    npix = 6
    psf = np.zeros((2 * npix, 2 * npix))
    psf[npix - 1, npix - 1] = 1.0
    dirty = np.zeros((npix, npix))
    dirty[1, 4] = dirty[3, 2] = 5.0
    dirty[0, 0] = -9.0
    gc, _ = hogbom_clean(torch.from_numpy(dirty), torch.from_numpy(psf),
                         gamma=0.5, threshold=0.0, niter=0)
    assert np.flatnonzero(gc.numpy()).tolist() == [1 * npix + 4]
    wc, _ = jax_hogbom_clean(dirty, psf, 0.5, 0.0, 0)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_hogbom_float32_and_validation(rng):
    dirty, psf = _sky(rng, 16)
    d32, p32 = dirty.astype(np.float32), psf.astype(np.float32)
    wc, wr = jax_hogbom_clean(d32, p32, 0.1, 0.2, 50)
    gc, gr = hogbom_clean(torch.from_numpy(d32), torch.from_numpy(p32),
                          0.1, 0.2, 50)
    assert gc.dtype == torch.float32
    np.testing.assert_array_equal(gc.numpy() != 0, np.asarray(wc) != 0)
    assert np.abs(gr.numpy() - np.asarray(wr)).max() <= 1e-6 * np.abs(d32).max()
    with pytest.raises(ValueError, match="psf"):
        hogbom_clean(torch.from_numpy(dirty), torch.from_numpy(psf[:-2]))
    with pytest.raises(ValueError, match="square"):
        hogbom_clean(torch.zeros((4, 5)), torch.zeros((8, 10)))


def test_find_peak(rng):
    img = rng.normal(size=(7, 9))
    got = [int(x) if i < 4 else float(x)
           for i, x in enumerate(find_peak(torch.from_numpy(img)))]
    want = [int(x) if i < 4 else float(x)
            for i, x in enumerate(jax_find_peak(img))]
    assert got == want


def test_restore_and_fit(rng):
    npix = 32
    psf = _psf(npix // 2, width=2.0)  # (32, 32)
    clean = np.zeros((npix, npix))
    clean[10, 12], clean[20, 5] = 1.0, 0.5
    resid = rng.normal(scale=0.01, size=(npix, npix))
    want = [np.asarray(x) for x in jax_restore(clean, psf, resid)]
    got = restore(torch.from_numpy(clean), torch.from_numpy(psf),
                  torch.from_numpy(resid))
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor)
        assert np.abs(g.numpy() - w).max() <= 1e-12 * np.abs(w).max()
    beam = fit_2d_gaussian(torch.from_numpy(psf))
    assert beam.shape == psf.shape and float(beam.max()) == pytest.approx(1.0)
