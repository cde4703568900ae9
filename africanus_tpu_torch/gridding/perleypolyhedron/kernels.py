"""Anti-aliasing kernels for the Perley-polyhedron gridder.

A numpy copy of ``africanus_tpu/gridding/perleypolyhedron/kernels.py`` (the
port imports nothing of the JAX package), itself the host-side equivalent
of reference
``africanus/gridding/perleypolyhedron/kernels.py`` (sinc/kbsinc/hanningsinc
:36-88, pack_kernel:86, unpack_kernel:102, compute_detaper*:118-166):
oversampled 1D windows with W taps plus one padding tap per side, packed
into cache-coherent order, and the image-plane detapering correction.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "uspace",
    "sinc",
    "kbsinc",
    "hanningsinc",
    "pack_kernel",
    "unpack_kernel",
    "compute_detaper",
    "compute_detaper_dft",
    "compute_detaper_dft_seperable",
]


def uspace(W, oversample):
    """Kernel sample positions: W odd taps plus a padding tap per side,
    each oversampled."""
    assert W % 2 == 1, "W must be odd so taps can centre at the origin"
    return np.arange(oversample * (W + 2)) / float(oversample) - (W + 2) // 2


def sinc(W, oversample=5, a=1.0):
    """Oversampled sinc window, normalised to unit sum."""
    res = np.sinc(uspace(W, oversample) * a)
    return res / np.sum(res)


# slope/intercept fit of optimal KB shape parameter vs support
_KBSINC_AUTOCOEFFS = np.polyfit(
    [1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0],
    [1.9980, 2.3934, 3.3800, 4.2054, 4.9107, 5.7567, 6.6291, 7.4302],
    1,
)


def kbsinc(W, b=None, oversample=5, order=15):
    """Modified Kaiser-Bessel windowed sinc (Jackson et al. 1991), using a
    higher-order Bessel window by default."""
    from scipy.special import jn

    if b is None:
        b = np.poly1d(_KBSINC_AUTOCOEFFS)(W + 2)
    # the window's characteristic span is the padded support plus one
    span = W + 3
    u = uspace(W, oversample)
    # J_order Bessel window over the elliptical argument; the reference
    # scales the window by sum(wnd)/span before applying it to the sinc
    # (a shape-only quirk — the final unit-sum normalisation absorbs any
    # constant — preserved for bit parity)
    wnd = jn(order, b * np.sqrt(1.0 - (2.0 * u / span) ** 2)) / span
    res = sinc(W, oversample=oversample) * (wnd * np.sum(wnd))
    return res / np.sum(res)


_HANNING_AUTOCOEFFS = np.polyfit(
    [1.5, 2.0, 2.5, 3.0, 3.5], [0.7600, 0.7146, 0.6185, 0.5534, 0.5185], 3
)


def hanningsinc(W, a=None, oversample=5):
    """Hanning windowed sinc."""
    if a is None:
        a = np.poly1d(_HANNING_AUTOCOEFFS)(W + 2)
    span = W + 3
    u = uspace(W, oversample)
    # raised cosine with one full period across the padded span
    wnd = a + (1.0 - a) * np.cos(2.0 * np.pi * u / span)
    res = sinc(W, oversample=oversample) * wnd
    return res / np.sum(res)


def pack_kernel(K, W, oversample=5):
    """Repack taps into cache-coherent order (fractional offset major):
    tap-major K[j·oversample + t] → offset-major pkern[t·(W+2) + j],
    i.e. one transpose of the (taps, offsets) view."""
    return np.ascontiguousarray(
        np.asarray(K).reshape(W + 2, oversample).T
    ).reshape(-1)


def unpack_kernel(K, W, oversample=5):
    """Inverse of :func:`pack_kernel` (transpose back to tap-major)."""
    return np.ascontiguousarray(
        np.asarray(K).reshape(oversample, W + 2).T
    ).reshape(-1)


def compute_detaper(npix, K, W, oversample=5):
    """Image-plane detaper via zero-padded FFT of the 2D kernel."""
    n_os = npix * oversample
    pk = np.zeros((n_os, n_os))
    lo = n_os // 2 - K.shape[0] // 2
    pk[lo : lo + K.shape[0], lo : lo + K.shape[1]] = K
    fpk = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(pk)))
    c = n_os // 2 - npix // 2
    return np.abs(fpk[c : c + npix, c : c + npix])


def compute_detaper_dft(npix, K, W, oversample=5):
    """Detaper via direct DFT of the 2D kernel at image resolution."""
    ksample = uspace(W, oversample=oversample)
    ll = (np.arange(npix) - npix // 2) / float(npix)
    xx = ksample[None, :]  # kernel u positions
    # separable in principle, but K may be an arbitrary 2D kernel here
    ky, kx = np.meshgrid(ksample, ksample, indexing="ij")
    phase_l = np.exp(-2.0j * np.pi * np.outer(ll, kx.ravel()))
    out = np.empty((npix, npix), np.complex128)
    for mi, mmN in enumerate(ll):
        wave_m = np.exp(-2.0j * np.pi * mmN * ky.ravel())
        out[mi] = (K.ravel() * wave_m) @ phase_l.T
    return np.abs(out)


def compute_detaper_dft_seperable(npix, K, W, oversample=5):
    """Detaper via the separable 1D DFT (outer product of 1D transforms)."""
    ksample = uspace(W, oversample=oversample)
    ll = (np.arange(npix) - npix // 2) / float(npix)
    f1d = np.exp(-2.0j * np.pi * np.outer(ll, ksample)) @ K
    return np.abs(np.outer(f1d, f1d))
