"""africanus_tpu_torch — the PyTorch/CUDA port of ``africanus_tpu``.

Each module mirrors one module of the JAX package
(``africanus_tpu/rime/phase.py`` → ``africanus_tpu_torch/rime/phase.py``),
which stays the reference the port is tested against. Plain tensor code
is PyTorch; every Pallas TPU kernel on a ported path is a CUDA C++
kernel written for Hopper (``sm_90a``) under ``csrc/``, built at first
use and bound with ctypes (``ops/_build.py``).

The port imports ``torch`` and numpy, never ``jax`` or ``africanus_tpu``.
Public functions take and return torch tensors (complex64/complex128
where the JAX package used split re/im pairs), with an explicit
``device`` wherever they create tensors.

Layout (ported: the flagship predict, selfcal, w-stacked imaging, the
beam DDE chain, the gridders, the averagers, the fused RIME, the WSClean
store predict, the sky-model tail, GP gains and the examples)
------
- ``averaging``    — time-and-channel and baseline-dependent averaging:
                     host mappers, fixed-order segmented sums on the
                     data's device
- ``calibration``  — gain corruption/correction, the phase-only
                     Gauss-Newton solver, the selfcal step module
- ``constants``    — physical constants
- ``coordinates``  — radec ↔ lm(n) transforms
- ``deconv``       — Hogbom CLEAN
- ``dft``          — direct Fourier transforms (im_to_vis, vis_to_im)
- ``examples``     — the JAX package's 14 examples as runnable pipelines
                     (``python -m africanus_tpu_torch.examples.<name>
                     --device cuda|cpu``), each a library function and a
                     ``main()``; ``launches`` reports their kernel launches
- ``gps``          — Gaussian-process covariance kernels
                     (``exponential_squared``, ``abs_diff``)
- ``gridding``     — the w-stacking gridder/degridder (wgridder: dirty,
                     model, residual, hessian, WStackImaging), cell sizes
- ``io``           — the MS-shaped column store (``MSStore``)
- ``linalg``       — Kronecker-structured algebra (``kron_matvec``,
                     ``kron_matmat``, ``kron_cholesky``, …)
- ``model``        — spectral model, Stokes ↔ correlation conversion,
                     gaussian and shapelet shapes, WSClean component lists
                     and spectra, SPI fitting
- ``native``       — the averaging mappers' C++ cores (g++, ctypes)
- ``ops``          — two-float arithmetic, 2×2 Jones products, the ES
                     kernel, the fused K×env×B predict kernel
                     (``cuda_predict``), the DFT kernels (``cuda_dft``),
                     the w-stack grid/degrid kernels (``cuda_wgrid``) and
                     the beam-cube kernels (``cuda_beam``)
- ``parallel``     — host-streamed row chunks (``stream_rows``)
- ``rime``         — phase delay, predict_vis, the flagship predict module,
                     beam cube DDEs, feed rotation, source transforms,
                     parallactic angles, the config-3 beam chain module,
                     Zernike DDEs, the WSClean predict, the fused RIME
                     (``rime.fused``: specification, terms,
                     transformers, ``rime``)
- ``testing``      — FITS beam-cube factory, seeded averaging inputs
- ``utils``        — CASA Stokes enumerations, dtype helpers, plan caches,
                     FITS IO, beam headers, astrometry
"""

__version__ = "0.1.0"
