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

Layout (the ported slices: the flagship RIME predict, the selfcal loop)
------
- ``calibration``  — gain corruption/correction, the phase-only
                     Gauss-Newton solver, the selfcal step module
- ``constants``    — physical constants
- ``coordinates``  — radec ↔ lm(n) transforms
- ``deconv``       — Hogbom CLEAN
- ``dft``          — direct Fourier transforms (im_to_vis, vis_to_im)
- ``model``        — spectral model, Stokes ↔ correlation conversion,
                     gaussian shape
- ``ops``          — two-float arithmetic, 2×2 Jones products, the fused
                     K×env×B predict kernel (``cuda_predict``) and the DFT
                     kernels (``cuda_dft``)
- ``rime``         — phase delay, predict_vis, the flagship predict module
- ``utils``        — CASA Stokes enumerations, dtype helpers
"""

__version__ = "0.1.0"
