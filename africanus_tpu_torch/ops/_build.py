"""Build and load the port's CUDA kernels.

Each kernel source under ``africanus_tpu_torch/csrc/`` has a plain C
interface. At first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/`` at the repository
root, named by a hash of the sources and the flags, and loaded with
ctypes. A later call (or process) with the same sources and flags loads
the library already built. Nothing is compiled while a module is
imported, and nothing falls back: a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# No --use_fast_math (it would turn on FMA contraction everywhere, flush
# denormals to zero and approximate sin/cos/exp); -Xptxas -v reports
# registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.is_file():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {path} and on PATH): the CUDA "
            "kernels are built on a machine with the CUDA toolkit")
    return found


def build(name: str, sources: tuple[str, ...]) -> tuple[Path, float, str]:
    """Compile ``sources`` (file names under ``csrc/``) into
    ``build/lib<name>-<hash>.so``.

    Returns (library path, seconds spent compiling — 0.0 when the
    library was already built —, the compiler's log).
    """
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.encode())
        digest.update((CSRC / src).read_bytes())
    lib = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, seconds, text


@functools.cache
def load(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    lib, _, _ = build(name, sources)
    return ctypes.CDLL(str(lib))
