"""Build, load and launch the port's CUDA kernels.

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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "init_once",
           "launch", "groups", "plan_device"]

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
    # the sources, and every header under csrc/ that they may include
    for src in (*sources, *sorted(p.name for p in CSRC.glob("*.cuh"))):
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


# (library, device index) pairs whose ``<name>_init()`` has run
_READY = set()


def init_once(name: str, sources: tuple[str, ...], device) -> None:
    """Call the library's ``<name>_init()`` (which raises its kernels'
    dynamic shared-memory limits) once per device, before the first
    launch — so never inside a CUDA-graph capture, which starts after a
    warm-up call."""
    import torch

    if (name, device.index) in _READY:
        return
    fn = getattr(load(name, sources), f"{name}_init")
    fn.argtypes, fn.restype = [], ctypes.c_int
    with torch.cuda.device(device):
        rc = fn()
    if rc != 0:
        raise RuntimeError(f"{name}_init failed: CUDA error {rc}")
    _READY.add((name, device.index))


def launch(fn, name: str, plan, *args) -> None:
    """Call a kernel entry point on the plan's device and current stream,
    appending ``is_double`` (the plan's dtype is float64) and the stream;
    raise if it returns a CUDA error (a refused launch never runs)."""
    import torch

    with torch.cuda.device(plan.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, int(plan.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def groups(n: int, sizes) -> list[tuple[int, int]]:
    """(first, count) of the groups that split an axis of ``n`` (e.g. the
    correlations) into counts a kernel takes: greedily the largest of
    ``sizes`` (which holds 1) that fits, so 3 = 2 + 1 for (4, 2, 1)."""
    out, first = [], 0
    sizes = sorted(sizes, reverse=True)
    while first < n:
        k = next(k for k in sizes if k <= n - first)
        out.append((first, k))
        first += k
    return out


def plan_device(device):
    """The ``torch.device`` a plan is held on: a CUDA device with its index
    resolved (``"cuda"`` is ``cuda:<current index>``), so that one device
    has one name. Raises where CUDA is asked for and there is no card:
    nothing falls back to the CPU, which a caller asks for with
    ``device="cpu"``."""
    import torch

    d = torch.device(device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r}: there is no CUDA card "
                "(torch.cuda.is_available() is False); pass device=\"cpu\" "
                "for the CPU path")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d
