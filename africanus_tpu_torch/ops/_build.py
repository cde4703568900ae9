"""Build, bind and launch the port's CUDA kernels.

Each kernel library under ``africanus_tpu_torch/csrc/`` has a plain C
interface, and :data:`LIBRARIES` is the one table of it: each library's
sources and each of its entry points' argument types. At the first launch
of one of its entries a library is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``build/`` at the repository
root, named by a hash of the sources and the flags, loaded with ctypes and
typed from the table. A later call (or process) with the same sources and
flags loads the library already built. Nothing is compiled while a module
is imported, and nothing falls back: a failed build raises.

:func:`launch` is the one way a wrapper calls a kernel; :func:`build_all`
compiles every library, and :func:`use` loads a variant of a library's
source in place of its build (for tools that time variants of a kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "LIBRARIES", "build", "build_all",
           "use", "launch", "groups", "plan_device"]

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

# c_void_p for every pointer and the stream: ctypes would pass a bare
# Python int as a 32-bit int and cut the address
_P, _I, _Q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F, _D = ctypes.c_float, ctypes.c_double

# library: (its sources under csrc/, {entry: argument types}). An entry
# ``e`` is the C function ``int e_launch(..., void* stream)``, which
# returns a CUDA error code; a library's ``int <library>_init()``, where
# it exports one, raises its kernels' dynamic shared-memory limits.
LIBRARIES = {
    "predict_kb": (("predict_kb.cu",), {
        "predict_kb": ([_P] * 9 + [_I] * 3 + [_F] * 2 + [_P] + [_I] * 4 + [_P] * 5
                       + [_I] * 2 + [_P]),
        "predict_kb_plain": [_P] * 7 + [_I] * 4 + [_P],
    }),
    "dft": (("dft.cu",), {
        "dft_forward": ([_P] * 6 + [_I] + [_P] * 3 + [_I] * 4 + [_F] * 4 + [_P]
                        + [_I] * 4 + [_P]),
        "dft_adjoint": [_P] * 9 + [_I] * 4 + [_F] * 4 + [_P] * 2 + [_I] * 6 + [_P],
    }),
    "wgrid": (("wgrid.cu",), {
        "wgrid_spread": [_P] * 10 + [_I] * 13 + [_D, _I, _P],
        "wgrid_degrid": [_P] * 11 + [_I] * 11 + [_D, _I, _P],
    }),
    "beam": (("beam.cu",), {
        "beam_interp": [_P] * 7 + [_I] * 12 + [_P],
        "beam_blend": [_P] * 5 + [_I] * 6 + [_P],
        "beam_blend_cell": [_P] * 7 + [_I] * 6 + [_P],
    }),
    "grid2d": (("grid2d.cu",), {
        "grid2d_spread": [_P] * 7 + [_Q, _Q, _P] + [_I] * 11 + [_D, _I, _P],
        "grid2d_degrid": [_P] * 9 + [_I] * 8 + [_D, _I, _P],
    }),
    "gridtab": (("gridtab.cu",), {
        "gridtab_spread": [_P] * 9 + [_I] * 11 + [_P],
        "gridtab_degrid": [_P] * 10 + [_I] * 10 + [_P],
    }),
    "hogbom": (("hogbom.cu",), {
        "hogbom": [_P] * 5 + [_D] * 2 + [_I] * 7 + [_P],
    }),
    "fused_dde": (("fused_dde.cu",), {
        "fused_dde": [_P] * 12 + [_I] * 12 + [_P],
        "fused_pairs": [_P] * 4 + [_I] * 2 + [_F] * 2 + [_P],
    }),
}
# entry: its library
_OWNER = {e: name for name, (_, entries) in LIBRARIES.items() for e in entries}


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


def _tmp(path: Path) -> Path:
    """A name beside ``path`` of this process and thread's own: a file is
    written there whole and then moved into place, so that concurrent
    builds never see half a file."""
    return path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")


def build(name: str, source: str | Path | None = None) -> tuple[Path, float, str]:
    """Compile library ``name`` into ``build/lib<name>-<hash>.so`` from its
    sources under ``csrc/``; or, where ``source`` is given, a variant of it
    into ``build/variants/``: ``source`` the text of a ``.cu`` file, or
    its path, compiled with the same command as if it stood in ``csrc/``.

    Returns (library path, seconds spent compiling — 0.0 when the
    library was already built —, the compiler's log).
    """
    if source is None:
        files, out = [CSRC / s for s in LIBRARIES[name][0]], BUILD_DIR
    else:
        text = source.read_text() if isinstance(source, Path) else source
        out = BUILD_DIR / "variants"
        d = out / f"{name}-{hashlib.sha256(text.encode()).hexdigest()[:16]}"
        files = [d / f"{name}.cu"]
        if not files[0].is_file():
            d.mkdir(parents=True, exist_ok=True)
            tmp = _tmp(files[0])
            tmp.write_text(text)
            os.replace(tmp, files[0])
    digest = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    # the sources, and every header under csrc/ that they may include
    for src in (*files, *sorted(CSRC.glob("*.cuh"))):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = out / f"lib{name}-{digest.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""

    out.mkdir(parents=True, exist_ok=True)
    tmp = _tmp(lib)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(f) for f in files)]
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
    os.replace(tmp, lib)
    return lib, seconds, text


def build_all() -> dict[str, tuple[Path, float, str]]:
    """Compile every library of :data:`LIBRARIES` that is not built yet,
    all at once: {library: what :func:`build` returns}."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))


def _bind(name: str, lib) -> tuple:
    """Type library ``name``'s functions in ``lib`` (a loaded build) from
    the table: (its ``<name>_init`` or None where it exports none,
    {entry: launch function})."""
    fns = {}
    for entry, argtypes in LIBRARIES[name][1].items():
        fn = getattr(lib, f"{entry}_launch")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[entry] = fn
    init = getattr(lib, f"{name}_init", None)
    if init is not None:
        init.argtypes, init.restype = [], ctypes.c_int
    return init, fns


# library: its loaded build, typed (what _bind returns)
_LOADED = {}
# (library, device index) pairs whose init has run, or that have none
_READY = set()


def use(name: str, source: str | Path | None = None) -> None:
    """Load library ``name``, built from ``source`` as :func:`build` takes
    it, in place of the build its entries launched so far: every later
    launch of them runs it, and its init runs again on each device. For
    tools that time variants of a kernel; ``source`` None goes back to the
    build of ``csrc/``."""
    _LOADED[name] = _bind(name, ctypes.CDLL(str(build(name, source)[0])))
    _READY.difference_update({key for key in _READY if key[0] == name})


def launch(entry: str, device, *args) -> None:
    """Call kernel entry point ``entry`` (the C function ``<entry>_launch``)
    on ``device`` and its current stream, ``args`` in the C order without
    the stream: a tensor passes as its data pointer, None as NULL, a
    number as the table types it.

    The library is built (if needed), loaded and typed at its first
    launch in the process, and its init runs once per device before the
    first launch there — so never inside a CUDA-graph capture, which
    starts after a warm-up call. Raises where the entry returns a CUDA
    error (a refused launch never runs).
    """
    name = _OWNER[entry]
    if name not in _LOADED:
        use(name)
    init, fns = _LOADED[name]
    fn = fns[entry]
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{entry}_launch takes {len(fn.argtypes) - 1} arguments "
                        f"and the stream, got {len(args)}")
    with torch.cuda.device(device):
        if (name, device.index) not in _READY:
            rc = 0 if init is None else init()
            if rc != 0:
                raise RuntimeError(f"{name}_init failed: CUDA error {rc}")
            _READY.add((name, device.index))
        rc = fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args],
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")


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
