#!/usr/bin/env python3
"""Where predict_kb's time goes, on one CUDA card.

    python3 tools/predict_kb_variants.py

Builds variants of africanus_tpu_torch/csrc/predict_kb.cu (text
substitutions of the source) as the port builds the source, into
build/variants/, and times each in turns (the list, then the
list reversed), as chip_smoke.py times a kernel (a CUDA graph of 10
launches), at two shapes: the flagship chunk (chip_smoke.py's phase 6:
100 gaussian sources x 8064 rows x 4096 channels, C = 4) and a chunk of
the WSClean store's shape (2,000 components within 1 deg, 30% gaussian,
8064 rows of a 4 km box x 4096 channels, C = 1). The variants are the
designs the kernel was chosen over (two buffers of sources, the next
tile staged while this one computes; the C = 4 contraction on the CUDA
cores, no register caps, the tensor cores' own accumulation, the full
rotation polynomial for every pair) and stages switched off, which no longer compute the
map: their errors against the plain version say so. A variant whose
text does not stand once in the source is not built: variant_source
raises.
Prints the card's name and power limit first.
"""

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MMA_LAUNCH = "    if constexpr (C == 4)\n        predict_kb_mma_kernel"
STAGES = "constexpr int STAGES = 1;"
MMA_CAP = "constexpr int MMA_MIN_BLOCKS = 4;"
CORE_CAP = "constexpr int CORE_MIN_BLOCKS = 4;"
TILE_SUM = "        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};\n"
TILE_ADD = "        for (int i = 0; i < 4; ++i) acc[k][i] += d[i];\n"
SMALL_MMA = "small = small && q[u][j].kind == SMALL;"
SMALL_CORE = "} else if (__all_sync(0xffffffffu, q.kind == SMALL)) {"
MMAS = ("            mma_tf32(d, rs[0], rs[1], is[0], is[1], b0b, b1b);\n"
        "            mma_tf32(d, rb[0], rb[1], ib[0], ib[1], b0s, b1s);\n"
        "            mma_tf32(d, rb[0], rb[1], ib[0], ib[1], b0b, b1b);\n")
NO_MMAS = ("            d[0] += __uint_as_float(rs[0] ^ rb[0]) + __uint_as_float(b0b ^ b0s);\n"
           "            d[1] += __uint_as_float(rs[1] ^ rb[1]) + __uint_as_float(b1b ^ b1s);\n"
           "            d[2] += __uint_as_float(is[0] ^ ib[0]);\n"
           "            d[3] += __uint_as_float(is[1] ^ ib[1]);\n")
STAGE_B = ("        stage_b<C, MMA_GROUPS>(s_b[buf], sl, b, s0, ns);\n",
           "        stage_b<C, GPB>(s_b[buf], sl, b, s0, ns);\n")
VARIANTS = {
    "kernel": [],
    "double-buffered staging": [(STAGES, "constexpr int STAGES = 2;")],
    "C = 4 on the CUDA cores": [(MMA_LAUNCH, MMA_LAUNCH.replace("C == 4", "C == 5"))],
    "C = 4 without the register cap": [(MMA_CAP, "constexpr int MMA_MIN_BLOCKS = 1;")],
    "C = 1 without the register cap": [(CORE_CAP, "constexpr int CORE_MIN_BLOCKS = 1;")],
    "C = 4 summed in the tensor cores": [
        (TILE_SUM, "        float (&d)[4] = acc[k];\n"),
        (TILE_ADD, "        for (int i = 0; i < 0; ++i) acc[k][i] += d[i];\n")],
    "the full rotation for every pair": [(SMALL_MMA, "small = false;"),
                                         (SMALL_CORE, "} else if (false) {")],
    "no tensor-core products": [(MMAS, NO_MMAS)],
    "no B staging": [(s, "        if (S < 0)" + s[7:]) for s in STAGE_B],
}


def variant_source(name, text):
    """The text of variant ``name`` of the kernel's source ``text``;
    raises where a text it replaces does not stand there once."""
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the source has not one {old!r}")
        text = text.replace(old, new)
    return text


def build(name):
    from africanus_tpu_torch.ops import _build

    text = variant_source(name, (_build.CSRC / "predict_kb.cu").read_text())
    _build.build("predict_kb", text)
    return name, text


def store_shaped(device):
    """predict_kb operands of a chunk of the WSClean store's shape, seeded."""
    import numpy as np
    import torch

    from africanus_tpu_torch.model.shape.gaussian_shape import GAUSS_SCALE
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    rng = np.random.default_rng(22)
    S, R, F = 2000, 8064, 4096
    lm = rng.uniform(-0.017, 0.017, (S, 2)).astype(np.float32)
    uvw = rng.uniform(-4000, 4000, (R, 3)).astype(np.float32)
    gauss = (rng.uniform(size=S) < 0.3)[:, None]
    freq = np.linspace(0.856e9, 1.712e9, F).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, device=device)

    u1 = rng.uniform(-50, 50, (S, R)).astype(np.float32) * gauss
    v1 = rng.uniform(-50, 50, (S, R)).astype(np.float32) * gauss
    b = rng.lognormal(size=(S, F, 1)).astype(np.complex64)
    return (phase_dot_cycles(t(lm), t(uvw)), t(u1), t(v1), t(freq),
            t((freq * GAUSS_SCALE).astype(np.float32)), t(b))


def main():
    import torch

    import chip_smoke as cs
    from africanus_tpu_torch.ops import _build
    from africanus_tpu_torch.ops import cuda_predict as cp
    from africanus_tpu_torch.rime.flagship import from_numpy

    if not torch.cuda.is_available():
        print("predict_kb_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS))

    model, x = from_numpy(cs.slice_chunks()[0], device)
    shapes = {"flagship": model.kernel_operands(x[3], x[4]),
              "store-shaped": store_shaped(device)}
    # the plain version on every row of the flagship chunk, on 512 rows of
    # the store-shaped one (2,000 sources x 8064 rows is ~7 s of it)
    rows = slice(0, 512)
    check = {"flagship": shapes["flagship"],
             "store-shaped": tuple(
                 tuple(d[:, rows].contiguous() for d in o) if isinstance(o, tuple)
                 else o[:, rows].contiguous() if i in (1, 2) else o
                 for i, o in enumerate(shapes["store-shaped"]))}
    want = {k: cp.predict_kb_reference(*o) for k, o in check.items()}

    def run(shape):
        got = cp.predict_kb(*check[shape])
        err = float((got - want[shape]).abs().max() / want[shape].abs().max())
        return cs.kernel_median_ms(lambda: cp.predict_kb(*shapes[shape])), err

    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        _build.use("predict_kb", libs[name])
        print(f"{name}: " + ", ".join(
            "{} {:.3f} ms (vs plain {:.1e})".format(k, *run(k)) for k in shapes),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
