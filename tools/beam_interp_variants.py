#!/usr/bin/env python3
"""Where beam_interp's time goes at config 3, on one CUDA card.

    python3 tools/beam_interp_variants.py

Builds variants of africanus_tpu_torch/csrc/beam.cu, each with one stage
of beam_interp switched off or done another way (text substitutions of
the source), as the port builds the source, into build/variants/, and times
each on the three routes of config 3's beam chain (chip_smoke.BEAM: the
general route's 512 samples x 4096 channels, the channel-invariant and
the cell-corner launches), in turns (the list, then the list reversed),
as chip_smoke.py times a kernel (a CUDA graph of 10 launches). Then the
layout: rows a block and samples a thread on the general route, sample
lanes on the small launches. Prints the card's name and power limit
first; the variants' errors against the plain version show which of
them still compute the map.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LOAD = "    load<N>(src, v);\n"
NORM = "            normalise<T, C>(acc, e);\n"
STORE = "            store<2 * C, true>(out + o * (2 * C), e);\n"
ACC = ("    for (int q = 0; q < N; ++q) acc[q] = FIRST ? mul_rn(w, v[q]) : "
       "add_rn(acc[q], mul_rn(w, v[q]));\n")
MINB = "constexpr int INTERP_MIN_BLOCKS = 4;"
CS_STORES = "            store<2 * C, true>(out + o * (2 * C), e);\n"
CS_COORDS = "        const T l = __ldcs(vl + s * ncol + col), m = __ldcs(vm + s * ncol + col);\n"
CONSTANTS = "#pragma unroll\n    for (int q = 0; q < N; ++q) v[q] = T(q + 1);\n"
NO_NORM = "#pragma unroll\n            for (int q = 0; q < 2 * C; ++q) e[q] = acc[q];\n"
NO_STORE = ("            if (e[0] == T(12345.678))\n"
            "                store<2 * C, true>(out + o * (2 * C), e);\n")
# corners read from a 4 KB shared array at the same offsets (mod 1024
# values): what a staged box would cost to read, not the map
SHARED = """    __shared__ __align__(16) T box[1024 + 16];
    const T* p = box + ((reinterpret_cast<size_t>(src) / sizeof(T)) & 1023);
    if constexpr (sizeof(T) == 4 && N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
            const float4 q = reinterpret_cast<const float4*>(p)[i];
            v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < N; ++q) v[q] = p[q];
    }
"""
VARIANTS = {
    "kernel": [],
    "no corner loads": [(LOAD, CONSTANTS)],
    "no normalisation": [(NORM, NO_NORM)],
    "no stores": [(STORE, NO_STORE)],
    "no loads, no normalisation": [(LOAD, CONSTANTS), (NORM, NO_NORM)],
    "no loads, no stores": [(LOAD, CONSTANTS), (STORE, NO_STORE)],
    "corners from shared memory": [(LOAD, SHARED)],
    "scalar corner loads": [(LOAD, "#pragma unroll\n    for (int q = 0; q < N; ++q) "
                                   "v[q] = __ldg(src + q);\n")],
    "FMAs": [(ACC, "    for (int q = 0; q < N; ++q) acc[q] = FIRST ? w * v[q] : "
                   "fma(w, v[q], acc[q]);\n")],
    "2 blocks an SM (128 registers)": [(MINB, "constexpr int INTERP_MIN_BLOCKS = 2;")],
    "3 blocks an SM (80 registers)": [(MINB, "constexpr int INTERP_MIN_BLOCKS = 3;")],
    "5 blocks an SM (48 registers)": [(MINB, "constexpr int INTERP_MIN_BLOCKS = 5;")],
    "cached stores": [(CS_STORES, "            store<2 * C>(out + o * (2 * C), e);\n")],
    "cached coordinates": [(CS_COORDS, "        const T l = vl[s * ncol + col], "
                                       "m = vm[s * ncol + col];\n")],
}
# (rows, lanes, samples a thread) of the general route, then sample lanes
# of the small launches
GENERAL = [(256, 1, 1), (256, 1, 2), (256, 1, 4), (256, 1, 8), (128, 1, 8), (64, 1, 8)]
SMALL = [1, 2, 4, 8]


def build(name):
    from africanus_tpu_torch.ops import _build

    text = (_build.CSRC / "beam.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: the source has no {old!r}")
        text = text.replace(old, new)
    _build.build("beam", text)
    return name, text


def main():
    import torch

    import chip_smoke as cs
    from africanus_tpu_torch.ops import _build
    from africanus_tpu_torch.ops import cuda_beam as cb
    from africanus_tpu_torch.rime.beam_chain import beam_inputs, from_numpy

    if not torch.cuda.is_available():
        print("beam_interp_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS))

    args = beam_inputs(**cs.BEAM)
    pc = dict(args, pe=args["pe_pc"])
    legs = {"general": from_numpy(pc, device, feed_type=None, chan_invariant=False,
                                  cell_residual=False),
            "chan-invariant": from_numpy(args, device),
            "cell corners": from_numpy(pc, device, feed_type=None, chan_invariant=False,
                                       cell_residual=True)}
    ops = {r: m.kernel_operands(pa)[1]["beam_interp"] for r, (m, pa) in legs.items()}
    want = {r: cb.beam_interp_reference(*o) for r, o in ops.items()}

    def run(route):
        got = cb.beam_interp(*ops[route])
        err = float((got - want[route]).abs().max() / want[route].abs().max())
        return cs.kernel_median_ms(lambda: cb.beam_interp(*ops[route])), err

    print(f"empty kernel {cs.kernel_median_ms(lambda: torch.cuda._sleep(0)):.4f} ms",
          flush=True)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        _build.use("beam", libs[name])
        print(f"{name}: " + ", ".join(
            "{} {:.4f} ms (vs plain {:.1e})".format(r, *run(r)) for r in ops), flush=True)

    _build.use("beam", libs["kernel"])
    layout = cb.interp_layout
    for route, cases in (("general", GENERAL), ("chan-invariant", SMALL),
                         ("cell corners", SMALL)):
        base = layout(*want[route].shape[:2], ops[route][6], cb._sm_count(0))
        for case in cases:
            rows, lanes, spt = case if route == "general" else (base.rows, case, 1)
            if base.parts * rows * lanes > cb._INTERP_THREADS:
                continue
            cb.interp_layout = lambda n, r, norm, sms, rows=rows, lanes=lanes, spt=spt: (
                cb.InterpLayout(base.parts, rows, lanes, spt,
                                (-(-n // (lanes * spt)), -(-r // rows))))
            print("layout {} rows {} lanes {} spt {}: {:.4f} ms (vs plain {:.1e})".format(
                route, rows, lanes, spt, *run(route)), flush=True)
    cb.interp_layout = layout
    return 0


if __name__ == "__main__":
    sys.exit(main())
