#!/usr/bin/env python3
"""Where the DFT kernels' time goes, on one CUDA card.

    python3 tools/dft_variants.py

Builds variants of africanus_tpu_torch/csrc/dft.cu (text substitutions of
the source) as the port builds the source, into build/variants/, and
times each in turns (the list, then the list reversed), as chip_smoke.py
times a kernel (a CUDA graph of 10 launches), at the config-5 selfcal
step's shapes with the step's plans: dft_adjoint on the residual image
(4096 pixels x 38612 rows x 16 channels, C = 1) and dft_forward on the
re-predict (20 sources, C = 2), and dft_adjoint on the data (C = 2, as
phase 29's sharded vis_to_im takes it). The variants are other launch bounds,
tiles and row chunks (a host setting of ops/cuda_dft.py, beside the
source's), Dekker's split-and-multiply for each product error (the
operands split per pair: an upper bound on what it costs beside the FMA),
the rotation polynomial for every pair, the kernels without the far-pair
vote (the direct phase for pairs beyond the plan's delay bound), with
it in every tile of rows or sources (not only where a pair may be far;
there the residual mode's near pairs take the polynomial), and in one
loop for every pair with both votes (what the vote in the pair loop
costs where no pair is far, as at config 5), and stages switched off, which
no longer compute the map: their errors against the plain
version say so. A variant whose text does not stand once in the source
is not built: variant_source raises. Each variant's registers and spills
(ptxas) for the two kernels timed are printed with its times.
Prints the card's name and power limit first.
"""

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ADJ_CAP = "constexpr int ADJ_MIN_BLOCKS = 6;"
FWD_CAP = "constexpr int FWD_MIN_BLOCKS = 4;"
ADJ_ROWS = "constexpr int ADJ_ROWS = 32;"
FWD_SRCS = "constexpr int FWD_SRCS = 16;"
PROD_ERR = "    return __fmaf_rn(a, b, -p);\n"
DEKKER = ("    const float ca = __fmul_rn(a, 4097.0f), cb = __fmul_rn(b, 4097.0f);\n"
          "    const float ah = __fsub_rn(ca, __fsub_rn(ca, a)), al = __fsub_rn(a, ah);\n"
          "    const float bh = __fsub_rn(cb, __fsub_rn(cb, b)), bl = __fsub_rn(b, bh);\n"
          "    float e = __fsub_rn(__fmul_rn(ah, bh), p);\n"
          "    e = __fadd_rn(e, __fmul_rn(ah, bl));\n"
          "    e = __fadd_rn(e, __fmul_rn(al, bh));\n"
          "    return __fadd_rn(e, __fmul_rn(al, bl));\n")
SMALL = "    else if (!FAR && __all_sync(FULL_MASK, fabsf(hi) <= delay_small))\n"
FAR_ADJ = "            if (__any_sync(FULL_MASK, far_rows))\n"
FAR_FWD = "            if (__any_sync(FULL_MASK, far_sources))\n"
WALK_SMALL = "        walk<CG, ROT_SMALL>(z, st, hi, rot, body);\n"
SINCOS = "    sincospif(2.0f * frac, &z.y, &z.x);  // 2*frac is exact\n"
ADJ_UNROLL = "#pragma unroll ((C == 1 && !decltype(far)::value) ? 2 : 1)\n"
FWD_LOOP = "            for (int ls = slice; ls < ns; ls += nslice) {\n"
DELAY_ADJ = "        delay(d, s_row[lr], chi, clo, hi, lo);\n"
DELAY_FWD = "        delay(tile.dir[ls], q, chi, clo, hi, lo);\n"
# variant name -> (substitutions of the source, settings of ops/cuda_dft.py)
VARIANTS = {
    "kernel": ([], {}),
    "adjoint at 4 blocks an SM": ([(ADJ_CAP, ADJ_CAP.replace("6", "4"))], {}),
    "adjoint at 5 blocks an SM": ([(ADJ_CAP, ADJ_CAP.replace("6", "5"))], {}),
    "adjoint at 7 blocks an SM": ([(ADJ_CAP, ADJ_CAP.replace("6", "7"))], {}),
    "adjoint at 8 blocks an SM": ([(ADJ_CAP, ADJ_CAP.replace("6", "8"))], {}),
    "adjoint rows of 64 a pass": ([(ADJ_ROWS, ADJ_ROWS.replace("32", "64"))], {}),
    "adjoint rows one at a time": ([(ADJ_UNROLL, "#pragma unroll 1\n")], {}),
    "adjoint rows two at a time": ([(ADJ_UNROLL, "#pragma unroll 2\n")], {}),
    "adjoint chunks for 2048 blocks": ([], {"_TARGET_BLOCKS": 2048}),
    "adjoint chunks for 8192 blocks": ([], {"_TARGET_BLOCKS": 8192}),
    "forward at 3 blocks an SM": ([(FWD_CAP, FWD_CAP.replace("4", "3"))], {}),
    "forward at 2 blocks an SM": ([(FWD_CAP, FWD_CAP.replace("4", "2"))], {}),
    "forward at 5 blocks an SM": ([(FWD_CAP, FWD_CAP.replace("4", "5"))], {}),
    "forward sources of 16 a pass": ([(FWD_SRCS, FWD_SRCS.replace("16", "8"))], {}),
    "forward sources two at a time": ([(FWD_LOOP, "#pragma unroll 2\n" + FWD_LOOP)], {}),
    "product errors by Dekker's split": ([(PROD_ERR, DEKKER)], {}),
    "the rotation polynomial for every pair": ([(SMALL, "    else if (false)\n")], {}),
    "no far vote": ([(FAR_ADJ, "            if (false)\n"),
                     (FAR_FWD, "            if (false)\n")], {}),
    "the far vote in every tile": ([(FAR_ADJ, "            if (true)\n"),
                                    (FAR_FWD, "            if (true)\n")], {}),
    "one loop, the far vote a pair": ([
        (FAR_ADJ, "            if (true)\n"), (FAR_FWD, "            if (true)\n"),
        (SMALL, "    else if (__all_sync(FULL_MASK, fabsf(hi) <= delay_small))\n")], {}),
    "no channel walk (not the map)": ([(WALK_SMALL, "        body(0, z);\n")], {}),
    "no sincospif (not the map)": ([(SINCOS, "    z = make_float2(frac, 1.0f - frac);\n")], {}),
    "no delay chain (not the map)": ([
        (DELAY_ADJ, "        hi = (d.l * s_row[lr].x + d.m * s_row[lr].y) * chi; lo = 0.0f;\n"),
        (DELAY_FWD, "        hi = (tile.dir[ls].l * q.x + tile.dir[ls].m * q.y) * chi; lo = 0.0f;\n")],
        {}),
}
# the kernels timed (their ptxas names): the config-5 step's, and the
# adjoint of its data at C = 2 (phase 29's sharded vis_to_im)
TIMED = {"dft_adjoint": "dft_adjoint_kernelILi1ELi2ELb0E",
         "dft_adjoint/2": "dft_adjoint_kernelILi2ELi2ELb0E",
         "dft_forward": "dft_forward_kernelILi2ELi2ELb0ELb0E"}


def variant_source(name, text):
    """The text of variant ``name`` of the kernels' source ``text``;
    raises where a text it replaces does not stand there once."""
    for old, new in VARIANTS[name][0]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: the source has not one {old!r}")
        text = text.replace(old, new)
    return text


def registers(log):
    """{timed kernel: 'registers, spill stores'} from a ptxas log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = next((k for k, v in TIMED.items() if v in m.group(1)), None)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = f"{m.group(1)} regs, {spill} B spilled"
            fn = None
    return ", ".join(f"{k} {v}" for k, v in out.items())


def build(name):
    from africanus_tpu_torch.ops import _build

    text = variant_source(name, (_build.CSRC / "dft.cu").read_text())
    return name, (text, registers(_build.build("dft", text)[2]))


def main():
    import torch

    import chip_smoke as cs
    from africanus_tpu_torch.calibration.selfcal import (
        from_numpy, make_data, selfcal_inputs,
    )
    from africanus_tpu_torch.dft import dft_plan
    from africanus_tpu_torch.ops import _build
    from africanus_tpu_torch.ops import cuda_dft as cd

    if not torch.cuda.is_available():
        print("dft_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, VARIANTS))

    inputs = selfcal_inputs(seed=cs.SELFCAL_SEED, **cs.SELFCAL)
    inputs.update(make_data(inputs, device))
    step, data = from_numpy(inputs, device, npx=cs.SELFCAL_NPX)
    adj, fwd = step.adjoint_plan, step.forward_plan
    data_i = data.sum(dim=-1, keepdim=True).contiguous()
    adj2 = dft_plan(step.uvw, step.grid_lm, step.frequency, 2, adjoint=True)
    calls = {"dft_adjoint": (cd.dft_adjoint, cd.dft_adjoint_reference,
                             (adj, step.uvw, data_i)),
             "dft_adjoint/2": (cd.dft_adjoint, cd.dft_adjoint_reference,
                               (adj2, step.uvw, data)),
             "dft_forward": (cd.dft_forward, cd.dft_forward_reference,
                             (fwd, step.uvw, step.image))}
    want = {k: plain(*ops) for k, (_, plain, ops) in calls.items()}
    defaults = {k: getattr(cd, k) for v in VARIANTS.values() for k in v[1]}

    def run(name):
        fn, _, ops = calls[name]
        err = float((fn(*ops) - want[name]).abs().max() / want[name].abs().max())
        return cs.kernel_median_ms(lambda: fn(*ops)), err

    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        text, regs = libs[name]
        _build.use("dft", text)
        for k, v in {**defaults, **VARIANTS[name][1]}.items():
            setattr(cd, k, v)
        print(f"{name}: " + ", ".join(
            "{} {:.4f} ms (vs plain {:.1e})".format(k, *run(k)) for k in calls)
            + f"; {regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
