#!/usr/bin/env python3
"""Registers and spills of every kernel instance of csrc/dft.cu, for
several checkouts side by side, on one CUDA machine.

    python3 tools/dft_registers.py ROOT [ROOT ...]

Compiles each ROOT's africanus_tpu_torch/csrc/dft.cu as this checkout
builds its own (``-Xptxas -v``), into build/variants/, all at once, and prints one line an instance (dft_adjoint_kernel<C, MODE,
STAGE>, dft_forward_kernel<C, MODE, IMAG, STAGE>, dft_adjoint_sum;
MODE 0 direct, 1 exact, 2 residual): its registers and spill stores in
each ROOT, the first ROOT's differences marked. Ends with the instances
that spill more than in the first ROOT.
"""

import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def instances(log):
    """{instance: (registers, spill store bytes)} from a ptxas log."""
    out, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            k = re.search(r"(dft_adjoint_kernelI\w+?EE|dft_forward_kernelI\w+?EE|"
                          r"dft_adjoint_sum)", fn)
            if k:
                out[k.group(1)] = (int(m.group(1)), spill)
            fn, spill = None, 0
    return out


def build(root):
    from africanus_tpu_torch.ops import _build

    return instances(_build.build("dft", root / "africanus_tpu_torch" / "csrc" / "dft.cu")[2])


def main(argv):
    roots = [Path(r).resolve() for r in argv] or [ROOT]
    with ThreadPoolExecutor(len(roots)) as pool:
        found = list(pool.map(build, roots))
    print("instance: " + " | ".join(r.name for r in roots) + " (registers, spill bytes)")
    more = []
    for k in sorted(found[0]):
        got = [f.get(k) for f in found]
        mark = "" if len(set(got)) == 1 else "  *"
        print(f"{k}: " + " | ".join(str(g) for g in got) + mark)
        if any(g and g[1] < got[0][1] for g in got[1:]):
            more.append(k)
    print(f"spilling more in {roots[0].name} than in another root: {more or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
