#!/usr/bin/env python3
"""Registers and spills of every compensated kernel instance of
csrc/predict_kb.cu, for several checkouts side by side, on one CUDA
machine.

    python3 tools/predict_kb_registers.py ROOT [ROOT ...]

Compiles each ROOT's africanus_tpu_torch/csrc/predict_kb.cu as this
checkout builds its own (``-Xptxas -v``), into build/variants/, all at
once, and prints one line an instance (predict_kb_mma_kernel at C = 4,
predict_kb_kernel at C = 1, 2; MODE 0 direct, 1 exact, 2 residual; ENV
the envelope; GAINS the DIE gains in the store, 0 in a source without
that flag): its registers and spill store bytes in each ROOT, the
differences marked. Ends with the instances that spill more in the first
ROOT than in another.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def build(root):
    from chip_smoke import predict_kb_instances
    from africanus_tpu_torch.ops import _build

    src = root / "africanus_tpu_torch" / "csrc" / "predict_kb.cu"
    return predict_kb_instances(_build.build("predict_kb", src)[2])


def main(argv):
    roots = [Path(r).resolve() for r in argv] or [ROOT]
    with ThreadPoolExecutor(len(roots)) as pool:
        found = list(pool.map(build, roots))
    print("kernel, C, MODE, ENV, GAINS: " + " | ".join(r.name for r in roots)
          + " (registers, spill bytes)")
    more = []
    for k in sorted(set().union(*found)):
        got = [f.get(k) for f in found]
        mark = "" if len(set(got)) == 1 else "  *"
        print(f"{k}: " + " | ".join(str(g) for g in got) + mark)
        if got[0] and any(g and g[1] < got[0][1] for g in got[1:]):
            more.append(k)
    print(f"spilling more in {roots[0].name} than in another root: {more or 'none'}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
