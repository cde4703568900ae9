#!/usr/bin/env python3
"""Times of im_to_vis at 4096 channels (predict_kb's route) on one CUDA card.

    python3 tools/im_to_vis_times.py [ROOT ...]

For the checkout at each ROOT (default: this one), at the flagship chunk
(100 sources, 64 antennas x 4 dumps = 8064 rows, 4096 channels of a
float32 linspace handed over as a host array, 4 correlations), as
chip_smoke.py's phase 29 takes them: CUDA-event medians of 5 calls after
a warm-up of im_to_vis, and of sharded_im_to_vis on 8 shards of the
card and on the card as a one-device mesh. Each ROOT runs in its own
process, in turns (the list, then the list reversed), so that commits
unpacked side by side are timed in one call. Prints the card's name and
power limit first.
"""

import subprocess
import sys
from pathlib import Path

SHARDS, REPS = 8, 5


def one(root):
    """The three times (ms) of the checkout at ``root``, in this process."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from africanus_tpu_torch import parallel as par
    from africanus_tpu_torch.dft import im_to_vis
    from africanus_tpu_torch.rime.flagship import flagship_inputs, from_numpy

    device = torch.device("cuda", 0)
    args = flagship_inputs(100, 4, 64, 4096, 2026)
    model, x = from_numpy(args, device)
    b = model.kernel_operands(x[3], x[4])[-1]
    lm = torch.as_tensor(args[3], device=device)
    uvw, freq = x[3], args[5]
    meshes = {"8 shards": par.make_mesh((SHARDS,), ("row",), devices=[device] * SHARDS),
              "the card": par.make_mesh()}
    calls = {k: (lambda m=m: par.sharded_im_to_vis(m, b, uvw, lm, freq))
             for k, m in meshes.items()}
    calls["unsharded"] = lambda: im_to_vis(b, uvw, lm, freq)
    out = {}
    for name, fn in calls.items():
        fn()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        out[name] = float(np.median(times))
    return out


def main(argv):
    if argv[:1] == ["--one"]:
        print(", ".join(f"{k} {v:.3f}" for k, v in one(argv[1]).items()), flush=True)
        return 0
    roots = [Path(r).resolve() for r in argv] or [Path(__file__).resolve().parents[1]]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--one", str(root)],
                              capture_output=True, text=True)
        if proc.returncode:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        print(f"{root.name}: im_to_vis at 4096 chan (ms) {proc.stdout.strip()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
