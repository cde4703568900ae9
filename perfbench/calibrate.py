"""Readings to set a cell's limits from: runs of the cell with the program
on many seeds and with the TF32 control in its place on some, in one
process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \\
        --control-seeds 11 12 13 --seconds 2 [--out readings.jsonl]

Each seed is a run of the cell (a short window at the cell's own sizes
and load), judged as every run is: the program's runs have to come out
``correct``, the control's not. One JSON line a run, on standard output
and in ``--out``: its side, ``correct`` and the numbers compared.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench import run as bench  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    runs = ([(s, False) for s in args.seeds]
            + [(s, True) for s in args.control_seeds])
    for seed, control in runs:
        res = bench.run(args.workload, seed, args.seconds, 0, control=control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "side": "control" if control else "program",
                           "correct": res["correct"],
                           "attempted": res["attempted"],
                           "numbers": {k: c["value"]
                                       for k, c in res["checks"].items()},
                           "card": res["card"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
