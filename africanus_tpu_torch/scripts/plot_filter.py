#!/usr/bin/env python
"""plot-filter: plot gridding convolution filters (reference CLI parity,
docs/cmdline-utils.rst).

Port of ``africanus_tpu/scripts/plot_filter.py`` on the port's
``gridding/perleypolyhedron/kernels`` (numpy). Run it as

    python -m africanus_tpu_torch.scripts.plot_filter --output out.png

matplotlib is imported inside :func:`main`, so the module imports
without it.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description="Plots convolution filters.")
    p.add_argument("-k", "--kernel", default="kbsinc",
                   choices=["sinc", "kbsinc", "hanningsinc"])
    p.add_argument("-w", "--width", type=int, default=7,
                   help="filter support (odd)")
    p.add_argument("-o", "--oversample", type=int, default=15)
    p.add_argument("--output", default=None,
                   help="output image file (shows interactively if absent)")
    args = p.parse_args(argv)

    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from africanus_tpu_torch.gridding.perleypolyhedron import kernels

    fn = getattr(kernels, args.kernel)
    taps = kernels.uspace(args.width, args.oversample)
    k = fn(args.width, oversample=args.oversample)

    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(taps, k)
    ax.set_xlabel("tap position (cells)")
    ax.set_ylabel("filter value")
    ax.set_title(f"{args.kernel} filter, W={args.width}, "
                 f"oversample={args.oversample}")
    ax.grid(True, alpha=0.3)

    if args.output:
        fig.savefig(args.output, dpi=120, bbox_inches="tight")
        print(f"wrote {args.output}")
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
