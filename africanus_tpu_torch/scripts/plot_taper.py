#!/usr/bin/env python
"""plot-taper: plot the image-plane taper (detaper) of gridding
filters (reference CLI parity, docs/cmdline-utils.rst).

Port of ``africanus_tpu/scripts/plot_taper.py`` on the port's
``gridding/perleypolyhedron/kernels`` (numpy). Run it as

    python -m africanus_tpu_torch.scripts.plot_taper --output out.png

matplotlib is imported inside :func:`main`, so the module imports
without it.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Plots tapers associated with convolution filters."
    )
    p.add_argument("-k", "--kernel", default="kbsinc",
                   choices=["sinc", "kbsinc", "hanningsinc"])
    p.add_argument("-w", "--width", type=int, default=7)
    p.add_argument("-o", "--oversample", type=int, default=15)
    p.add_argument("-n", "--npix", type=int, default=128)
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)

    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from africanus_tpu_torch.gridding.perleypolyhedron import kernels

    fn = getattr(kernels, args.kernel)
    k = fn(args.width, oversample=args.oversample)
    taper = kernels.compute_detaper_dft_seperable(
        args.npix, k, args.width, args.oversample
    )

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    im = axes[0].imshow(taper)
    fig.colorbar(im, ax=axes[0])
    axes[0].set_title("2D taper")
    axes[1].plot(np.arange(args.npix) - args.npix // 2,
                 taper[args.npix // 2, :])
    axes[1].set_title("central cut")
    axes[1].grid(True, alpha=0.3)
    fig.suptitle(f"{args.kernel} taper, W={args.width}, "
                 f"oversample={args.oversample}")

    if args.output:
        fig.savefig(args.output, dpi=120, bbox_inches="tight")
        print(f"wrote {args.output}")
    else:
        plt.show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
