#!/usr/bin/env python3
"""Times of the DFT kernels and their callers at config 5 on one CUDA card.

    python3 tools/dft_times.py [ROOT ...]

For the checkout at each ROOT (default: this one), at the config-5
selfcal step (197 antennas, 38612 rows, 16 channels of a float32
linspace, 2 correlations, 20 sources, a 64² image; chip_smoke.py's
phases 7-9 and 29), with the step's own plans:

- ``dft_adjoint`` and ``dft_forward`` alone: CUDA-event medians of 7
  replays of a CUDA graph of 10 launches, per launch (the residual image,
  C = 1; the re-predict, C = 2); and again on plans made at the step's
  delay bound / 1000 (``far``: the ``exact`` mode, every pair beyond the
  bound, so that it takes the direct phase where the kernels have the
  far-pair branch);
- ``vis_to_im`` as the step calls it and the whole step: CUDA-event
  medians of 7 calls after 2;
- ``sharded_vis_to_im`` of the data (C = 2) on 8 shards of the card, and
  ``vis_to_im`` unsharded: medians of 3 calls after 1, as phase 29 times
  them;
- H1, the float32 DFTs on a plan made for shorter baselines than the
  call's: ``im_to_vis`` and ``vis_to_im`` at 20 sources x 2000 rows x 16
  channels of a float32 linspace, uvw sigma 3 km, lm within +-0.05, C =
  2, on plans made on uvw / 1000, their errors against float64 numpy
  oracles, relative to max|out| (the DFTs' bar is 3e-6).

Each ROOT runs in its own process (its own ``build/``), in turns (the
list, then the list reversed), so that commits unpacked side by side are
timed in one call. Prints the card's name and power limit first.
"""

import subprocess
import sys
from pathlib import Path

SELFCAL = dict(nant=197, ntime=2, nchan=16, nsrc=20, ncorr=2, seed=5)
NPX, GN_ITERS, SHARDS, BURST = 64, 10, 8, 10


def event_ms(fn, reps=7, warmup=2):
    """Median CUDA-event ms of ``fn()`` after ``warmup`` calls."""
    import numpy as np
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def graph_ms(fn):
    """Per-launch ms of ``fn()``: BURST calls captured in one CUDA graph,
    the median of 7 replays."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BURST):
            fn()
    return event_ms(graph.replay) / BURST


def h1_errors():
    """(im_to_vis, vis_to_im) errors of H1's case on the card."""
    import numpy as np
    import torch

    from africanus_tpu_torch.calibration.selfcal import (
        im_to_vis_oracle_f64, vis_to_im_oracle_f64,
    )
    from africanus_tpu_torch.dft import dft_plan, im_to_vis, vis_to_im

    device = torch.device("cuda", 0)
    rng = np.random.default_rng(16)
    freq = np.linspace(0.856e9, 1.712e9, 16).astype(np.float32)
    lm = rng.uniform(-0.05, 0.05, (20, 2)).astype(np.float32)
    uvw = rng.normal(0.0, 3000.0, (2000, 3)).astype(np.float32)
    img = rng.normal(size=(20, 16, 2)).astype(np.float32)
    vis = (rng.normal(size=(2000, 16, 2))
           + 1j * rng.normal(size=(2000, 16, 2))).astype(np.complex64)
    t_lm, t_uvw = (torch.as_tensor(x, device=device) for x in (lm, uvw))
    flags = torch.zeros(vis.shape, dtype=torch.bool, device=device)
    fwd = im_to_vis(torch.as_tensor(img, device=device), t_uvw, t_lm, freq,
                    plan=dft_plan(t_uvw / 1000, t_lm, freq, 2)).cpu().numpy()
    adj = vis_to_im(torch.as_tensor(vis, device=device), t_uvw, t_lm, freq, flags,
                    plan=dft_plan(t_uvw / 1000, t_lm, freq, 2, adjoint=True)
                    ).cpu().numpy()
    want_f = im_to_vis_oracle_f64(img, uvw, lm, freq)
    want_a = vis_to_im_oracle_f64(vis, uvw, lm, freq)
    return (float(np.abs(fwd - want_f).max() / np.abs(want_f).max()),
            float(np.abs(adj - want_a).max() / np.abs(want_a).max()))


def one(root):
    """The times (ms) and H1 errors of the checkout at ``root``, in this
    process."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from africanus_tpu_torch import parallel as par
    from africanus_tpu_torch.calibration.selfcal import (
        from_numpy, grid_lm, make_data, selfcal_inputs,
    )
    from africanus_tpu_torch.dft import vis_to_im
    from africanus_tpu_torch.ops import cuda_dft as cd

    device = torch.device("cuda", 0)
    inputs = selfcal_inputs(**SELFCAL)
    inputs.update(make_data(inputs, device))
    step, data = from_numpy(inputs, device, npx=NPX, gn_iters=GN_ITERS)
    adj, fwd = step.adjoint_plan, step.forward_plan
    data_i = data.sum(dim=-1, keepdim=True).contiguous()
    far_adj, far_fwd = (cd.DftPlan(p.kind, p.lm, inputs["frequency"], p.ncorr,
                                   p.convention, p.delay_max / 1000)
                        for p in (adj, fwd))
    out = {
        "dft_adjoint": graph_ms(lambda: cd.dft_adjoint(adj, step.uvw, data_i)),
        "dft_forward": graph_ms(lambda: cd.dft_forward(fwd, step.uvw, step.image)),
        "dft_adjoint far": graph_ms(lambda: cd.dft_adjoint(far_adj, step.uvw, data_i)),
        "dft_forward far": graph_ms(lambda: cd.dft_forward(far_fwd, step.uvw,
                                                           step.image)),
        "vis_to_im": event_ms(lambda: vis_to_im(
            data_i, step.uvw, step.grid_lm, step.frequency, step.flag[..., :1],
            plan=adj)),
        "step": event_ms(lambda: step(data)),
    }
    # phase 29's cell: the data on rows padded to 8 shards
    f32 = np.float32
    pad = par.pad_rows(inputs["uvw"].shape[0], SHARDS)
    uvw = np.concatenate([inputs["uvw"], np.zeros((pad, 3), f32)])
    vis = inputs["data"][0] + 1j * inputs["data"][1]
    vis = torch.as_tensor(np.concatenate(
        [vis, np.zeros((pad,) + vis.shape[1:], vis.dtype)]), device=device)
    lm = torch.as_tensor(grid_lm(NPX), device=device).to(torch.float32)
    flags = torch.zeros(vis.shape, dtype=torch.bool, device=device)
    freq = inputs["frequency"]
    mesh = par.make_mesh((SHARDS,), ("row",), devices=[device] * SHARDS)
    uvw_d = torch.as_tensor(uvw, device=device)
    out["sharded vis_to_im 8 shards"] = event_ms(
        lambda: par.sharded_vis_to_im(mesh, vis, uvw, lm, freq, flags), 3, 1)
    out["vis_to_im unsharded"] = event_ms(
        lambda: vis_to_im(vis, uvw_d, lm, freq, flags), 3, 1)
    out["H1 im_to_vis err"], out["H1 vis_to_im err"] = h1_errors()
    return out


def main(argv):
    if argv[:1] == ["--one"]:
        print(", ".join(f"{k} {v:.3e}" if k.endswith("err") else f"{k} {v:.4f}"
                        for k, v in one(argv[1]).items()), flush=True)
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
        print(f"{root.name}: config 5 (ms; H1 errors of max) {proc.stdout.strip()}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
