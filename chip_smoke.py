#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (africanus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths — the flagship RIME predict at a MeerKAT-64
full-band size, one config-5 selfcal step at SKA-mid width, config-4
w-stacked imaging, the config-3 beam DDE chain, the nifty-API gridder,
the Perley-polyhedron facet gridder, the averagers (BDA and
time-and-channel), the fused RIME, the WSClean predict from an MS-shaped
store to MODEL_DATA, the sky-model terms (Zernike DDEs, shapelets,
SPI fitting), the application layer (GP phase gains, the examples) and
the sharded entry points over a device mesh — and checks them, in
twenty-nine phases that each print one line (some several):

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles csrc/predict_kb.cu, csrc/dft.cu, csrc/wgrid.cu,
   csrc/beam.cu, csrc/grid2d.cu, csrc/gridtab.cu and csrc/hogbom.cu with
   nvcc, and the
   averaging mappers' native/mappers.cpp with g++, into build/ (first
   use), all at once;
3. predict kernel vs plain: predict_kb against its plain PyTorch version
   on the card (the plan's three phase modes × corr 1/2/4 × compensated
   and plain × envelope and point sources at a ragged shape; a prime
   channel count, one channel, groups of 10; source-row pairs beyond the
   plan's delay bound at corr 1/2/4, in the first tile of sources and in
   a later one), and against a float64 oracle at 1e4 rad phases;
4. DFT kernels vs plain: dft_forward and dft_adjoint against their plain
   versions on the card (three phase modes × corr 1/2/4 × both
   conventions × real and complex sky, ragged shapes), two launches
   bitwise equal, three correlations as 2 + 1 launches of each DFT
   kernel and of predict_kb, and im_to_vis's ≥ 128-channel route through
   predict_kb against the CPU;
5. the flagship: FlagshipPredict over 3 row chunks of 4 time steps
   (64 antennas, 2016 baselines, 8064 rows, 4096 channels 0.856-1.712
   GHz, 4 correlations, 100 gaussian sources), counting the predict
   kernel's launches and checking windows of every chunk against a
   float64 oracle;
6. flagship times: CUDA-event medians of the kernel (beside its bound
   and the previous design's time) and of the whole forward at that
   shape, one forward under set_sync_debug_mode("error"), two kernel
   runs bitwise equal, and one run of the plain version;
7. the selfcal step (bench.py config 5): SelfcalStep at 197 antennas
   (19306 baselines), 2 times (38612 rows), 16 channels, 2
   correlations, 20 sources, 10 Gauss-Newton iterations, a 64² residual
   image, counting the DFT kernels' and CLEAN's launches;
8. selfcal checks: a 40-iteration solve against the true gains, and
   vis_to_im (64 pixels) and im_to_vis (256 rows) of the slice against
   float64 oracles;
9. selfcal times: CUDA-event medians of each DFT kernel at the step's
   shapes (with the step's plans, launches captured into a CUDA graph
   and replayed, so that no host work is timed), of vis_to_im and
   im_to_vis as the step calls them, of the solve, of CLEAN and of the
   whole step (and the step's host-clock median: it is host-bound), one
   run of each plain version, and the step's rate in Mvis-iter/s; CLEAN's
   kernel equal to the plain loop on the step's dirty image and PSF, and
   timed alone as the DFT kernels are;
10. wgrid kernels vs plain: grid_wstack and degrid_wstack against their
   plain versions on the card (supports 4/6/8/10 × 1 plane, a stack and a
   deep stack whose planes the degrid kernel stages in blocks × float32
   and float64 × square, odd, one-tile and narrower-than-the-window
   grids, ragged sample counts, windows that wrap, windows over the tile
   corners and in a tile's last cells, w-windows at both ends of the
   stack), and two launches bitwise equal (also the degrid in blocks of
   planes);
11. config-4 imaging (bench.py:879-1013): WStackImaging at 100,000 rows ×
   8 channels, a 512² image over 1°, ε = 1e-4, w-stacking on — the plan
   cold and cached, the launches through dirty and degrid, kernel vs
   plain on the whole dirty image and the degridded visibilities,
   adjointness, and the bench's explicit-DFT check;
12. imaging times: CUDA-graph replays of the grid kernel (one launch, no
   fold) and the degrid kernel (the tile gather, beside the previous
   design's time), CUDA-event medians of dirty and degrid
   (Mvis/s), the FFTs' share, one run of each plain version, peak device
   memory, a
   torch.profiler breakdown, and dirty and degrid again at a larger cell
   (1,000,000 rows × 8 channels, a 1024² image, w extent widened to
   ≥ 16 planes), its kernels held against their plain versions first;
13. beam kernels vs plain: beam_interp, beam_blend and beam_blend_cell
   against their plain versions on the card (corr 1/2/4, and 3 and 8 as
   2 + 1 and 4 + 4 launches, × float32 and float64 × normalised and raw ×
   no, linear and circular feeds, ragged sample and channel counts,
   frequencies outside the cube; beam_interp also on one row),
   corner values exact (also on the cell-corner layout), and two launches
   bitwise equal (beam_interp on its three layouts);
14. config 3 (bench.py:677-875) at full width through BeamDDEChain:
   MeerKAT-64, 4096 channels, 8 sources, 1 time, a 129² × 8 × 4 cube —
   the chan-invariant E·F leg against the bench's float64 oracle, the
   time-varying-pointing leg against the general route, and the
   per-channel pointing legs on the general and cell-residual routes
   (their difference, and the cell route on in-cell samples), each leg's
   launches counted;
15. beam times: CUDA-graph replays of the three kernels at the legs'
   shapes with their bounds (beam_interp on each of its three routes,
   held against its plain version, beside an empty kernel and the
   previous design's recorded times) and the grid_sample yardstick,
   CUDA-event
   medians of each leg (Msamples/s), one run of each plain version, peak
   device memory and a torch.profiler breakdown of each leg;
16. gridder kernels vs plain: grid_2d and degrid_2d (supports 4/6/8/10 ×
   corr 1/2/3/4 — 3 as one grid and 2 + 1 degrid launches — × square,
   odd, one-tile and narrower-than-the-window grids, edge-wrapping
   windows, windows over tile corners and in a tile's last cells) and
   grid_table and degrid_table (odd supports 3/5/7/15/17/29/31 ×
   oversampling 5 and 63 × 2 bands, windows off every edge, samples with
   no in-grid tap; complex128 at W 15, oversampling 1023, the table read
   from device memory) against their plain versions in float32 and
   float64, and two launches bitwise equal (also the table pair at W 29
   and 31 in float64); and the Perley-polyhedron gridder's
   conv_nn_scatter route (100,000 rows × 4 channels onto 2 × 32² cells,
   an accumulating index_put_) against the CPU in complex64 and
   complex128, two card runs bitwise equal;
17. both gridders at full width: nifty grid → dirty and model → degrid
   at config 4's draws (100,000 rows × 8 channels × 4 correlations, a
   1024² image, 2048² grids, ε 1e-5: W = 8), launches counted, kernels
   vs plain on the whole outputs, adjointness, and the float64 dirty of
   tests/test_nifty.py's problem against the explicit DFT; the PP facet
   gridder and degridder (the draws at 2048², 2 correlations into 2
   bands, kbsinc W 7 × 63 packed, the image centre 0.5° off, rotate +
   phase_rotate) on plans made once, launches counted, kernels vs plain
   and the table pair's adjoint identity;
18. gridder times: CUDA-graph replays of the four kernels (grid_2d and
   grid_table one launch each, no fold; degrid_2d and degrid_table the
   tile gather) with
   their bounds and the previous designs' times, CUDA-event medians of
   nifty grid + dirty and model + degrid and of the PP gridder and
   degridder (Mvis/s), one run of each plain version, peak device memory
   and a torch.profiler breakdown of each;
19. the averagers: the C++ binner must have loaded; bda and time_and_channel (16 s × 4 channels) at the bench cell
   (bench.py:1018-1038: 300 baselines × 60 dumps, 64 channels, 4
   correlations, fixed uvw, visibilities on the card) against the same
   calls on the CPU and two card runs bitwise equal; at MeerKAT-64 1K
   (2016 baselines × 16 dumps of 8 s with Earth rotation, 1024 channels,
   4 correlations, weight and sigma spectra, 2% of rows flagged) the
   mapper and the CSR tables timed cold, each call's peak allocation above
   its resident inputs (≤ 4× their bytes), two runs bitwise equal, the
   preserved weighted totals, and a 256-baseline subset against the CPU;
20. the fused RIME at the flagship's chunk (8064 rows × 4096 channels × 4
   correlations, 100 gaussian sources) on its kernel route (csrc/
   fused_dde.cu), each call with no source block, so in the block the
   library chooses from the free memory read with the state (the route's
   bytes estimate at most the free memory's share, the next larger even
   block beyond it, the measured peak within the estimate, one fused_pairs
   and one fused_dde launch a block):
   (Kpq, Gpq, Bpq) against the float64 oracle on windows; [Ep, (Kpq, Gpq,
   Bpq), Eq] on config 3's cube with its beam_interp and beam_blend
   launches counted (one of each per block: E sampled once for both
   sides), a window against the CPU, and two block sizes against each
   other; and the benchmark cell meerkat64pb.beam100's chunk, [Ep, Lp,
   Kpq, Gpq, Bpq, Lq, Eq] on its 257² × 33 analytic 2×2 cube, launches
   counted, kept rows against the cell's float64 reference at the cell's
   limit, beam_interp and beam_blend against their plain versions on a
   source block's operands of that chunk, fused_pairs alone on the
   chunk's sources and rows equal to its plain version, and fused_dde
   alone on the chunk's operands against its plain version, each timed
   beside its bound (fused_dde's from perfbench/work/fused_dde.py) and the
   plain version's time;
21. slice times: CUDA-event and host-clock medians of both averagers at
   both cells (Mvis/s), the mapper's and the tables' cold seconds, the
   fused RIME per chunk (Mvis/s), peak device memory and a
   torch.profiler breakdown of each.
22. the WSClean store path through its entry point,
   predict_to_ms_store: an MS-shaped store at MeerKAT-64 full band (64
   antennas, 16 dumps of 8 s with Earth rotation: 32,256 rows, 4096
   channels, 1 correlation; MODEL_DATA 1.06 GB) in a temporary directory,
   a seeded WSClean list of 2,000 components written as text and parsed,
   4 chunks of 8064 rows, predict_kb launched once a chunk (counted), a
   window of 256 rows × 16 channels of every chunk against a float64
   oracle, MODEL_DATA re-read through a fresh handle bitwise equal to the
   prediction, the kernel against its plain version on 512 rows; the
   kernel's time a chunk (beside its bound and the previous design's
   time), each chunk's host-clock read, predict, copy and
   write seconds, the pipeline's Mvis/s with IO, peak device memory;
23. the Zernike DDE at 100 sources × 4 times × 64 antennas × 4096
   channels × 2x2 correlations, 20 Noll terms, against the CPU in
   float64 on 2 sources × 1 time, its time and peak (< 40 GB);
24. shapelet and shapelet_with_w_term at the MeerKAT-64 chunk (8064 rows
   × 4096 channels, 4 sources, nmax 8×8), 64 rows against the CPU in
   float64, times and peaks;
25. the SPI fit of 1,048,576 components × 8 bands (maxiter 100) in
   float64 and float32 against the true spectral indices and, on 4096
   components, the CPU in float64; ms a call and the iterations run;
26. GP phase gains through examples.generate_gains.gp_phase_gains at 64
   antennas × 256 times × 4096 channels × 16 directions (factors 256²,
   4096², 16²; 9.38 TFLOP a call) in float64 and float32: each factor's
   ‖LLᵀ − K‖/‖K‖, antenna 0's draw against the CPU on the same draws,
   float32 against float64, ||g| − 1|; ms, TFLOP/s against the dense
   peak, peak device memory (< 60 GB);
27. the two store examples at the MeerKAT-64 1K geometry (32,256 rows ×
   1024 channels × 1 correlation) in a temporary directory:
   selfcal_ms_store with 20 sources (fabricate, read, solve, write,
   image, CLEAN seconds; the image again on its cached plan and its
   grid_wstack kernel alone) and apply_phase_screen_ms_store with 3
   directions in float64, each example's bound on the gain products, the
   written columns re-read bitwise, launches and peaks;
28. the other ten examples on the card through their library functions:
   predict_dft at config 1, make_dirty at 1024² from 1M rows × 4
   channels, spi_fitter_cube with --beammodel on an 8-band 4096² cube of
   10,000 components (α at their pixels against the truth), and
   selfcal, apply_gains, custom_rime_term, predict_wsclean,
   predict_shapelet, predict_from_fits and fit_spi at the JAX examples'
   defaults, each example's check (or the card against the CPU), its
   launches and seconds;
29. the sharded paths (africanus_tpu_torch.parallel) on a mesh of 8 shards
   of the card ([cuda:0] * 8) and on the default make_mesh() (the card
   alone), each against the unsharded call: sharded_im_to_vis and
   sharded_vis_to_im at config 1 (100 sources, KAT-7 x 96 dumps = 2016
   rows, 64 channels) and at the config-5 shape (38612 rows padded to
   38616), 1e-6 of max and the DFT's 3e-6; sharded_rime_predict at the
   flagship chunk in float64 on a (4, 2) row x chan mesh against one
   shard (1e-10) and predict_kb (5e-6), and sharded_im_to_vis there
   (predict_kb a shard); config-4 dirty, PSF, degrid and residual on one
   geometry planned from the full uvw (1e-5), grid_wstack 8 launches a
   dirty image; the PP facet gridder and degridder (1e-5); config-5
   residual_vis (rtol 1e-12) and gauss_newton (gain products 1e-8) on 2
   shards of its 2 time bins; bda and time_and_channel at MeerKAT-64 1K
   on 8 shards of 2 dumps, each shard bitwise its averager's call on its
   rows, padding inert, peak memory; the config-3 chan-invariant E·F leg
   on 4 channel shards (rtol 1e-5, atol 1e-6); one shard of each kernel
   against its plain version; the sums and the shards rerun bitwise; the
   sharded calls' launches counted; CUDA-event medians beside the
   unsharded calls' (on one card the shards run one after another: the
   cost of sharding, no speed-up).

Every failed check raises, so the exit code is non-zero; there is no
CPU fallback. Before the last line it prints one JSON object about the
kernels; the last line is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Run it from a checkout of the repository: it imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from africanus_tpu_torch.utils.profiling import FP32_RATE, HBM_RATE, TF32_PEAK_FLOPS

SEED = 2026
NSRC, NTIME, NANT, NCHAN, NCORR = 100, 4, 64, 4096, 4
NCHUNK = 3
JAX_CONFIG2_ERR = 2.30e-6  # the JAX package's f32 accuracy at config 2 (BENCH_r05.json)

# config 5 (bench.py:1092-1143): SKA-mid width, one step
SELFCAL = dict(nant=197, ntime=2, nchan=16, nsrc=20, ncorr=2)
SELFCAL_SEED, SELFCAL_NPX, SELFCAL_GN_ITERS = 5, 64, 10
DFT_BOUND = 3e-6  # tests/test_dft.py:322,363, relative to max|out|
BURST = 10  # launches of a kernel per timed CUDA-graph replay

# config 4 (bench.py:879-1013) and the larger cell of ROADMAP item 14:
# 1M rows x 8 chan, 1024², the w extent widened from umax/20 to umax/2
# so that the stack holds >= 16 planes
IMAGING = dict(nrow=100_000, nchan=8, nx=512, seed=4)
IMAGING_LARGE = dict(nrow=1_000_000, nchan=8, nx=1024, seed=4, w_div=2)
IMAGING_EPS = 1e-4
# wgrid kernels vs plain, relative to max|out|: f32 sums in another order
# than index_add_'s
WGRID_BOUND = 1e-5
# config 3 (bench.py:677-875): MeerKAT-64, 4096 channels, the bench's draws
BEAM = dict(nant=64, nchan=4096, seed=3)
# beam kernels vs plain, relative to max|out|: f32 operations in another
# order (FMA contraction); the chain vs the f64 oracle: the bench's bar
BEAM_BOUND, BEAM_BOUND_F64 = 1e-5, 1e-12
BEAM_ORACLE_CHANS = 256  # the oracle's channel window (all 512 samples)
JAX_CONFIG3 = "4.51e-7 vs f64, cell-vs-general 6.4e-3"  # TPU v5e, BENCH_r05.json
# the nifty-API gridder at full width: config 4's draws at a 1024² image
# (2048² grids), 4 correlations, eps 1e-5 (W = 8, the JAX package's MXU
# route); the Perley-polyhedron facet gridder: the draws at 2048², 2
# correlations into 2 bands of 4 channels, the image centre 0.5 deg from
# the phase centre
NIFTY = dict(nrow=100_000, nchan=8, nx=1024, seed=4)
NIFTY_NCORR, NIFTY_EPS = 4, 1e-5
FACET = dict(nrow=100_000, nchan=8, nx=2048, seed=4)
FACET_BANDS, FACET_DEC, FACET_OFFSET_DEG = 2, -np.pi / 6, 0.5
# gridder kernels vs plain, relative to max|out|: f32 sums in another
# order than index_add_'s and the gather-sum's
GRIDDER_BOUND = 1e-5
# the times of the designs that the tile gather, the table map's tile
# spread, beam_interp's 2D grid and predict_kb's channel-group recurrence
# replaced (a thread a sample or a (sample, row); padded tiles and a fold;
# a sincospif and an expf per term), on an H100 80GB HBM3 at 700 W
# (PERF.md §6), printed beside this run's times
PREVIOUS_MS = {"degrid_2d": "0.2176-0.2206 ms", "grid_table": "0.2860-0.2864 ms",
               "degrid_wstack": "0.1633-0.1638 ms",
               "degrid_wstack_large": "3.30-3.31 ms", "degrid_table": "0.0836 ms",
               "beam_interp": "general 0.0753, chan-invariant 0.0047-0.0049, "
                              "cell corners 0.0046-0.0048 ms",
               "predict_kb": "9.805-9.978 ms",
               "predict_kb_store": "C=1 store chunk 146.50-146.53 ms"}
# phase 3: (sources, the far ones) of predict_kb's pairs beyond its plan's
# delay bound: the first tile of sources, and the second tile beside a
# first on the recurrence
FAR_PAIRS = ((6, (0, 1)), (16, (8, 9)))
# phase 4: the DFT kernels' pairs beyond their plan's delay bound, made at
# the measured bound / FAR_DIV; (dft_problem's grid, channels, the plan's
# mode there): an f32 linspace whose residual the plan drops, a jittered
# grid on the rotation, a prime channel count; SHORT scales the near
# pairs' uvw or lm
FAR_DIV = 1000
DFT_FAR_CASES = (("residual", 16, "exact"), ("jittered", 16, "residual"),
                 ("direct", 17, "direct"))
SHORT = 1e-4
# phases 10 and 16: square, odd, one-tile and narrower-than-the-window grids
WGRID_GRIDS = ((64, 64, 1007), (70, 45, 333), (12, 10, 50), (5, 7, 40))
# the PP gridder's conv_nn_scatter route: ~200 samples a cell
PP_NN = dict(nrow=100_000, npix=32)
PHASES = 29

# the least time of a kernel (bound_ms): the larger of its compulsory bytes
# over HBM (HBM_RATE, 3.35 TB/s) and its operations over the unit that
# runs them: FP32 instructions over the FP32 pipes (FP32_RATE, 132 SMs x
# 128 lanes x 1.98 GHz = 3.35e13/s, i.e. 67 TFLOP/s as FMAs) and, beside
# them, TF32 operations over the tensor cores (TF32_PEAK_FLOPS, 495
# TFLOP/s dense), all from the port's utils.profiling. The phase kernels'
# work is counted from the map, per (source or pixel, row, channel) term:
# a complex multiply-accumulate into each of C correlations (4·C FMAs;
# 2·C for the adjoint's real part), 4 to advance a phasor, and 2 to apply
# an envelope where there is one; at C = 4 predict_kb runs the
# multiply-accumulate on the tensor cores in 3xTF32 (3 products of the
# term's [re im] into B's 2·C columns: 3·8·C operations) and the rest on
# the FP32 pipes. The other kernels' counts per work item are their own
# estimates (the csrc/*.cu headers, PERF.md)
def predict_instr(ncorr, env):
    return (0 if ncorr == 4 else 4 * ncorr) + 4 + (2 if env else 0)


def predict_tf32(ncorr):
    return 3 * 8 * ncorr if ncorr == 4 else 0


def dft_fwd_instr(ncorr):
    return 4 * ncorr + 4


def dft_adj_instr(ncorr):
    return 2 * ncorr + 4


ES_INSTR = 20        # per ES tap evaluation (sqrt, exp); 2W per sample
GRID_TAP_INSTR = 3   # per grid tap (ku*kv, 2 FMAs)
DEGRID_TAP_INSTR = 2  # per degrid tap (2 FMAs)
# beam kernels at C = 4 (csrc/beam.cu): per (sample, row) 14 for the 8
# trilinear weights and 180 for the 8 corners' 12 values (a multiply and an
# add each, the first corner a multiply), and ~90 for the normalisation (4
# correctly rounded sqrt and divides) when normalised; per
# (sample, channel) the blend, normalisation and E·F, and for the cell
# route the 4 terms' blends and the reconstruction (uncontracted: 12 and
# 84 more than with FMAs)
BEAM_INTERP_INSTR = 285
BEAM_INTERP_RAW_INSTR = 195
BEAM_BLEND_INSTR = 112
BEAM_CELL_INSTR = 364


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def cuda_median_ms(fn, reps=7, warmup=2):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
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
    return float(np.median(times)), times


def kernel_median_ms(fn):
    """CUDA-event median per call of ``fn()``, a kernel wrapper whose
    operands are ready: BURST calls are captured into one CUDA graph,
    and each timed replay runs their kernels back to back with none of
    the host work of launching them."""
    import torch

    fn()  # build and load first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BURST):
            fn()
    ms, _ = cuda_median_ms(graph.replay)
    return ms / BURST


def host_median_ms(fn, reps=7, warmup=2):
    """Median host-clock ms of ``fn()`` from an idle card to an idle card."""
    import torch

    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def cuda_once_ms(fn):
    """(result, CUDA-event ms) of one run of ``fn()``."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def nbytes(*xs):
    """Bytes of the tensors in ``xs`` (nested tuples and None allowed)."""
    total = 0
    for x in xs:
        if isinstance(x, (tuple, list)):
            total += nbytes(*x)
        elif x is not None:
            total += x.numel() * x.element_size()
    return total


def bound(moved, instructions, tf32=0):
    """bound_ms and bound_by of a kernel that must move ``moved`` bytes,
    issue ``instructions`` FP32 instructions and, on the tensor cores
    beside them, ``tf32`` TF32 operations."""
    t_bytes = moved / HBM_RATE * 1e3
    t_ops = max(instructions / FP32_RATE, tf32 / TF32_PEAK_FLOPS) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def predict_freq(F, grid):
    """float32 channel frequencies that engage one of predict_kb's phase
    modes: an exact progression of 2^18 Hz steps from 856 MHz ("exact"), a
    float32 linspace over 0.856-1.712 GHz ("residual") or a sorted random
    grid ("direct")."""
    if grid == "exact":
        return (856e6 + np.arange(F) * 262144.0).astype(np.float32)
    if grid == "residual":
        return np.linspace(0.856e9, 1.712e9, F).astype(np.float32)
    return np.sort(np.random.default_rng(F).uniform(0.856e9, 1.712e9, F)
                   ).astype(np.float32)


def kernel_problem(rng, S, R, F, C, compensated, env, device, grid="residual",
                   far=()):
    """Random predict_kb operands on ``device``, made with numpy (also used
    by tests/test_torch_cuda.py), on the frequencies of
    :func:`predict_freq`. With ``far`` (source indices) the baselines reach
    80 km and those sources sit at l = m = 0.7, so that their delays exceed
    the predict plan's bound (1e-4 s) on most rows."""
    import torch
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    def t(x):
        return torch.as_tensor(x, device=device)

    if compensated:
        lm = rng.uniform(-0.02, 0.02, (S, 2)).astype(np.float32)
        lm[list(far)] = 0.7
        uvw = rng.uniform(-8000, 8000, (R, 3)).astype(np.float32)
        if len(far):
            uvw *= 10
        dot = phase_dot_cycles(t(lm), t(uvw))
    else:
        dot = t((rng.uniform(-100, 100, (S, R)) * 1e-7).astype(np.float32))
    u1 = t(rng.uniform(-100, 100, (S, R)).astype(np.float32)) if env else None
    v1 = t(rng.uniform(-100, 100, (S, R)).astype(np.float32)) if env else None
    freq = predict_freq(F, grid)
    b = (rng.normal(size=(S, F, C)) + 1j * rng.normal(size=(S, F, C))
         ).astype(np.complex64)
    return dot, u1, v1, t(freq), t((freq * 1e-12).astype(np.float32)), t(b)


def fused_problem(rng, S, R, F, T, NF, A, beam, feed, env, feed_first, device):
    """Operands of ``cuda_fused.fused_dde`` from ``rng`` at any shape:
    delays of a few thousand cycles at the band's top, envelopes down to
    e^-8, unit-scale E, L and B, rows in random dumps, stations on random
    feeds and antennas."""
    import torch
    from africanus_tpu_torch.ops import cuda_fused as cf

    def real(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                               device=device)

    def cplx(*shape):
        return torch.complex(real(*shape), real(*shape))

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    a1, a2 = rng.integers(0, A, R), rng.integers(0, A, R)
    f1, f2 = rng.integers(0, NF, R), rng.integers(0, NF, R)
    left, right = (f1 * A + a1, f2 * A + a2) if feed else (a1, a2)
    if not (beam or feed):
        left = right = None
    order, tiles, stations, local = cf.row_plan(rng.integers(0, T, R), left, right)
    hi = real(S, R, scale=2e-6)
    lo = hi * real(S, R, scale=3e-8)
    freq = torch.linspace(0.856e9, 1.712e9, F, device=device)
    pairs = torch.stack([hi, lo, real(S, R, scale=1e3), real(S, R, scale=1e3)], -1)
    sf = freq * 1.1e-9
    return cf.Operands(
        pairs.contiguous(), cplx(S, F, 4), cplx(S, T, A, F, 4) if beam else None,
        cplx(T, NF, A, 4) if feed else None, i32(order), i32(tiles), i32(stations),
        i32(local), freq, -1.4426950408889634 * 1e-6 * sf * sf if env else None, feed_first)


def dft_problem(rng, S, P, R, F, C, grid, device):
    """Random DFT kernel operands on ``device``, made with numpy (also used
    by tests/test_torch_cuda.py): (source lm (S, 2), pixel lm (P, 2),
    uvw (R, 3), frequencies (F,), image (S, F, C) complex64, vis (R, F, C)
    complex64). ``grid`` picks frequencies that engage that phase mode:
    an f64 linspace ("exact"), an f32 linspace ("residual") or a
    non-uniform grid ("direct"); or an f32 linspace moved by up to 1 MHz
    a channel ("jittered": ``residual`` at delay bounds under ~5e-8 s,
    ``direct`` above)."""
    import torch

    f32 = np.float32
    if grid == "exact":
        freq = np.linspace(0.856e9, 1.712e9, F)
    elif grid == "residual":
        freq = np.linspace(0.856e9, 1.712e9, F).astype(f32)
    elif grid == "jittered":
        freq = (np.linspace(0.856e9, 1.712e9, F)
                + rng.uniform(-1e6, 1e6, F)).astype(f32)
    else:
        freq = (0.8e9 + np.sort(rng.uniform(0, 1e9, F))).astype(f32)

    def t(x):
        return torch.as_tensor(x, device=device)

    def cplx(shape):
        return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
            np.complex64)

    return (t(rng.uniform(-0.01, 0.01, (S, 2)).astype(f32)),
            t(rng.uniform(-0.01, 0.01, (P, 2)).astype(f32)),
            t(rng.uniform(-4000, 4000, (R, 3)).astype(f32)),
            t(freq), t(cplx((S, F, C))), t(cplx((R, F, C))))


def dft_far_problem(rng, S, P, R, F, C, grid, device):
    """:func:`dft_problem`'s operands (also used by
    tests/test_torch_cuda.py) with pairs near and beyond a delay bound of
    the measured one / FAR_DIV (:func:`far_plan`), in warps of 32 lanes
    (the forward's rows, the adjoint's pixels; R and P multiples of 32):
    warp w's rows and pixels are all short (uvw or lm times SHORT) when
    w % 3 == 0, every other lane when w % 3 == 1 and none when w % 3 ==
    2, and every third source is short. A pair with a short side is near;
    most of the others are far."""
    import torch

    lm_s, lm_p, uvw, freq, img, vis = dft_problem(rng, S, P, R, F, C, grid, "cpu")

    def short(n):
        w, lane = np.arange(n) // 32, np.arange(n) % 32
        return torch.as_tensor((w % 3 == 0) | ((w % 3 == 1) & (lane % 2 == 0)))

    uvw[short(R)] *= SHORT
    lm_p[short(P)] *= SHORT
    lm_s[::3] *= SHORT
    return tuple(x.to(device) for x in (lm_s, lm_p, uvw, freq, img, vis))


def far_plan(kind, lm, uvw, freq, C, convention):
    """A DftPlan whose delay bound is the measured one / FAR_DIV."""
    from africanus_tpu_torch.ops import cuda_dft as cd

    return cd.DftPlan(kind, lm, freq, C, convention,
                      cd.measured_delay_max(lm, uvw) / FAR_DIV)


def far_warps(plan, uvw):
    """(pairs beyond ``plan``'s bound, then the kernel's warp votes that
    are all far, mixed and all near) on these rows: a warp is 32 rows at
    a source (forward) or 32 pixels at a row (adjoint)."""
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    hi, _ = phase_dot_cycles(plan.lm, uvw, plan.convention)  # (direction, row)
    far = hi.abs() > plan.delay_far
    lanes = far.T if plan.kind == "forward" else far
    warps = lanes[:lanes.shape[0] // 32 * 32].reshape(-1, 32, lanes.shape[1])
    some, every = warps.any(dim=1), warps.all(dim=1)
    return (int(far.sum()), int(every.sum()), int((some & ~every).sum()),
            int((~some).sum()))


def wgrid_problem(rng, n, nu, nv, nplanes, support, dtype, device, edges=False):
    """A random WGridPlan of ``n`` samples on ``device`` (the first few
    with windows that wrap past the grid edges; with ``edges``, the next
    few on the grid kernel's tile corners and in a tile's last cells) and
    operands for it, made with numpy (also used by
    tests/test_torch_cuda.py): (plan, vis (n,), grid (nplanes, nu, nv)),
    complex in the plan's dtype. A stack (``nplanes`` > 1) needs nplanes ≥
    support + 2."""
    import torch
    from africanus_tpu_torch.ops import cuda_wgrid as cw
    from africanus_tpu_torch.ops.es import es_np

    w = support
    upos, vpos = rng.uniform(0, nu, n), rng.uniform(0, nv, n)
    upos[:3] = [0.01, nu - 0.3, nu - 0.9][:n]
    vpos[1:4] = [nv - 0.2, 0.4, nv - 1.1][:max(n - 1, 0)]
    if edges:
        # a window starting W/2 - 1 cells before its sample: samples at a
        # tile corner (their windows over four tiles), just past one, and
        # in a tile's last cell
        rb = 4 if dtype == torch.float32 else 8
        block, _ = cw._plane_layout(nplanes, w, rb)
        tu, tv = (cw._tile_edge(x, block, w, rb) for x in (nu, nv))
        k = min(n - 4, 6)
        cu = (np.arange(1, k + 1) * tu) % nu + np.array([0.0, 0.5, -0.5, -0.01, 0.99, 1.5][:k])
        cv = (np.arange(1, k + 1) * tv) % nv + np.array([0.0, -0.5, 0.5, -0.01, 1.5, 0.99][:k])
        upos[4:4 + k], vpos[4:4 + k] = np.mod(cu, nu), np.mod(cv, nv)
    iu0 = np.floor(upos).astype(np.int64) - (w // 2 - 1)
    iv0 = np.floor(vpos).astype(np.int64) - (w // 2 - 1)
    if nplanes > 1:
        wpos = rng.uniform(w / 2, nplanes - w / 2 - 1, n)
        # w-windows at both ends of the stack
        wpos[:2] = [w / 2 - 0.5, nplanes - w / 2 - 0.5][:n]
        p0 = np.floor(wpos).astype(np.int64) - (w // 2 - 1)
        wsc = es_np((wpos[None, :] - (p0[None, :] + np.arange(w)[:, None]))
                    / (w / 2), 2.3 * w)
    else:
        p0, wsc = np.zeros(n, np.int64), np.ones((1, n))
    plan = cw.WGridPlan(iu0, iv0, upos - iu0, vpos - iv0, p0, wsc, nu, nv,
                        nplanes, w, 2.3 * w, dtype=dtype, device=device)
    cplx = plan.complex_dtype

    def t(shape):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(x).to(device=device, dtype=cplx)

    return plan, t(n), t((nplanes, nu, nv))


def beam_problem(rng, nsamp, nchan, ncorr, dtype, device, lw=17, mh=13, nud=8):
    """Random operands of the three beam kernels on ``device``, made with
    numpy (also used by tests/test_torch_cuda.py): a dict of ``slabs`` of
    a random (lw, mh, nud, C) cube; (nsamp, nchan) coordinates ``vl``,
    ``vm`` (clamped, a few on integers and the cube's edges); per channel
    ``gc0``, ``gc1``, ``wlo`` from freq_grid_interp of frequencies that
    run out of the cube at both ends; per-slab raw sums ``raw`` (nsamp,
    nud, 3C); cell terms ``bt`` (nsamp, 4, nud, 3C) with in-cell offsets
    ``lda``, ``mda``; and (time, ant) parallactic angles ``pa`` that
    divide the samples."""
    import torch
    from africanus_tpu_torch.ops.cuda_beam import beam_slabs
    from africanus_tpu_torch.rime.fast_beam_cubes import freq_grid_interp

    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=device, dtype=dt)

    cube = (rng.normal(size=(lw, mh, nud, ncorr))
            + 1j * rng.normal(size=(lw, mh, nud, ncorr)))
    vl = rng.uniform(0, lw - 1, (nsamp, nchan))
    vm = rng.uniform(0, mh - 1, (nsamp, nchan))
    vl.flat[:4] = [0.0, lw - 1, 3.0, lw - 1][:vl.size]
    vm.flat[:4] = [mh - 1, 0.0, 5.0, mh - 1][:vm.size]
    fmap = np.linspace(0.9e9, 1.6e9, nud)
    fd = freq_grid_interp(torch.as_tensor(np.linspace(0.8e9, 1.7e9, nchan)),
                          torch.as_tensor(fmap))
    gc0 = fd[:, 2].numpy().astype(np.int32)

    def raw(shape):
        re, im = rng.normal(size=shape + (ncorr,)), rng.normal(size=shape + (ncorr,))
        amp = np.abs(re + 1j * im) * rng.uniform(0.8, 1.2, re.shape)
        return np.concatenate([re, im, amp], -1)

    bt = raw((nsamp, 4, nud))
    bt[:, 1:] *= 0.1
    nta = 10 if nsamp % 10 == 0 else 1
    return dict(slabs=beam_slabs(t(cube, cdtype)), vl=t(vl), vm=t(vm),
                gc0=t(gc0, torch.int32), gc1=t(gc0 + 1, torch.int32),
                wlo=t(fd[:, 1].numpy()), raw=t(raw((nsamp, nud))), bt=t(bt),
                lda=t(rng.uniform(0, 1, (nsamp, nchan))),
                mda=t(rng.uniform(0, 1, (nsamp, nchan))),
                pa=t(rng.uniform(-np.pi, np.pi, (nta // 5 or 1, nta // 2 or 1))))


def grid2d_problem(rng, n, nu, nv, ncorr, support, dtype, device, edges=False):
    """A random one-plane WGridPlan of ``n`` samples on ``device`` (the
    first few windows wrapping past the grid edges; with ``edges``, the
    next few on tile corners and in a tile's last cells) and operands of
    the 2D multi-correlation kernels, made with numpy (also used by
    tests/test_torch_cuda.py): (plan, vis (ncorr, n) — the transpose of an
    (n, ncorr) tensor, as the nifty API hands it over —, grid (ncorr, nu,
    nv)), complex in the plan's dtype."""
    import torch

    plan, _, _ = wgrid_problem(rng, n, nu, nv, 1, support, dtype, device, edges)

    def t(shape):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(x).to(device=device, dtype=plan.complex_dtype)

    return plan, t((n, ncorr)).T, t((ncorr, nu, nv))


def table_problem(rng, n, npix, nband, support, oversample, dtype, device):
    """A random TableGridPlan of ``n`` samples on ``device`` whose windows
    hang off every grid edge (some with no cell in the grid) and operands
    of the table kernels, made with numpy (also used by
    tests/test_torch_cuda.py): (plan, table (kbsinc of the support),
    values (n,), grid (nband, npix, npix))."""
    import torch
    from africanus_tpu_torch.gridding.perleypolyhedron.kernels import kbsinc
    from africanus_tpu_torch.ops.cuda_gridtab import TableGridPlan

    ir0 = rng.integers(-support - 1, npix + 1, n)
    ic0 = rng.integers(-support - 1, npix + 1, n)
    ir0[:4] = [-(support - 1), npix - 1, 3, -support][:n]
    ic0[:4] = [npix - 1, -(support - 1), -support, 2][:n]
    half = oversample // 2
    fr, fc = (rng.integers(-half, half + 1, n) for _ in range(2))
    band = rng.integers(0, nband, n)
    plan = TableGridPlan(ir0, ic0, fr, fc, band, npix, nband, support, oversample,
                         dtype=dtype, device=device)
    cplx = plan.complex_dtype

    def t(shape):
        x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
        return torch.as_tensor(x).to(device=device, dtype=cplx)

    table = torch.as_tensor(kbsinc(support, oversample=oversample)).to(
        device=device, dtype=dtype)
    return plan, table, t(n), t((nband, npix, npix))


def pp_nn_problem(nrow, npix, cdtype, seed):
    """Host operands of the Perley-polyhedron gridder's conv_nn_scatter
    route (also used by tests/test_torch_cuda.py): config 4's draws
    (imaging_inputs) of ``nrow`` rows × 4 channels onto an ``npix``² grid,
    so that many samples share a cell, and seeded 2-correlation
    visibilities of ``cdtype``."""
    from africanus_tpu_torch.gridding.wgridder.imaging import imaging_inputs

    args = imaging_inputs(nrow=nrow, nchan=4, nx=npix, seed=seed)
    rng = np.random.default_rng(seed)
    vis = (rng.normal(size=(nrow, 4, 2)) + 1j * rng.normal(size=(nrow, 4, 2))
           ).astype(cdtype)
    return dict(uvw=args["uvw"].astype(np.float64),
                wl=2.99792458e8 / args["freq"].astype(np.float64), npix=npix,
                cell=np.rad2deg(args["cell"]) * 3600, vis=vis)


def pp_nn_grid(problem, device):
    """The conv_nn_scatter route on ``device``: Stokes I into 2 bands, the
    image centre 0.57 deg off the phase centre, normalised."""
    import torch
    from africanus_tpu_torch.gridding import perleypolyhedron as pp

    p = problem
    return pp.gridder(p["uvw"], torch.as_tensor(p["vis"], device=device), p["wl"],
                      np.array([0, 0, 1, 1]), p["npix"], p["cell"], (0.0, -0.5 + 0.01),
                      (0.0, -0.5), pp.kernels.kbsinc(7, oversample=63), 7, 63, "rotate",
                      "phase_rotate", "I_FROM_XXYY", "conv_nn_scatter", do_normalize=True)


def phase_kernel_checks(device):
    """Phase 3: predict_kb against its plain version: the three phase
    modes of its plan x corr 1/2/4 x compensated and plain x envelope and
    point sources at a ragged shape; a prime channel count (one-channel
    groups), one channel and groups of 10; pairs beyond the plan's delay
    bound (FAR_PAIRS) at corr 1/2/4; and the compensated phase against a
    float64 oracle."""
    import torch
    from africanus_tpu_torch.ops.cuda_predict import (
        plan_for, predict_kb, predict_kb_reference,
    )
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    rng = np.random.default_rng(SEED)
    worst, modes = {}, set()

    def compare(key, ops, bound):
        got = predict_kb(*ops)
        torch.cuda.synchronize()
        want = predict_kb_reference(*ops)
        check(got.shape == want.shape and got.dtype == torch.complex64,
              f"kernel output {tuple(got.shape)} {got.dtype}")
        err = float((got - want).abs().max() / want.abs().max())
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= bound, f"kernel vs plain {key}: {err:.3e} > {bound}")

    for grid in ("exact", "residual", "direct"):
        for C in (4, 2, 1):
            for compensated in (True, False):
                for env in (True, False):
                    ops = kernel_problem(rng, 37, 1000, 300, C, compensated,
                                         env, device, grid)
                    # worst over C 1/2/4 and envelope or point sources
                    compare(f"{grid}/{'comp' if compensated else 'plain'}", ops,
                            2e-6 if compensated else 1e-5)
                    if compensated:
                        modes.add(plan_for(ops[3]).mode)
    check(modes == {"exact", "residual", "direct"}, f"plan modes run: {modes}")
    cgs = {}
    for S, R, F in ((5, 70, 4093), (3, 33, 1), (9, 45, 250)):
        for C in (4, 1):
            ops = kernel_problem(rng, S, R, F, C, True, True, device)
            cgs[F] = plan_for(ops[3]).cg
            compare(f"F{F}/C{C}", ops, 2e-6)
    check(cgs == {4093: 1, 1: 1, 250: 10}, f"channel groups {cgs}")
    # pairs beyond the delay bound: in the first tile of sources, and in
    # the second beside a first tile on the recurrence
    nfar = {}
    for S, far in FAR_PAIRS:
        for C in (4, 2, 1):
            ops = kernel_problem(rng, S, 256, 4096, C, True, True, device, far=far)
            plan = plan_for(ops[3])
            beyond = ops[0][0].abs() > plan.delay_max
            nfar[S] = int(beyond.sum())
            check(plan.mode == "residual" and 0 < nfar[S] < len(far) * 256
                  and not beyond[[s for s in range(S) if s not in far]].any(),
                  f"far pairs: mode {plan.mode}, {nfar[S]} beyond {plan.delay_max} s")
            compare(f"far pairs S{S}", ops, 2e-6)

    # compensated against complex128 at 1e4 rad phases
    # (tests/test_pallas_predict.py::test_pallas_predict_compensated)
    S, R, F, C = 16, 128, 128, 2
    lm = rng.uniform(-0.02, 0.02, (S, 2)).astype(np.float32)
    uvw = rng.uniform(-8000, 8000, (R, 3)).astype(np.float32)
    freq = np.linspace(0.856e9, 1.712e9, F).astype(np.float32)
    b = (rng.normal(size=(S, F, C)) + 1j * rng.normal(size=(S, F, C))
         ).astype(np.complex64)
    t_freq = torch.as_tensor(freq, device=device)
    dot = phase_dot_cycles(torch.as_tensor(lm, device=device),
                           torch.as_tensor(uvw, device=device))
    got = predict_kb(dot, None, None, t_freq, t_freq * 0,
                     torch.as_tensor(b, device=device)).cpu().numpy()
    l, m = lm[:, 0].astype(np.float64), lm[:, 1].astype(np.float64)
    n = np.sqrt(np.maximum(1 - l * l - m * m, 0)) - 1
    d = (l[:, None] * uvw[None, :, 0] + m[:, None] * uvw[None, :, 1]
         + n[:, None] * uvw[None, :, 2])
    p = (-2 * np.pi / 299792458.0) * d[:, :, None] * freq.astype(np.float64)
    ref = np.einsum("srf,sfc->rfc", np.exp(1j * p), b.astype(np.complex128))
    f64_err = rel_err(got, ref)
    check(f64_err < 2e-6, f"kernel vs f64 oracle: {f64_err:.3e} >= 2e-6")
    print(f"[3/{PHASES}] predict_kb vs plain on the card (S=37 R=1000 F=300 "
          "in the plan's three modes; F 4093, 1 and 250 at C 4 and 1; "
          + ", ".join(f"{nfar[S]} of {S} x 256 pairs (sources {far})"
                      for S, far in FAR_PAIRS)
          + " beyond the plan's delay bound at F=4096, C 4/2/1; "
          "rel to max|V|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; compensated vs f64 oracle (S=16 R=128 F=128 C=2): {f64_err:.2e}",
          flush=True)


def dft_kernel_checks(device):
    """Phase 4: both DFT kernels against their plain versions, and with
    pairs beyond their plan's delay bound against float64 too."""
    import torch
    from africanus_tpu_torch.calibration.selfcal import (
        im_to_vis_oracle_f64, vis_to_im_oracle_f64,
    )
    from africanus_tpu_torch.dft import im_to_vis
    from africanus_tpu_torch.ops import cuda_dft as cd
    from africanus_tpu_torch.ops.cuda_predict import predict_kb, predict_kb_reference

    rng = np.random.default_rng(SEED + 1)
    worst = {}

    def compare(key, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= DFT_BOUND, f"{key}: {err:.3e} > {DFT_BOUND}")

    modes, groups = set(), set()
    # (S, P, R, F): the ragged shape for every mode, corr and convention,
    # one-channel and many-group edges, and the edges of the channel
    # groups and tiles: F = 16 (one full group), 17 (a ragged group), 64
    # (several groups a block); P not a multiple of the pixel tile, R under
    # one row tile; C = 3 as 2 + 1 launches. Each launch twice, bitwise.
    for S, P, R, F, grids in ((37, 300, 1000, 12, ("exact", "residual", "direct")),
                              (1, 5, 9, 1, ("exact",)),
                              (70, 129, 33, 16, ("residual",)),
                              (20, 200, 10, 16, ("exact", "residual", "direct")),
                              (9, 77, 300, 17, ("residual", "direct")),
                              (40, 300, 500, 64, ("exact", "residual", "direct"))):
        for grid in grids:
            for C in (1, 2, 3, 4):
                for conv in ("fourier", "casa"):
                    lm_s, lm_p, uvw, freq, img, vis = dft_problem(
                        rng, S, P, R, F, C, grid, device)
                    fwd = cd.DftPlan("forward", lm_s, freq, C, conv)
                    for sky, image in (("complex", img),
                                       ("real", img.real.contiguous())):
                        got = cd.dft_forward(fwd, uvw, image)
                        want = cd.dft_forward_reference(fwd, uvw, image)
                        check(got.shape == (R, F, C)
                              and got.dtype == torch.complex64, "forward shape")
                        check(torch.equal(got, cd.dft_forward(fwd, uvw, image)),
                              f"dft_forward rerun differs at {(S, R, F, C)}")
                        compare(f"forward/{sky}", got, want)
                    adj = cd.DftPlan("adjoint", lm_p, freq, C, conv)
                    got = cd.dft_adjoint(adj, uvw, vis)
                    want = cd.dft_adjoint_reference(adj, uvw, vis)
                    check(got.shape == (P, F, C) and got.dtype == torch.float32,
                          "adjoint shape")
                    check(torch.equal(got, cd.dft_adjoint(adj, uvw, vis)),
                          f"dft_adjoint rerun differs at {(P, R, F, C)}")
                    compare("adjoint", got, want)
                    modes.update((fwd.mode, adj.mode))
                    groups.update((q.cg, q.ngroups) for q in (fwd.parts or [fwd]))
    check(modes == {"exact", "residual", "direct"}, f"modes run: {modes}")
    check({(16, 1), (16, 2), (16, 4), (8, 8)} <= groups, f"groups run: {groups}")

    # pairs beyond the plan's delay bound (FAR_DIV below the measured
    # one): in the exact and residual modes a warp with a far pair takes
    # the direct phase; warps all far, mixed and all near, in every mode
    # at C 1/2/4, against the plain version, float64, and a rerun
    votes = np.zeros(4, np.int64)
    far_err = {}
    for grid, F, mode in DFT_FAR_CASES:
        for C in (1, 2, 4):
            for conv in ("fourier", "casa"):
                lm_s, lm_p, uvw, freq, img, vis = dft_far_problem(
                    rng, 24, 192, 384, F, C, grid, device)
                sign = 1.0 if conv == "fourier" else -1.0
                uvw64, f64 = uvw.double().cpu().numpy(), np.asarray(freq.cpu(), np.float64)
                fwd = far_plan("forward", lm_s, uvw, freq, C, conv)
                adj = far_plan("adjoint", lm_p, uvw, freq, C, conv)
                check(fwd.mode == adj.mode == mode,
                      f"far pairs {grid}/{F}: modes {fwd.mode}, {adj.mode}, not {mode}")
                runs = []
                for sky, image in (("complex", img), ("real", img.real.contiguous())):
                    runs.append((f"forward/{sky}", fwd, cd.dft_forward,
                                 cd.dft_forward_reference, image,
                                 im_to_vis_oracle_f64(image.cpu().numpy(),
                                                      sign * uvw64,
                                                      lm_s.cpu().numpy(), f64)))
                runs.append(("adjoint", adj, cd.dft_adjoint, cd.dft_adjoint_reference,
                             vis, vis_to_im_oracle_f64(vis.cpu().numpy(), -sign * uvw64,
                                                       lm_p.cpu().numpy(), f64)))
                for key, plan, fn, plain, values, oracle in runs:
                    w = np.array(far_warps(plan, uvw))
                    check(w[0] > 0 and (w[1:] > 0).all(),
                          f"far pairs {key}: (far, all far, mixed, near) {w}")
                    votes += w
                    got = fn(plan, uvw, values)
                    compare(f"far {key}", got, plain(plan, uvw, values))
                    check(torch.equal(got, fn(plan, uvw, values)),
                          f"far pairs {key}: rerun differs")
                    e64 = rel_err(got.cpu().numpy(), oracle)
                    far_err[key] = max(far_err.get(key, 0.0), e64)
                    check(e64 <= DFT_BOUND, f"far pairs {key} vs f64: {e64:.3e}")

    # three correlations: each plan holds a sub-plan per group the kernels
    # take (2 + 1), launched on its own columns; predict_kb splits the same
    lm_s, lm_p, uvw, freq, img, vis = dft_problem(rng, 37, 300, 1000, 12, 3,
                                                  "residual", device)
    fwd = cd.DftPlan("forward", lm_s, freq, 3, "fourier")
    adj = cd.DftPlan("adjoint", lm_p, freq, 3, "casa")
    before = (cd.dft_forward.launches, cd.dft_adjoint.launches, predict_kb.launches)
    got_f, got_a = cd.dft_forward(fwd, uvw, img), cd.dft_adjoint(adj, uvw, vis)
    ops = kernel_problem(rng, 37, 1000, 300, 3, True, True, device)
    got_p = predict_kb(*ops)
    torch.cuda.synchronize()
    check((cd.dft_forward.launches, cd.dft_adjoint.launches, predict_kb.launches)
          == tuple(b + 2 for b in before), "3 correlations: not 2 + 1 launches")
    compare("forward/3corr", got_f, cd.dft_forward_reference(fwd, uvw, img))
    compare("adjoint/3corr", got_a, cd.dft_adjoint_reference(adj, uvw, vis))
    want = predict_kb_reference(*ops)
    pk3 = float((got_p - want).abs().max() / want.abs().max())
    check(got_p.shape == (1000, 300, 3) and pk3 <= 2e-6,
          f"predict_kb 3 corr vs plain {pk3:.3e} > 2e-6")

    # two launches give bitwise-equal outputs
    lm_s, lm_p, uvw, freq, img, vis = dft_problem(rng, 20, 4096, 4000, 16, 1,
                                                  "residual", device)
    adj = cd.DftPlan("adjoint", lm_p, freq, 1, "casa")
    check(torch.equal(cd.dft_adjoint(adj, uvw, vis), cd.dft_adjoint(adj, uvw, vis)),
          "dft_adjoint is not deterministic")
    fwd = cd.DftPlan("forward", lm_s, freq, 1, "fourier")
    image = img.real.contiguous()
    check(torch.equal(cd.dft_forward(fwd, uvw, image),
                      cd.dft_forward(fwd, uvw, image)),
          "dft_forward is not deterministic")

    # im_to_vis at >= 128 channels takes predict_kb (no envelope)
    lm_s, _, uvw, freq, img, _ = dft_problem(rng, 20, 1, 500, 256, 2,
                                             "residual", device)
    before = predict_kb.launches
    got = im_to_vis(img, uvw, lm_s, freq)
    torch.cuda.synchronize()
    check(predict_kb.launches == before + 1, "im_to_vis >= 128 chan: no predict_kb")
    want = im_to_vis(img.cpu(), uvw.cpu(), lm_s.cpu(), freq.cpu())
    wide = float((got.cpu() - want).abs().max() / want.abs().max())
    check(wide <= 2e-6, f"im_to_vis via predict_kb vs CPU: {wide:.3e} > 2e-6")
    print(f"[4/{PHASES}] dft kernels vs plain on the card (S=37 P=300 R=1000 "
          f"F=12, modes {sorted(modes)}, C 1/2/3/4, both conventions, and edge "
          f"shapes: F 1/16/17/64, P 5/77/129/200, R 9/10/33; (cg, groups) "
          f"{sorted(groups)}; reruns bitwise; rel to max|out|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; predict_kb C 3 (2 + 1) {pk3:.2e}; deterministic; im_to_vis 256 "
          f"chan via predict_kb vs CPU {wide:.2e}; far pairs (plans at the "
          f"measured delay bound / {FAR_DIV}, modes "
          f"{sorted(m for _, _, m in DFT_FAR_CASES)}, C 1/2/4, both conventions, "
          f"S=24 P=192 R=384): {votes[0]} pairs beyond the bound, warp votes "
          f"{votes[1]} all far, {votes[2]} mixed, {votes[3]} all near; vs f64 "
          + ", ".join(f"{k} {v:.2e}" for k, v in far_err.items()),
          flush=True)


def slice_chunks():
    """NCHUNK row chunks of NTIME time steps sharing one sky: chunk k has
    times NTIME·k … NTIME·k+NTIME−1, its own uvw and its own gain table."""
    from africanus_tpu_torch.rime.flagship import flagship_inputs

    first = flagship_inputs(NSRC, NTIME, NANT, NCHAN, SEED)
    _, _, _, lm, _, freq, stokes, spi, ref_freq, gshape, _ = first
    chunks = [first]
    for k in range(1, NCHUNK):
        ti, a1, a2, _, uvw, _, _, _, _, _, gphase = flagship_inputs(
            NSRC, NTIME, NANT, NCHAN, SEED + k)
        chunks.append((ti + NTIME * k, a1, a2, lm, uvw, freq, stokes, spi,
                       ref_freq, gshape, gphase))
    return chunks


def flagship(device, card):
    """Phases 5-6: the flagship predict. Returns its predict_kb entry of
    the kernels line."""
    import torch
    from africanus_tpu_torch.ops.cuda_predict import (
        predict_kb, predict_kb_reference,
    )
    from africanus_tpu_torch.rime.flagship import from_numpy, predict_oracle_f64

    chunks = slice_chunks()
    model, _ = from_numpy(chunks[0], device)
    inputs = [from_numpy(c, device)[1] for c in chunks]
    torch.cuda.synchronize()
    predict_kb.launches = 0
    t0 = time.perf_counter()
    outs = [model(*x) for x in inputs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = predict_kb.launches
    check(launches == NCHUNK, f"predict_kb launched {launches} times, "
                              f"expected {NCHUNK}")

    nrow = chunks[0][1].size
    rows = np.unique(np.linspace(0, nrow - 1, 256).round().astype(int))
    chans = np.unique(np.linspace(0, NCHAN - 1, 16).round().astype(int))
    check(chans[-1] == NCHAN - 1 and rows.size == 256 and chans.size == 16,
          "oracle window")
    errs = []
    for c, out in zip(chunks, outs):
        check(tuple(out.shape) == (nrow, NCHAN, NCORR)
              and out.dtype == torch.complex64, f"output {tuple(out.shape)}")
        check(bool(torch.isfinite(torch.view_as_real(out)).all()),
              "non-finite visibilities")
        ti, a1, a2, lm, uvw, freq, stokes, spi, ref_freq, gshape, gphase = c
        got = out[torch.as_tensor(rows, device=device)][
            :, torch.as_tensor(chans, device=device)].cpu().numpy()
        want = predict_oracle_f64((ti - ti.min())[rows], a1[rows], a2[rows],
                                  lm, uvw[rows], freq[chans], stokes, spi,
                                  ref_freq, gshape, gphase[:, :, chans])
        errs.append(rel_err(got, want))
    check(max(errs) <= 5e-6, f"slice vs f64 oracle: {max(errs):.3e} > 5e-6")
    print(f"[5/{PHASES}] flagship: {NCHUNK} chunks x ({nrow} rows, {NCHAN} chan, "
          f"{NCORR} corr, {NSRC} gaussian src) in {wall:.3f} s wall "
          f"(first call included); predict_kb launches {launches}; "
          f"max rel err vs f64 oracle per chunk "
          f"{', '.join(f'{e:.2e}' for e in errs)} "
          f"(JAX package, config 2, TPU: {JAX_CONFIG2_ERR:.2e})", flush=True)
    del outs

    # times at the slice's shape (chunk 0), on this card
    ops = model.kernel_operands(inputs[0][3], inputs[0][4])
    kernel_ms, _ = cuda_median_ms(lambda: predict_kb(*ops))
    forward_ms, _ = cuda_median_ms(lambda: model(*inputs[0]))
    # a forward never waits for the card: the frequencies' plan was made
    # at the first call, and the kernel sums in a fixed order
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model(*inputs[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = predict_kb(*ops)
    check(torch.equal(got, predict_kb(*ops)),
          "predict_kb reruns at the flagship chunk are not bitwise equal")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want, plain_ms = cuda_once_ms(lambda: predict_kb_reference(*ops))
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    max_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(max_abs <= 2e-6 * scale,
          f"kernel vs plain at the slice shape: {max_abs:.3e} > 2e-6 x {scale:.3e}")
    nvis = nrow * NCHAN * NCORR
    terms = NSRC * nrow * NCHAN
    entry_bound = bound(nbytes(ops, got), terms * predict_instr(NCORR, True),
                        terms * predict_tf32(NCORR))
    print(f"[6/{PHASES}] flagship times on {card}: predict_kb kernel "
          f"{kernel_ms:.3f} ms ({nvis / kernel_ms / 1e3:.1f} Mvis/s; bound "
          f"{entry_bound['bound_ms']:.3f} ms by {entry_bound['bound_by']}, "
          f"{entry_bound['bound_ms'] / kernel_ms:.0%} of it; was "
          f"{PREVIOUS_MS['predict_kb']}), reruns bitwise equal, forward "
          f"{forward_ms:.3f} ms ({nvis / forward_ms / 1e3:.1f} Mvis/s; one more "
          "under set_sync_debug_mode('error')), plain "
          f"predict_kb_reference {plain_ms:.1f} ms ({nvis / plain_ms / 1e3:.1f} "
          f"Mvis/s, peak {plain_peak:.1f} GiB); kernel vs plain max abs err "
          f"{max_abs:.3e} (max|V| {scale:.3e})", flush=True)
    return {
        "name": "predict_kb",
        "route": "cuda",
        "source": "africanus_tpu_torch/csrc/predict_kb.cu",
        "replaces": "africanus_tpu/ops/pallas_predict.py:393, "
                    "africanus_tpu/ops/pallas_predict.py:238",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        **entry_bound,
        "library_ms": None,
    }


def selfcal(device, card):
    """Phases 7-9: one config-5 selfcal step. Returns the dft_forward,
    dft_adjoint and hogbom entries of the kernels line."""
    import torch
    from africanus_tpu_torch.calibration.phase_only import gauss_newton
    from africanus_tpu_torch.calibration.selfcal import (
        from_numpy, gain_product_error, im_to_vis_oracle_f64, make_data,
        selfcal_inputs, vis_to_im_oracle_f64,
    )
    from africanus_tpu_torch.calibration.utils import corrupt_vis
    from africanus_tpu_torch.deconv.hogbom import hogbom_clean
    from africanus_tpu_torch.deconv.hogbom.clean import hogbom_clean_reference
    from africanus_tpu_torch.dft import im_to_vis, vis_to_im
    from africanus_tpu_torch.ops import cuda_dft as cd
    from africanus_tpu_torch.ops import cuda_hogbom as ch
    from africanus_tpu_torch.ops.cuda_predict import predict_kb

    t0 = time.perf_counter()
    inputs = selfcal_inputs(seed=SELFCAL_SEED, **SELFCAL)
    inputs.update(make_data(inputs, device))  # the port's im_to_vis + corrupt_vis
    step, data = from_numpy(inputs, device, npx=SELFCAL_NPX,
                            gn_iters=SELFCAL_GN_ITERS)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    nrow, nchan = data.shape[0], data.shape[1]
    npx = SELFCAL_NPX

    # 7. the step, once, through the kernels
    cd.dft_forward.launches = cd.dft_adjoint.launches = predict_kb.launches = 0
    ch.hogbom.launches = 0
    t0 = time.perf_counter()
    outs = step(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dft_forward": cd.dft_forward.launches,
                "dft_adjoint": cd.dft_adjoint.launches,
                "predict_kb": predict_kb.launches,
                "hogbom": ch.hogbom.launches}
    check(launches == {"dft_forward": 1, "dft_adjoint": 1, "predict_kb": 0,
                       "hogbom": 1},
          f"selfcal step launches {launches}")
    gains, jhj, jhr, dirty, clean, residual_image, re_model = outs
    shapes = [tuple(x.shape) for x in outs]
    gshape = (SELFCAL["ntime"], SELFCAL["nant"], nchan, 1, SELFCAL["ncorr"])
    check(shapes == [gshape] * 3 + [(npx, npx)] * 3
          + [(nrow, nchan, SELFCAL["ncorr"])], f"step output shapes {shapes}")
    for name, x in zip(("gains", "jhj", "jhr", "dirty", "clean", "residual",
                        "re_model"), outs):
        real = torch.view_as_real(x) if x.is_complex() else x
        check(bool(torch.isfinite(real).all()), f"non-finite {name}")
    print(f"[7/{PHASES}] selfcal step (config 5): {SELFCAL['nant']} antennas, "
          f"{nrow} rows, {nchan} chan, {SELFCAL['ncorr']} corr, "
          f"{SELFCAL['nsrc']} src, {SELFCAL_GN_ITERS} GN iterations, {npx}² image "
          f"in {wall:.3f} s wall (first call included; set-up {setup:.1f} s); "
          f"launches {launches}; CLEAN components {int((clean != 0).sum())}, "
          f"max|dirty| {float(dirty.abs().max()):.3e}", flush=True)

    # 8. accuracy
    meta = (step.time_bin_indices, step.time_bin_counts, step.antenna1,
            step.antenna2)
    table = (step.gather_sel, step.gather_valid)
    g40 = gauss_newton(*meta, step.jones0, data, step.flag, step.model,
                       step.weight, tol=0.0, maxiter=40, table=table)[0]
    gn_err = gain_product_error(g40, inputs["true_phase"])
    check(gn_err <= 1e-5, f"GN (40 iterations) vs truth: {gn_err:.3e} > 1e-5")

    pix = np.unique(np.linspace(0, npx * npx - 1, 64).round().astype(int))
    lm_win = step.grid_lm[torch.as_tensor(pix, device=device)]
    got = vis_to_im(data, step.uvw, lm_win, inputs["frequency"],
                    step.flag).cpu().numpy()
    d = inputs["data"][0] + 1j * inputs["data"][1]
    want = vis_to_im_oracle_f64(d, inputs["uvw"], lm_win.cpu().numpy(),
                                inputs["frequency"])
    adj_err = rel_err(got, want)
    check(adj_err <= DFT_BOUND, f"vis_to_im vs f64 oracle: {adj_err:.3e}")

    rows = np.unique(np.linspace(0, nrow - 1, 256).round().astype(int))
    got = re_model[torch.as_tensor(rows, device=device)].cpu().numpy()
    want = im_to_vis_oracle_f64(inputs["image"], inputs["uvw"][rows],
                                inputs["lm"], inputs["frequency"])
    fwd_err = rel_err(got, want)
    check(fwd_err <= DFT_BOUND, f"im_to_vis vs f64 oracle: {fwd_err:.3e}")
    print(f"[8/{PHASES}] selfcal checks: GN 40 iterations vs true gains "
          f"{gn_err:.3e} (bench.py bound 1e-5); vis_to_im of the data "
          f"({pix.size} pixels x {nrow} rows x {nchan} chan) vs f64 oracle "
          f"{adj_err:.2e}; re-predict ({rows.size} rows) vs f64 oracle "
          f"{fwd_err:.2e} (rel to max, bound {DFT_BOUND})", flush=True)

    # 9. times at the step's shapes, with the step's plans
    adj, fwd = step.adjoint_plan, step.forward_plan
    resid = (data - corrupt_vis(*meta, gains, step.model)).sum(dim=-1, keepdim=True)
    data_i = data.sum(dim=-1, keepdim=True).contiguous()

    got = cd.dft_adjoint(adj, step.uvw, data_i)
    want = cd.dft_adjoint_reference(adj, step.uvw, data_i)
    adj_abs = float((got - want).abs().max())
    adj_scale = float(want.abs().max())
    check(adj_abs <= DFT_BOUND * adj_scale,
          f"dft_adjoint vs plain at the step shape: {adj_abs:.3e}")
    check(torch.equal(got, cd.dft_adjoint(adj, step.uvw, data_i)),
          "dft_adjoint rerun differs at the step shape")
    got = cd.dft_forward(fwd, step.uvw, step.image)
    check(torch.equal(got, cd.dft_forward(fwd, step.uvw, step.image)),
          "dft_forward rerun differs at the step shape")
    want, fwd_plain_ms = cuda_once_ms(
        lambda: cd.dft_forward_reference(fwd, step.uvw, step.image))
    fwd_abs = float((got - want).abs().max())
    fwd_scale = float(want.abs().max())
    check(fwd_abs <= DFT_BOUND * fwd_scale,
          f"dft_forward vs plain at the step shape: {fwd_abs:.3e}")

    adj_ms = kernel_median_ms(lambda: cd.dft_adjoint(adj, step.uvw, resid))
    _, adj_plain_ms = cuda_once_ms(
        lambda: cd.dft_adjoint_reference(adj, step.uvw, resid))
    fwd_ms = kernel_median_ms(lambda: cd.dft_forward(fwd, step.uvw, step.image))
    adj_call_ms, _ = cuda_median_ms(lambda: vis_to_im(
        resid, step.uvw, step.grid_lm, step.frequency, step.flag[..., :1],
        plan=adj))
    fwd_call_ms, _ = cuda_median_ms(lambda: im_to_vis(
        step.image, step.uvw, step.lm, step.frequency, plan=fwd))
    gn_ms, _ = cuda_median_ms(lambda: gauss_newton(
        *meta, step.jones0, data, step.flag, step.model, step.weight,
        tol=0.0, maxiter=SELFCAL_GN_ITERS, table=table))
    clean_ms, _ = cuda_median_ms(lambda: hogbom_clean(
        dirty, step.psf, gamma=0.1, threshold=0.2, niter=50))
    # CLEAN's kernel against the plain loop on the step's own dirty image
    # and PSF: the same operations in the same rounding, so equal
    cgot = ch.hogbom(dirty, step.psf, 0.1, 0.2, 50)
    cwant, clean_plain_ms = cuda_once_ms(
        lambda: hogbom_clean_reference(dirty, step.psf, 0.1, 0.2, 50))
    for name, g, w in zip(("clean", "residual", "flags"), cgot, cwant):
        check(torch.equal(g, w), f"hogbom kernel vs plain at the step shape: {name}")
    clean_abs = max(float((g - w).abs().max()) for g, w in zip(cgot[:2], cwant[:2]))
    clean_kernel_ms = kernel_median_ms(
        lambda: ch.hogbom(dirty, step.psf, 0.1, 0.2, 50))
    ctas, rows, _, _ = ch.layout(npx, dirty.element_size())
    step_ms, step_runs = cuda_median_ms(lambda: step(data))
    step_host_ms = host_median_ms(lambda: step(data))
    nvis = nrow * nchan
    rate = nvis * SELFCAL_GN_ITERS / (step_ms / 1e3) / 1e6
    print(f"[9/{PHASES}] selfcal times on {card}: step {step_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.3f}' for t in step_runs)}) = {rate:.1f} "
          f"Mvis-iter/s (bench.py:1254's rate), host clock "
          f"{step_host_ms:.3f} ms; GN solve ({SELFCAL_GN_ITERS} it) "
          f"{gn_ms:.3f} ms; CLEAN {clean_ms:.3f} ms (kernel {clean_kernel_ms:.4f} "
          f"ms per launch, {ctas} block(s) of {rows} rows, {int(cgot[2].sum())} of 51 "
          f"iterations taken; plain loop {clean_plain_ms:.2f} ms, equal); dft_adjoint kernel "
          f"{adj_ms:.3f} ms per launch (CUDA graph of {BURST}), vis_to_im as the "
          f"step calls it {adj_call_ms:.3f} ms, plain {adj_plain_ms:.1f} ms "
          f"(residual image, {npx * npx} px x {nrow} rows x {nchan} chan); "
          f"dft_forward kernel {fwd_ms:.3f} ms per launch, im_to_vis "
          f"{fwd_call_ms:.3f} ms, plain {fwd_plain_ms:.1f} ms (re-predict); "
          f"the kernels line shows the per-launch times; plans: adjoint cg "
          f"{adj.cg} x {adj.ngroups} {adj.mode}, forward cg {fwd.cg} x "
          f"{fwd.ngroups} {fwd.mode}, every pair's rotation first order "
          f"{adj.delay_small >= adj.delay_max and fwd.delay_small >= fwd.delay_max}; "
          f"reruns bitwise; kernel vs plain max "
          f"abs err adjoint {adj_abs:.3e} (max {adj_scale:.3e}), forward "
          f"{fwd_abs:.3e} (max {fwd_scale:.3e})", flush=True)
    fwd_plan = (fwd.l, fwd.m, fwd.n1h, fwd.n1l, fwd.ftab_dev, fwd.rtab_dev,
                fwd.gtab_dev)
    adj_plan = (adj.l, adj.m, adj.n1h, adj.n1l, adj.ftab_dev, adj.rtab_dev,
                adj.gtab_dev)
    nsrc = step.lm.shape[0]
    return [
        {"name": "dft_forward", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/dft.cu",
         "replaces": "africanus_tpu/ops/pallas_dft.py:661",
         "launches": launches["dft_forward"], "max_abs_err": fwd_abs,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms,
         **bound(nbytes(fwd_plan, step.uvw, step.image, got),
                 nsrc * nrow * nchan * dft_fwd_instr(fwd.ncorr)),
         "library_ms": None},
        {"name": "dft_adjoint", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/dft.cu",
         "replaces": "africanus_tpu/ops/pallas_dft.py:445",
         "launches": launches["dft_adjoint"], "max_abs_err": adj_abs,
         "ms": adj_ms, "plain_ms": adj_plain_ms,
         **bound(nbytes(adj_plan, step.uvw, resid) + npx * npx * nchan * 4,
                 npx * npx * nrow * nchan * dft_adj_instr(adj.ncorr)),
         "library_ms": None},
        {"name": "hogbom", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/hogbom.cu", "replaces": None,
         "launches": launches["hogbom"], "max_abs_err": clean_abs,
         "ms": clean_kernel_ms, "plain_ms": clean_plain_ms,
         **bound(nbytes(dirty, step.psf, cgot), 0), "library_ms": None},
    ]


def wgrid_kernel_checks(device):
    """Phase 10: both wgrid kernels against their plain versions."""
    import torch
    from africanus_tpu_torch.ops import cuda_wgrid as cw

    rng = np.random.default_rng(SEED + 2)
    worst = {}
    cases = blocked = 0
    for support in cw.SUPPORTS:
        # one plane, a stack, and a deep stack (the degrid kernel stages
        # some of these in blocks of planes)
        for nplanes in (1, support + 6, 3 * support + 30):
            for nu, nv, n in WGRID_GRIDS:
                for dtype in (torch.float32, torch.float64):
                    plan, vis, grid = wgrid_problem(rng, n, nu, nv, nplanes,
                                                    support, dtype, device,
                                                    edges=True)
                    blocked += plan.stack_block < nplanes
                    before = (cw.grid_wstack.launches, cw.degrid_wstack.launches)
                    got_g = cw.grid_wstack(plan, vis)
                    got_d = cw.degrid_wstack(plan, grid)
                    torch.cuda.synchronize()
                    check((cw.grid_wstack.launches, cw.degrid_wstack.launches)
                          == (before[0] + 1, before[1] + 1), "wgrid launches")
                    tol = WGRID_BOUND if dtype == torch.float32 else 1e-12
                    prec = "f32" if dtype == torch.float32 else "f64"
                    for key, got, want in (
                            ("grid", got_g, cw.grid_wstack_reference(plan, vis)),
                            ("degrid", got_d, cw.degrid_wstack_reference(plan, grid))):
                        err = float((got - want).abs().max() / want.abs().max())
                        k = f"{key}/{prec}"
                        worst[k] = max(worst.get(k, 0.0), err)
                        check(err <= tol, f"{k} W={support} planes={nplanes} "
                                          f"{nu}x{nv}: {err:.3e} > {tol}")
                    cases += 1

    # two launches give bitwise-equal outputs
    plan, vis, grid = wgrid_problem(rng, 200_000, 1024, 1024, 9, 6,
                                    torch.float32, device)
    check(torch.equal(cw.grid_wstack(plan, vis), cw.grid_wstack(plan, vis)),
          "grid_wstack is not deterministic")
    check(torch.equal(cw.degrid_wstack(plan, grid), cw.degrid_wstack(plan, grid)),
          "degrid_wstack is not deterministic")
    check(blocked > 0, "no case staged its planes in blocks")
    plan, _, grid = wgrid_problem(rng, 100_000, 256, 256, 60, 10, torch.float64, device)
    check(plan.stack_block < 60, "the deep stack fits one block?")
    check(torch.equal(cw.degrid_wstack(plan, grid), cw.degrid_wstack(plan, grid)),
          "degrid_wstack in blocks of planes is not deterministic")
    print(f"[10/{PHASES}] wgrid kernels vs plain on the card ({cases} cases: "
          f"W {'/'.join(map(str, cw.SUPPORTS))} x 1 plane, W+6 and 3W+30 x f32/f64 "
          "x 64², 70x45, 12x10 and 5x7 grids (one tile; narrower than W), "
          "1007/333/50/40 samples with edge-wrapping windows, windows over "
          f"tile corners and in a tile's last cells, w-windows at both ends of "
          f"the stack; {blocked} with the degrid's planes in blocks; rel to "
          "max|out|): " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + "; deterministic (200k samples, 9 x 1024²; degrid 100k samples, "
          "60 x 256² in blocks of planes, f64)", flush=True)


def _l2(got, want):
    return float(np.sqrt(np.sum(np.abs(got - want) ** 2) / np.sum(np.abs(want) ** 2)))


def _profile(fn, reps=3):
    """(host ms of ``reps`` calls of ``fn`` to an idle card, device ms,
    [(kernel name, launches, device ms)] by device time) from
    torch.profiler. Only the device's own (kernel and copy) events count:
    an operator's row repeats the time of the kernels it launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return wall, sum(r[2] for r in rows), rows


def imaging(device, card):
    """Phases 11-12: config-4 w-stacked imaging. Returns the grid_wstack
    and degrid_wstack entries of the kernels line."""
    import torch
    from africanus_tpu_torch.gridding.wgridder import make_plan
    from africanus_tpu_torch.gridding.wgridder.core import (
        grid_to_image, image_to_grid,
    )
    from africanus_tpu_torch.gridding.wgridder.imaging import (
        WStackImaging, dirty_oracle_f64, from_numpy, imaging_inputs,
    )
    from africanus_tpu_torch.ops import cuda_wgrid as cw

    args = imaging_inputs(**IMAGING)
    nx, cell = args["nx"], args["cell"]
    # the API's cached plan, cold and then cached (bench.py:941-951)
    plan_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        make_plan(args["uvw"], args["freq"], nx, nx, cell, cell, IMAGING_EPS,
                  True, device=device)
        torch.cuda.synchronize()
        plan_s.append(time.perf_counter() - t0)
    module, vis, image = from_numpy(args, device)
    iplan, plan = module.plan, module.plan.wgrid
    nrow, nchan = vis.shape
    nvis = nrow * nchan
    torch.cuda.synchronize()

    # 11. the path once, through the kernels
    cw.grid_wstack.launches = cw.degrid_wstack.launches = 0
    t0 = time.perf_counter()
    dirty = module(vis)
    model = module.degrid(image)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"grid_wstack": cw.grid_wstack.launches,
                "degrid_wstack": cw.degrid_wstack.launches}
    check(launches == {"grid_wstack": 1, "degrid_wstack": 1},
          f"imaging launches {launches}")
    check(tuple(dirty.shape) == (nx, nx) and dirty.dtype == torch.float32,
          f"dirty {tuple(dirty.shape)} {dirty.dtype}")
    check(tuple(model.shape) == (nrow, nchan) and model.dtype == torch.complex64,
          f"model {tuple(model.shape)} {model.dtype}")
    check(bool(torch.isfinite(dirty).all())
          and bool(torch.isfinite(torch.view_as_real(model)).all()),
          "non-finite dirty image or model")

    # kernels against their plain versions at the full shape, on the card
    v = vis.reshape(-1)
    grid = cw.grid_wstack(plan, v)
    grid_p, grid_plain_ms = cuda_once_ms(lambda: cw.grid_wstack_reference(plan, v))
    grid_abs = float((grid - grid_p).abs().max())
    grid_scale = float(grid_p.abs().max())
    check(grid_abs <= WGRID_BOUND * grid_scale,
          f"grid kernel vs plain: {grid_abs:.3e} > 1e-5 x {grid_scale:.3e}")
    dirty_p = grid_to_image(iplan, grid_p)
    dirty_err = float((dirty - dirty_p).abs().max() / dirty_p.abs().max())
    check(dirty_err <= WGRID_BOUND, f"dirty vs plain: {dirty_err:.3e}")
    del grid_p, dirty_p
    g = image_to_grid(iplan, image)
    model_p, degrid_plain_ms = cuda_once_ms(lambda: cw.degrid_wstack_reference(plan, g))
    degrid_abs = float((model.reshape(-1) - model_p).abs().max())
    degrid_scale = float(model_p.abs().max())
    check(degrid_abs <= WGRID_BOUND * degrid_scale,
          f"degrid vs plain: {degrid_abs:.3e} > 1e-5 x {degrid_scale:.3e}")
    del model_p

    # adjointness: <x, grid(y)> = Re <degrid(x), y>
    lhs = float((dirty.double() * image.double()).sum())
    rhs = float((model.real.double() * vis.real.double()
                 + model.imag.double() * vis.imag.double()).sum())
    adjoint = abs(lhs - rhs) / abs(lhs)
    check(adjoint <= 1e-5, f"adjointness {adjoint:.3e} > 1e-5")

    # the bench's accuracy check against the explicit w-aware DFT
    chk = args["check"]
    small = WStackImaging(chk["uvw"].astype(np.float32),
                          chk["freq"].astype(np.float32), chk["nx"], chk["nx"],
                          chk["cell"], epsilon=IMAGING_EPS, device=device)
    got = small(torch.as_tensor(chk["vis"].astype(np.complex64), device=device))
    l2 = _l2(got.cpu().numpy().astype(np.float64),
             dirty_oracle_f64(chk["uvw"], chk["freq"], chk["vis"], chk["nx"],
                              chk["cell"]))
    check(l2 <= IMAGING_EPS, f"explicit-DFT l2 {l2:.3e} > {IMAGING_EPS}")
    print(f"[11/{PHASES}] imaging (config 4): {nrow} rows x {nchan} chan, "
          f"{nx}² image, eps {IMAGING_EPS}, W {plan.support}, {plan.nplanes} "
          f"w-planes ({plan.nu}² grid, {plan.ntiles} tiles); plan cold "
          f"{plan_s[0]:.3f} s, cached {plan_s[1]:.4f} s; dirty + degrid in "
          f"{wall:.3f} s wall (first call); launches {launches}; kernel vs "
          f"plain: grid max abs {grid_abs:.3e} (max {grid_scale:.3e}), dirty "
          f"{dirty_err:.2e} rel, degrid max abs {degrid_abs:.3e} (max "
          f"{degrid_scale:.3e}); adjointness {adjoint:.2e}; explicit-DFT l2 "
          f"{l2:.3e} (400 rows, 32², 2 chan; bound {IMAGING_EPS})", flush=True)

    # 12. times
    grid_ms = kernel_median_ms(lambda: cw.grid_wstack(plan, v))
    degrid_ms = kernel_median_ms(lambda: cw.degrid_wstack(plan, g))
    dirty_ms, dirty_runs = cuda_median_ms(lambda: module(vis))
    model_ms, model_runs = cuda_median_ms(lambda: module.degrid(image))
    ifft_ms, _ = cuda_median_ms(lambda: torch.fft.ifft2(grid, norm="forward"))
    fft_ms, _ = cuda_median_ms(lambda: torch.fft.fft2(grid))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    module(vis)
    module.degrid(image)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof_wall, prof_busy, rows = _profile(lambda: (module(vis), module.degrid(image)))
    top = "; ".join(f"{name[:48]} x{count // 3} {ms / 3:.3f} ms"
                    for name, count, ms in rows[:8])
    print(f"[12/{PHASES}] imaging times on {card}: dirty {dirty_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.3f}' for t in dirty_runs)}) = "
          f"{nvis / dirty_ms / 1e3:.1f} Mvis/s, degrid {model_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.3f}' for t in model_runs)}) = "
          f"{nvis / model_ms / 1e3:.1f} Mvis/s; kernels (CUDA graph of {BURST}): "
          f"grid_wstack {grid_ms:.4f} ms (one kernel, no fold; tiles of "
          f"{plan.tile_u}, {plan.plane_block} planes per block, {plan.groups} "
          f"consumer groups, {plan.nentries / max(plan.nsamples, 1):.3f} entries "
          f"per sample), degrid_wstack {degrid_ms:.4f} ms (tile gather, "
          f"{plan.nstack} blocks of {plan.stack_block} planes; was "
          f"{PREVIOUS_MS['degrid_wstack']}); FFTs: ifft2 "
          f"{ifft_ms:.4f} ms = {ifft_ms / dirty_ms:.1%} of dirty, fft2 "
          f"{fft_ms:.4f} ms = {fft_ms / model_ms:.1%} of degrid; plain "
          f"grid_wstack_reference {grid_plain_ms:.1f} ms, "
          f"degrid_wstack_reference {degrid_plain_ms:.1f} ms; peak device "
          f"memory {peak:.2f} GiB; profiler over 3 x (dirty + degrid): host "
          f"{prof_wall / 3:.3f} ms, device busy {prof_busy / 3:.3f} ms "
          f"(idle {1 - prof_busy / prof_wall:.1%}), per iteration: {top}",
          flush=True)

    # the map's own operands (the window starts, offsets and w-taps of
    # the Pallas kernels), not the port's sample order and entry lists
    geometry = (plan.iu0, plan.iv0, plan.p0, plan.uf, plan.vf, plan.wsc)
    taps = nvis * plan.wsup * plan.support ** 2
    es = nvis * 2 * plan.support * ES_INSTR
    entries = [
        {"name": "grid_wstack", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/wgrid.cu",
         "replaces": "africanus_tpu/ops/pallas_grid.py:2243, "
                     "africanus_tpu/ops/pallas_grid.py:1807",
         "launches": launches["grid_wstack"], "max_abs_err": grid_abs,
         "ms": grid_ms, "plain_ms": grid_plain_ms,
         **bound(nbytes(geometry, v, grid),
                 taps * GRID_TAP_INSTR + es),
         "library_ms": None},
        {"name": "degrid_wstack", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/wgrid.cu",
         "replaces": "africanus_tpu/ops/pallas_grid.py:2380, "
                     "africanus_tpu/ops/pallas_grid.py:1981",
         "launches": launches["degrid_wstack"], "max_abs_err": degrid_abs,
         "ms": degrid_ms, "plain_ms": degrid_plain_ms,
         **bound(nbytes(geometry, g, model), taps * DEGRID_TAP_INSTR + es),
         "library_ms": None},
    ]
    del module, vis, image, grid, g, dirty, model, plan, iplan, small
    torch.cuda.empty_cache()

    # the larger cell (ROADMAP item 14), dirty and degrid alone
    t0 = time.perf_counter()
    args = imaging_inputs(**IMAGING_LARGE)
    module, vis, image = from_numpy(args, device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    iplan, plan = module.plan, module.plan.wgrid
    check(plan.nplanes >= 16, f"large cell: {plan.nplanes} planes < 16")
    nvis = vis.numel()
    torch.cuda.reset_peak_memory_stats()
    dirty = module(vis)
    model = module.degrid(image)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(bool(torch.isfinite(dirty).all())
          and bool(torch.isfinite(torch.view_as_real(model)).all()),
          "large cell: non-finite dirty image or model")
    # kernels against their plain versions at this set-up too (17 planes,
    # 10-cell tiles of a 2048² grid), as in phase 11
    v = vis.reshape(-1)
    grid = cw.grid_wstack(plan, v)
    grid_p = cw.grid_wstack_reference(plan, v)
    grid_l_abs = float((grid - grid_p).abs().max())
    grid_l_scale = float(grid_p.abs().max())
    check(grid_l_abs <= WGRID_BOUND * grid_l_scale,
          f"large cell: grid kernel vs plain {grid_l_abs:.3e} > 1e-5 x "
          f"{grid_l_scale:.3e}")
    del grid, grid_p
    g = image_to_grid(iplan, image)
    model_p = cw.degrid_wstack_reference(plan, g)
    degrid_l_abs = float((cw.degrid_wstack(plan, g) - model_p).abs().max())
    degrid_l_scale = float(model_p.abs().max())
    check(degrid_l_abs <= WGRID_BOUND * degrid_l_scale,
          f"large cell: degrid kernel vs plain {degrid_l_abs:.3e} > 1e-5 x "
          f"{degrid_l_scale:.3e}")
    del model_p
    grid_l_ms = kernel_median_ms(lambda: cw.grid_wstack(plan, v))
    degrid_l_ms = kernel_median_ms(lambda: cw.degrid_wstack(plan, g))
    dirty_ms, _ = cuda_median_ms(lambda: module(vis), reps=5, warmup=1)
    model_ms, _ = cuda_median_ms(lambda: module.degrid(image), reps=5, warmup=1)
    print(f"[12/{PHASES}] larger cell on {card}: {args['nx']}² image, "
          f"{vis.shape[0]} rows x {vis.shape[1]} chan, w extent umax/"
          f"{IMAGING_LARGE['w_div']}, {plan.nplanes} w-planes ({plan.nu}² grid, "
          f"{plan.ntiles} tiles of {plan.tile_u}, {plan.plane_block} planes per "
          f"block, {plan.groups} consumer groups, "
          f"{plan.nentries / max(plan.nsamples, 1):.3f} entries per sample), set-up "
          f"with plan {setup:.1f} s; kernel vs plain: grid max abs "
          f"{grid_l_abs:.3e} (max {grid_l_scale:.3e}), degrid max abs "
          f"{degrid_l_abs:.3e} (max {degrid_l_scale:.3e}); dirty "
          f"{dirty_ms:.3f} ms = {nvis / dirty_ms / 1e3:.1f} Mvis/s, degrid "
          f"{model_ms:.3f} ms = {nvis / model_ms / 1e3:.1f} Mvis/s; kernels "
          f"grid_wstack {grid_l_ms:.4f} ms, degrid_wstack {degrid_l_ms:.4f} ms "
          f"(tile gather, {plan.nstack} blocks of {plan.stack_block} planes; was "
          f"{PREVIOUS_MS['degrid_wstack_large']}) (CUDA graph of {BURST}); peak "
          f"device memory {peak:.2f} GiB",
          flush=True)
    return entries


def _tensors(ops):
    return [x for x in ops if hasattr(x, "numel")]


def _beam_counts():
    from africanus_tpu_torch.ops import cuda_beam as cb

    return {"beam_interp": cb.beam_interp.launches,
            "beam_blend": cb.beam_blend.launches,
            "beam_blend_cell": cb.beam_blend_cell.launches}


def _zero_beam_counts():
    from africanus_tpu_torch.ops import cuda_beam as cb

    cb.beam_interp.launches = cb.beam_blend.launches = 0
    cb.beam_blend_cell.launches = 0


def _to_f64(args):
    """Floating tensors of ``args`` in float64 (complex128), the rest as
    they are."""
    import torch

    return tuple(x.to(torch.complex128) if hasattr(x, "is_complex") and x.is_complex()
                 else x.double() if hasattr(x, "is_floating_point") and x.is_floating_point()
                 else x for x in args)


def beam_kernel_checks(device):
    """Phase 13: the three beam kernels against their plain versions, and
    the float32 blends against a float64 oracle (the plain version on the
    same operands in float64)."""
    import torch
    from africanus_tpu_torch.ops import cuda_beam as cb
    from africanus_tpu_torch.rime.feeds import feed_rotation

    rng = np.random.default_rng(SEED + 3)
    worst, f64_err = {}, {}
    cases = 0

    def compare(key, fn, reference, args, tol, launches=1):
        before = _beam_counts()
        got = fn(*args)
        torch.cuda.synchronize()
        after = _beam_counts()
        n = after[fn.__name__] - before[fn.__name__]
        check(n == launches, f"{key}: {n} launches, not {launches}")
        want = reference(*args)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{key}: {tuple(got.shape)} {got.dtype}")
        err = float((got - want).abs().max() / want.abs().max())
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= tol, f"{key}: {err:.3e} > {tol}")

    for dtype in (torch.float32, torch.float64):
        tol = BEAM_BOUND if dtype == torch.float32 else BEAM_BOUND_F64
        prec = "f32" if dtype == torch.float32 else "f64"
        # 3 and 8 correlations: launches of 2 + 1 and 4 + 4
        for ncorr in (*cb.CORRS, 3, 8):
            k = len(cb._groups(ncorr))
            for nsamp, nchan in ((1000, 300), (37, 5), (515, 1)):
                p = beam_problem(rng, nsamp, nchan, ncorr, dtype, device)
                slabs, nud = p["slabs"], p["slabs"].shape[0]
                for norm in (True, False):
                    compare(f"interp/{prec}", cb.beam_interp, cb.beam_interp_reference,
                            (slabs, p["vl"], p["vm"], p["gc0"], p["gc1"], p["wlo"],
                             norm), tol, k)
                for ncol in (1, 4):  # rows sharing coordinate columns
                    rows = torch.arange(nud, dtype=torch.int32,
                                        device=device).repeat(ncol)
                    ones = torch.ones(rows.shape[0], dtype=dtype, device=device)
                    compare(f"interp/{prec}", cb.beam_interp, cb.beam_interp_reference,
                            (slabs, p["vl"][:, :ncol].contiguous(),
                             p["vm"][:, :ncol].contiguous(), rows, rows, ones,
                             False), tol, k)
                feeds = [None]
                if ncorr == 4:
                    feeds += [feed_rotation(p["pa"], ft).contiguous()
                              for ft in ("linear", "circular")]
                for feed in feeds:
                    blends = (("blend", cb.beam_blend, cb.beam_blend_reference,
                               (p["raw"], p["gc0"], p["wlo"], feed)),
                              ("blend_cell", cb.beam_blend_cell,
                               cb.beam_blend_cell_reference,
                               (p["bt"], p["lda"], p["mda"], p["gc0"], p["wlo"],
                                feed)))
                    for key, fn, reference, args in blends:
                        compare(f"{key}/{prec}", fn, reference, args, tol, k)
                        if dtype != torch.float32:
                            continue
                        # the uncontracted blends (F4) and their plain
                        # versions against float64 on the same operands
                        want = reference(*_to_f64(args))
                        for who, got in (("kernel", fn(*args)), ("plain", reference(*args))):
                            err = float((got.to(want.dtype) - want).abs().max()
                                        / want.abs().max())
                            f64_err[f"{key} {who}"] = max(
                                f64_err.get(f"{key} {who}", 0.0), err)
                        # a reading, not a bar: the float32 plain version
                        # is itself ~2e-5 of max away near a small amplitude
                        check(np.isfinite(f64_err[f"{key} kernel"]),
                              f"{key}/f32 vs f64: not finite")
                cases += 1

        # corners: integer coordinates, one slab per row, exact
        li = torch.as_tensor(rng.integers(0, 17, 500), device=device)
        mi = torch.as_tensor(rng.integers(0, 13, 500), device=device)
        rows = torch.arange(nud, dtype=torch.int32, device=device)
        raw = cb.beam_interp(slabs, li[:, None].to(dtype), mi[:, None].to(dtype),
                             rows, rows, torch.ones(nud, dtype=dtype, device=device),
                             False)
        check(torch.equal(raw, slabs.permute(1, 2, 0, 3)[li, mi]),
              f"interp/{prec}: corner values not exact")
        # and on the cell-corner layout: four integer columns, a row per slab
        li4, mi4 = li.reshape(125, 4), mi.reshape(125, 4)
        rows4 = rows.repeat(4)
        raw = cb.beam_interp(slabs, li4.to(dtype), mi4.to(dtype), rows4, rows4,
                             torch.ones(4 * nud, dtype=dtype, device=device), False)
        want = slabs.permute(1, 2, 0, 3)[li4.repeat_interleave(nud, 1),
                                         mi4.repeat_interleave(nud, 1), rows4]
        check(torch.equal(raw, want), f"interp/{prec}: cell-corner layout not exact")

    # two launches give bitwise-equal outputs (config 3's shapes; interp on
    # its three layouts)
    p = beam_problem(rng, 512, 4096, 4, torch.float32, device, lw=129, mh=129)
    feed = feed_rotation(p["pa"], "linear").contiguous()
    rows = torch.arange(8, dtype=torch.int32, device=device)
    ones = torch.ones(32, dtype=torch.float32, device=device)
    for fn, args in ((cb.beam_interp, (p["slabs"], p["vl"], p["vm"], p["gc0"],
                                       p["gc1"], p["wlo"], True)),
                     (cb.beam_interp, (p["slabs"], p["vl"][:, :1].contiguous(),
                                       p["vm"][:, :1].contiguous(), rows, rows,
                                       ones[:8], False)),
                     (cb.beam_interp, (p["slabs"], p["vl"][:, :4].contiguous(),
                                       p["vm"][:, :4].contiguous(), rows.repeat(4),
                                       rows.repeat(4), ones, False)),
                     (cb.beam_blend, (p["raw"], p["gc0"], p["wlo"], feed)),
                     (cb.beam_blend_cell, (p["bt"], p["lda"], p["mda"], p["gc0"],
                                           p["wlo"], feed))):
        check(torch.equal(fn(*args), fn(*args)), f"{fn.__name__} is not deterministic")
    print(f"[13/{PHASES}] beam kernels vs plain on the card ({cases} problems: "
          "C 1/2/4 and 3/8 (2 + 1 and 4 + 4 launches) x f32/f64 x (1000 samples "
          "x 300 chan, 37 x 5, 515 x 1), interp "
          "normalised, raw and on shared columns, blend and blend_cell with no, "
          "linear and circular feeds, out-of-cube frequencies; rel to max|out|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + "; corners exact (also on the cell-corner layout); deterministic "
          "(512 x 4096, 129² cube; interp on its three layouts); f32 blends vs "
          "a float64 oracle on the same operands (F4): "
          + ", ".join(f"{k} {v:.2e}" for k, v in f64_err.items()), flush=True)


def interp_bound(ops, out):
    """beam_interp's bound at a route's own operands ``ops`` and output
    ``out``: the bytes of the coordinates, the row tables, the output and
    the (slab, cell) pairs that the samples' values depend on (nonzero
    weight), read once; BEAM_INTERP_INSTR (normalised) or
    BEAM_INTERP_RAW_INSTR per (sample, row)."""
    import torch

    slabs, vl, vm, gc0, gc1, wlo, normalize = ops
    nud, lw, mh, k3 = slabs.shape
    per = gc0.shape[0] // vl.shape[1]
    l, m = vl.repeat_interleave(per, 1), vm.repeat_interleave(per, 1)
    ld, md = l - torch.floor(l), m - torch.floor(m)
    l0 = torch.floor(l).long().clamp(0, lw - 1)
    m0 = torch.floor(m).long().clamp(0, mh - 1)
    cells = []
    for g, w in ((gc0, wlo), (gc1, 1 - wlo)):
        slab = g.long().clamp(0, nud - 1) * (lw * mh)
        for dl, wl in ((0, 1 - ld), (1, ld)):
            for dm, wm in ((0, 1 - md), (1, md)):
                key = (slab + (l0 + dl).clamp(max=lw - 1) * mh
                       + (m0 + dm).clamp(max=mh - 1))
                cells.append(key.expand_as(l)[(w * wl * wm) != 0])
    ncells = torch.unique(torch.cat(cells)).numel()
    moved = nbytes(vl, vm, gc0, gc1, wlo, out) + ncells * k3 * slabs.element_size()
    instr = BEAM_INTERP_INSTR if normalize else BEAM_INTERP_RAW_INSTR
    return bound(moved, out.shape[0] * out.shape[1] * instr)


def beam_chain(device, card):
    """Phases 14-15: the config-3 beam DDE chain. Returns the beam_interp,
    beam_blend and beam_blend_cell entries of the kernels line."""
    import torch
    import torch.nn.functional as F
    from africanus_tpu_torch.ops import cuda_beam as cb
    from africanus_tpu_torch.rime.beam_chain import (
        beam_inputs, beam_oracle_f64, from_numpy,
    )

    t0 = time.perf_counter()
    args = beam_inputs(**BEAM)
    legs = {
        "fast": from_numpy(args, device),
        "tvar": from_numpy(dict(args, pe=args["pe_tvar"]), device, feed_type=None),
        "general": from_numpy(dict(args, pe=args["pe_pc"]), device, feed_type=None,
                              chan_invariant=False, cell_residual=False),
        "cell": from_numpy(dict(args, pe=args["pe_pc"]), device, feed_type=None,
                           chan_invariant=False, cell_residual=True),
    }
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    chain, pa = legs["fast"]
    nsrc, ntime, nant, nchan = 8, 1, BEAM["nant"], BEAM["nchan"]
    nsamp = nsrc * ntime * nant * nchan

    # 14. each leg once, through its kernels
    outs, counts, walls = {}, {}, {}
    for name, (module, pa_) in legs.items():
        _zero_beam_counts()
        t0 = time.perf_counter()
        outs[name] = module(pa_)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        counts[name] = _beam_counts()
    expect = {"fast": (1, 1, 0), "tvar": (1, 1, 0), "general": (1, 0, 0),
              "cell": (1, 0, 1)}
    for name, n in expect.items():
        check(tuple(counts[name].values()) == n, f"{name} leg launches {counts[name]}")
        out = outs[name]
        check(tuple(out.shape) == (nsrc, ntime, nant, nchan, 2, 2)
              and out.dtype == torch.complex64, f"{name}: {tuple(out.shape)} {out.dtype}")
        check(bool(torch.isfinite(torch.view_as_real(out)).all()), f"{name}: non-finite")
    launches = {k: sum(c[k] for c in counts.values()) for k in counts["fast"]}

    chans = np.unique(np.linspace(0, nchan - 1, BEAM_ORACLE_CHANS).round().astype(int))
    t0 = time.perf_counter()
    want = beam_oracle_f64(args, chans)
    oracle_s = time.perf_counter() - t0
    got = outs["fast"][:, :, :, torch.as_tensor(chans, device=device)].cpu().numpy()
    fast_err = rel_err(got, want)
    check(fast_err <= BEAM_BOUND, f"fast path vs f64 oracle: {fast_err:.3e}")
    # time-varying pointing is chan-invariant: the general route agrees
    tvar_general = from_numpy(dict(args, pe=args["pe_tvar"]), device, feed_type=None,
                              chan_invariant=False, cell_residual=False)[0](pa)
    tvar_err = float((outs["tvar"] - tvar_general).abs().max()
                     / tvar_general.abs().max())
    check(tvar_err <= BEAM_BOUND, f"time-varying leg vs general route: {tvar_err:.3e}")
    del tvar_general
    # per-channel pointing: on the bench's draws (σ 1e-4 against a 3.1e-4
    # cube cell) the cell route extrapolates the cell polynomial on samples
    # whose channels straddle cells, a property of the data; with the
    # errors cut 100-fold most samples stay in one cell, and there the cell
    # route equals the general route
    def in_cell(ops):
        lda, mda = ops["beam_blend_cell"][1:3]
        return ((lda.amax(dim=1) <= 1) & (mda.amax(dim=1) <= 1)).reshape(
            nsrc, ntime, nant)

    _, cell_ops = legs["cell"][0].kernel_operands(pa)
    straddle = 1 - float(in_cell(cell_ops).float().mean())
    cell_err = float((outs["cell"] - outs["general"]).abs().max()
                     / outs["general"].abs().max())
    small = dict(args, pe=args["pe_pc"] / 100)
    m_cell = from_numpy(small, device, feed_type=None, chan_invariant=False,
                        cell_residual=True)[0]
    m_gen = from_numpy(small, device, feed_type=None, chan_invariant=False,
                       cell_residual=False)[0]
    inside = in_cell(m_cell.kernel_operands(pa)[1])
    check(bool(inside.any()), "no in-cell sample at pe / 100")
    want_gen = m_gen(pa)
    cell_in_err = float((m_cell(pa) - want_gen).abs()[inside].max()
                        / want_gen.abs().max())
    check(cell_in_err <= BEAM_BOUND, f"cell route on in-cell samples: {cell_in_err:.3e}")
    inside_share = float(inside.float().mean())
    del m_cell, m_gen, want_gen
    print(f"[14/{PHASES}] beam chain (config 3): {nsrc} src x {ntime} time x {nant} "
          f"ant x {nchan} chan = {nsamp} samples x 4 corr, 129² x 8 x 4 cube; set-up "
          f"{setup:.1f} s; first calls (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f"; launches {counts}; fast E·F vs f64 oracle ({chans.size} chan) "
          f"{fast_err:.2e} (bound {BEAM_BOUND}; oracle {oracle_s:.1f} s); "
          f"time-varying vs general route {tvar_err:.2e}; cell vs general "
          f"{cell_err:.2e} ({straddle:.1%} of (src, time, ant) samples straddle a "
          f"cell); with pe / 100 ({inside_share:.1%} in-cell) cell vs general on "
          f"in-cell samples {cell_in_err:.2e} (JAX package, TPU: {JAX_CONFIG3})",
          flush=True)
    del outs

    # 15. times: each kernel at the legs' shapes, against its plain version
    _, gen_ops = legs["general"][0].kernel_operands(pa)
    _, fast_ops = chain.kernel_operands(pa)
    entries = []
    times = {}
    for name, ops, plain, instr in (
            ("beam_interp", gen_ops["beam_interp"], cb.beam_interp_reference,
             nsamp * BEAM_INTERP_INSTR),
            ("beam_blend", fast_ops["beam_blend"], cb.beam_blend_reference,
             nsamp * BEAM_BLEND_INSTR),
            ("beam_blend_cell", cell_ops["beam_blend_cell"],
             cb.beam_blend_cell_reference, nsamp * BEAM_CELL_INSTR)):
        fn = getattr(cb, name)
        got = fn(*ops)
        want, plain_ms = cuda_once_ms(lambda: plain(*ops))
        max_abs = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(max_abs <= BEAM_BOUND * scale,
              f"{name} vs plain at config 3: {max_abs:.3e} > 1e-5 x {scale:.3e}")
        # beam_interp's time and bound: below, on each of its routes
        ms = None if name == "beam_interp" else kernel_median_ms(lambda: fn(*ops))
        times[name] = (ms, plain_ms, max_abs, scale)
        entries.append({
            "name": name, "route": "cuda",
            "source": "africanus_tpu_torch/csrc/beam.cu",
            "replaces": {"beam_interp": "africanus_tpu/ops/pallas_beam.py:228",
                         "beam_blend": "africanus_tpu/ops/pallas_beam.py:538",
                         "beam_blend_cell": "africanus_tpu/ops/pallas_beam.py:450"}[name],
            "launches": launches[name], "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, **bound(nbytes(_tensors(ops), got), instr),
            "library_ms": None})
        del got, want
    # beam_interp on its three routes: against the plain version, its time
    # and its bound
    routes = {"general": gen_ops["beam_interp"],
              "chan-invariant": fast_ops["beam_interp"],
              "cell corners": cell_ops["beam_interp"]}
    interp = {}
    for route, ops in routes.items():
        got = cb.beam_interp(*ops)
        want = cb.beam_interp_reference(*ops)
        err = float((got - want).abs().max() / want.abs().max())
        check(err <= BEAM_BOUND, f"beam_interp {route} vs plain: {err:.3e}")
        lay = cb.interp_layout(got.shape[0], got.shape[1], ops[6],
                               cb._sm_count(got.device.index))
        interp[route] = {"ms": kernel_median_ms(lambda: cb.beam_interp(*ops)),
                         "err": err, "bound": interp_bound(ops, got),
                         "blocks": lay.blocks[0] * lay.blocks[1]}
        del got, want
    empty_ms = kernel_median_ms(lambda: torch.cuda._sleep(0))
    times["beam_interp"] = (interp["general"]["ms"],) + times["beam_interp"][1:]
    entries[0].update(ms=interp["general"]["ms"], **interp["general"]["bound"])

    # the library yardstick of beam_interp: grid_sample's trilinear
    # interpolation of the (1, 3C, nud, mh, lw) volume at the general
    # route's coordinates and fractional slab gc0 + 1 - wlo
    slabs, vl, vm, gc0, _, wlo, _ = gen_ops["beam_interp"]
    nud, lw, mh, k3 = slabs.shape
    vol = slabs.permute(3, 0, 2, 1)[None].contiguous()
    z = ((gc0 + 1 - wlo) / (nud - 1) * 2 - 1).expand_as(vl)
    grid = torch.stack([vl / (lw - 1) * 2 - 1, vm / (mh - 1) * 2 - 1, z],
                       dim=-1)[None, None].contiguous()

    def sample():
        return F.grid_sample(vol, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    library_ms, _ = cuda_median_ms(sample)
    raw = cb.beam_interp(*gen_ops["beam_interp"][:6], False)
    lib_err = float((sample()[0, :, 0].permute(1, 2, 0) - raw).abs().max()
                    / raw.abs().max())
    entries[0]["library_ms"] = library_ms
    del vol, grid, raw

    leg_ms = {name: cuda_median_ms(lambda m=m, p=p: m(p))[0]
              for name, (m, p) in legs.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m, p in legs.values():
        m(p)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    profiles = {name: _profile(lambda m=m, p=p: m(p)) for name, (m, p) in legs.items()}
    print(f"[15/{PHASES}] beam times on {card}: legs (CUDA-event medians) "
          + ", ".join(f"{k} {v:.3f} ms = {nsamp / v / 1e3:.1f} Msamples/s"
                      for k, v in leg_ms.items())
          + f"; kernels (CUDA graph of {BURST}): beam_interp "
          + ", ".join(f"{r} {v['ms']:.4f} ms (bound {v['bound']['bound_ms']:.4f}, "
                      f"{v['bound']['bound_by']}; {v['blocks']} blocks; vs plain "
                      f"{v['err']:.1e})" for r, v in interp.items())
          + f"; empty kernel {empty_ms:.4f} ms (the previous design's: "
          f"{PREVIOUS_MS['beam_interp']})"
          + f"; beam_blend {times['beam_blend'][0]:.4f} ms (bound "
          f"{entries[1]['bound_ms']:.4f}); beam_blend_cell "
          f"{times['beam_blend_cell'][0]:.4f} ms (bound {entries[2]['bound_ms']:.4f}); "
          f"grid_sample {library_ms:.4f} ms (vs raw interp {lib_err:.1e}); plain "
          + ", ".join(f"{k} {v[1]:.1f} ms" for k, v in times.items())
          + "; kernel vs plain max abs "
          + ", ".join(f"{k} {v[2]:.2e} (max {v[3]:.2e})" for k, v in times.items())
          + f"; peak device memory {peak:.2f} GiB", flush=True)
    for name, (wall, busy, rows) in profiles.items():
        top = "; ".join(f"{k[:40]} x{count // 3} {ms / 3:.4f} ms"
                        for k, count, ms in rows[:5])
        print(f"[15/{PHASES}] profiler, {name} leg, per call of 3: host {wall / 3:.3f} "
              f"ms, device busy {busy / 3:.4f} ms (idle {1 - busy / wall:.1%}), "
              f"by device time: {top}", flush=True)
    return entries


def gridder_kernel_checks(device):
    """Phase 16: the 2D multi-correlation and table kernels against their
    plain versions."""
    import torch
    from africanus_tpu_torch.ops import cuda_grid2d as g2
    from africanus_tpu_torch.ops import cuda_gridtab as gt
    from africanus_tpu_torch.ops.cuda_wgrid import SUPPORTS

    rng = np.random.default_rng(SEED + 4)
    worst = {}
    cases = 0

    def compare(key, fn, plain, args, tol, launches=1):
        before = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        check(fn.launches == before + launches,
              f"{key}: {fn.launches - before} launches, not {launches}")
        want = plain(*args)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{key}: {tuple(got.shape)} {got.dtype}")
        err = float((got - want).abs().max() / want.abs().max())
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= tol, f"{key}: {err:.3e} > {tol}")

    for dtype in (torch.float32, torch.float64):
        tol = GRIDDER_BOUND if dtype == torch.float32 else 1e-12
        prec = "f32" if dtype == torch.float32 else "f64"
        for support in SUPPORTS:
            # 3 correlations: one grid launch, 2 + 1 degrid launches
            for ncorr, ndegrid in ((1, 1), (2, 1), (3, 2), (4, 1)):
                for nu, nv, n in WGRID_GRIDS:
                    plan, vis, grid = grid2d_problem(rng, n, nu, nv, ncorr, support,
                                                     dtype, device, edges=True)
                    compare(f"grid_2d/{prec}", g2.grid_2d, g2.grid_2d_reference,
                            (plan, vis), tol)
                    compare(f"degrid_2d/{prec}", g2.degrid_2d,
                            g2.degrid_2d_reference, (plan, grid), tol, ndegrid)
                    cases += 1
        # supports 17, 29 and 31: one, two and three residues a consumer
        # of the table spread (gridding.cuh)
        for support in (3, 5, 7, 15, 17, 29, 31):
            for oversample in (5, 63):
                for npix, n in ((64, 1007), (37, 333), (5, 40)):
                    plan, table, vals, grid = table_problem(
                        rng, n, npix, 2, support, oversample, dtype, device)
                    compare(f"grid_table/{prec}", gt.grid_table,
                            gt.grid_table_reference, (plan, table, vals), tol)
                    compare(f"degrid_table/{prec}", gt.degrid_table,
                            gt.degrid_table_reference, (plan, table, grid), tol)
                    cases += 1
    # complex128 at W = 15, oversampling 1023: the table read from device
    # memory by both kernels
    plan, table, vals, grid = table_problem(rng, 1007, 64, 2, 15, 1023,
                                            torch.float64, device)
    check(gt._spread_table_smem(plan) == 0 and gt._gather_table_smem(plan) == 0,
          "the 1023-oversampled table fits?")
    compare("grid_table/f64-os1023", gt.grid_table, gt.grid_table_reference,
            (plan, table, vals), 1e-12)
    compare("degrid_table/f64-os1023", gt.degrid_table, gt.degrid_table_reference,
            (plan, table, grid), 1e-12)

    # two launches give bitwise-equal outputs
    plan, vis, grid = grid2d_problem(rng, 200_000, 1024, 1024, 4, 8, torch.float32,
                                     device)
    check(torch.equal(g2.grid_2d(plan, vis), g2.grid_2d(plan, vis)),
          "grid_2d is not deterministic")
    check(torch.equal(g2.degrid_2d(plan, grid), g2.degrid_2d(plan, grid)),
          "degrid_2d is not deterministic")
    plan, table, vals, grid = table_problem(rng, 200_000, 1024, 2, 7, 63,
                                            torch.float32, device)
    check(torch.equal(gt.grid_table(plan, table, vals),
                      gt.grid_table(plan, table, vals)),
          "grid_table is not deterministic")
    check(torch.equal(gt.degrid_table(plan, table, grid),
                      gt.degrid_table(plan, table, grid)),
          "degrid_table is not deterministic")
    # several residues a spread consumer, the gather's taps formed per step,
    # in float64
    for support in (29, 31):
        plan, table, vals, grid = table_problem(rng, 20_000, 256, 2, support, 63,
                                                torch.float64, device)
        check(torch.equal(gt.grid_table(plan, table, vals),
                          gt.grid_table(plan, table, vals)),
              f"grid_table at W {support} is not deterministic")
        check(torch.equal(gt.degrid_table(plan, table, grid),
                          gt.degrid_table(plan, table, grid)),
              f"degrid_table at W {support} is not deterministic")
    print(f"[16/{PHASES}] gridder kernels vs plain on the card ({cases} problems: "
          f"2D W {'/'.join(map(str, SUPPORTS))} x corr 1/2/3/4 x 64², 70x45, 12x10, "
          "5x7 grids with edge-wrapping windows, windows over tile corners and "
          "in a tile's last cells; table W 3/5/7/15/17/29/31 x os 5/63 x 2 bands "
          "x 64², 37², 5² grids with windows off every edge; f32/f64; and "
          "complex128 W 15 os 1023 with the table in device memory; rel to "
          "max|out|): " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + "; deterministic (200k samples, 1024²; table pair W 29 and 31 in "
          "float64)",
          flush=True)

    # the PP gridder's conv_nn_scatter route, an index_put_ that
    # accumulates: the card against the CPU, and two card runs bitwise
    nn = []
    for cdtype, tol in ((np.complex64, GRIDDER_BOUND), (np.complex128, 1e-12)):
        problem = pp_nn_problem(**PP_NN, cdtype=cdtype, seed=SEED)
        a, b = pp_nn_grid(problem, device), pp_nn_grid(problem, device)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"PP conv_nn_scatter {cdtype.__name__}: two card "
                                 "runs differ")
        want = pp_nn_grid(problem, "cpu")
        err = float((a.cpu() - want).abs().max() / want.abs().max())
        check(err <= tol, f"PP conv_nn_scatter {cdtype.__name__} vs CPU: {err:.3e}")
        nn.append(f"{cdtype.__name__} {err:.2e} (bound {tol})")
    print(f"[16/{PHASES}] PP conv_nn_scatter ({PP_NN['nrow']} rows x 4 chan onto 2 x "
          f"{PP_NN['npix']}² cells): two card runs bitwise equal; vs CPU "
          + ", ".join(nn), flush=True)


def _mvis(n, ms):
    return n / ms / 1e3


def gridders(device, card):
    """Phases 17-18: the nifty-API gridder and the Perley-polyhedron facet
    gridder at full width. Returns the grid_2d, degrid_2d, grid_table and
    degrid_table entries of the kernels line."""
    import torch
    from africanus_tpu_torch.constants import ARCSEC2RAD
    from africanus_tpu_torch.gridding import nifty
    from africanus_tpu_torch.gridding import perleypolyhedron as pp
    from africanus_tpu_torch.gridding.nifty.gridder import _plan as nifty_plan
    from africanus_tpu_torch.gridding.perleypolyhedron import policies as pol
    from africanus_tpu_torch.gridding.perleypolyhedron.kernels import (
        kbsinc, pack_kernel,
    )
    from africanus_tpu_torch.gridding.wgridder.imaging import imaging_inputs
    from africanus_tpu_torch.ops import cuda_grid2d as g2
    from africanus_tpu_torch.ops import cuda_gridtab as gt

    # 17a. nifty: config-4 draws at 1024², 4 correlations, eps 1e-5 (W = 8)
    t0 = time.perf_counter()
    args = imaging_inputs(**NIFTY)
    nx, cell_as = args["nx"], args["cell"] / ARCSEC2RAD
    uvw, freq = args["uvw"], args["freq"]
    nrow, nchan = uvw.shape[0], freq.shape[0]
    rng = np.random.default_rng(SEED)
    shape = (nrow, nchan, NIFTY_NCORR)
    vis = torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                          .astype(np.complex64)).to(device)
    image = torch.as_tensor(rng.normal(size=(nx, nx, NIFTY_NCORR)).astype(
        np.float32)).to(device)
    flags = torch.zeros(shape, dtype=torch.uint8, device=device)
    gc = nifty.grid_config(nx, nx, NIFTY_EPS, cell_as, cell_as)
    plan_s = []
    for _ in range(2):  # the plan cold, then cached
        t1 = time.perf_counter()
        wplan = nifty_plan(uvw, freq, gc, torch.complex64, device).wgrid
        torch.cuda.synchronize()
        plan_s.append(time.perf_counter() - t1)
    setup = time.perf_counter() - t0
    nvis = nrow * nchan * NIFTY_NCORR

    g2.grid_2d.launches = g2.degrid_2d.launches = 0
    t0 = time.perf_counter()
    grid = nifty.grid(vis, uvw, flags, None, freq, gc)
    dirty = nifty.dirty(grid, gc)
    mgrid = nifty.model(image, gc)
    model = nifty.degrid(mgrid, uvw, flags, None, freq, gc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"grid_2d": g2.grid_2d.launches, "degrid_2d": g2.degrid_2d.launches}
    check(launches == {"grid_2d": 1, "degrid_2d": 1}, f"nifty launches {launches}")
    nu = 2 * nx
    check(tuple(grid.shape) == (nu, nu, NIFTY_NCORR) and grid.dtype == torch.complex64
          and tuple(dirty.shape) == (nx, nx, NIFTY_NCORR)
          and dirty.dtype == torch.float32 and tuple(model.shape) == shape
          and model.dtype == torch.complex64, "nifty output shapes")
    for name, x in (("grid", grid), ("dirty", dirty), ("model", model)):
        real = torch.view_as_real(x) if x.is_complex() else x
        check(bool(torch.isfinite(real).all()), f"nifty: non-finite {name}")

    # the kernels against their plain versions on the whole outputs
    vals = vis.reshape(-1, NIFTY_NCORR).T
    grid_p, grid2d_plain_ms = cuda_once_ms(lambda: g2.grid_2d_reference(wplan, vals))
    grid2d_abs = float((grid.permute(2, 0, 1) - grid_p).abs().max())
    grid2d_scale = float(grid_p.abs().max())
    check(grid2d_abs <= GRIDDER_BOUND * grid2d_scale,
          f"nifty grid_2d vs plain: {grid2d_abs:.3e} > 1e-5 x {grid2d_scale:.3e}")
    del grid_p
    mg = mgrid.permute(2, 0, 1)
    model_p, degrid2d_plain_ms = cuda_once_ms(lambda: g2.degrid_2d_reference(wplan, mg))
    degrid2d_abs = float((model.reshape(-1, NIFTY_NCORR).T - model_p).abs().max())
    degrid2d_scale = float(model_p.abs().max())
    check(degrid2d_abs <= GRIDDER_BOUND * degrid2d_scale,
          f"nifty degrid_2d vs plain: {degrid2d_abs:.3e} > 1e-5 x {degrid2d_scale:.3e}")
    del model_p
    # adjointness: <dirty(grid(V)), I> = Re <degrid(model(I)), V>
    lhs = float((dirty.double() * image.double()).sum())
    rhs = float((model.real.double() * vis.real.double()
                 + model.imag.double() * vis.imag.double()).sum())
    nifty_adj = abs(lhs - rhs) / abs(lhs)
    check(nifty_adj <= 1e-5, f"nifty adjointness {nifty_adj:.3e} > 1e-5")
    # tests/test_nifty.py's problem in float64 on the card vs the explicit DFT
    srng = np.random.default_rng(SEED + 5)
    snx, scell_as = 16, 5.0 * 3600 / 16
    scell = np.deg2rad(scell_as / 3600.0)
    sfreq = 1e9 + np.arange(2) * 1e8
    suvw = (srng.uniform(size=(200, 3)) - 0.5) / (scell * sfreq[-1] / 2.99792458e8)
    suvw[:, 2] = 0.0
    svis = srng.normal(size=(200, 2, 2)) + 1j * srng.normal(size=(200, 2, 2))
    sgc = nifty.grid_config(snx, snx, 1e-7, scell_as, scell_as)
    sd = nifty.dirty(nifty.grid(torch.as_tensor(svis, device=device), suvw,
                                np.zeros(svis.shape, np.uint8), None, sfreq, sgc),
                     sgc).cpu().numpy()
    x, y = np.meshgrid(*[(-snx / 2 + np.arange(snx)) * scell] * 2, indexing="ij")
    ref = np.zeros((snx, snx))
    for c in range(2):
        phase = sfreq[c] / 2.99792458e8 * (x[None] * suvw[:, 0, None, None]
                                           + y[None] * suvw[:, 1, None, None])
        ref += (svis[:, c, 0, None, None] * np.exp(2j * np.pi * phase)).real.sum(0)
    dft_l2 = _l2(sd[:, :, 0], ref)
    check(dft_l2 < 1e-5, f"nifty f64 dirty vs explicit DFT l2 {dft_l2:.3e}")
    print(f"[17/{PHASES}] nifty gridder: {nrow} rows x {nchan} chan x {NIFTY_NCORR} "
          f"corr, {nx}² image, eps {NIFTY_EPS} (W {wplan.support}, {nu}² grids, "
          f"{wplan.ntiles} tiles); set-up {setup:.1f} s, plan cold {plan_s[0]:.3f} "
          f"s, cached {plan_s[1]:.4f} s; grid + dirty + model + degrid in "
          f"{wall:.3f} s wall (first call); launches {launches}; kernel vs plain: "
          f"grid max abs {grid2d_abs:.3e} (max {grid2d_scale:.3e}), degrid "
          f"{degrid2d_abs:.3e} (max {degrid2d_scale:.3e}); adjointness "
          f"{nifty_adj:.2e}; f64 explicit-DFT l2 {dft_l2:.3e} (200 rows, 16², "
          "bound 1e-5)", flush=True)

    # 17b. PP facet: config-4 draws at 2048², 2 bands, kbsinc(7, 63), the
    # image centre 0.5 deg from the phase centre, rotate + phase_rotate
    t0 = time.perf_counter()
    args = imaging_inputs(**FACET)
    npix, cell_as = args["nx"], args["cell"] / ARCSEC2RAD
    puvw, pfreq = args["uvw"].astype(np.float64), args["freq"].astype(np.float64)
    wl = 2.99792458e8 / pfreq
    chanmap = np.repeat(np.arange(FACET_BANDS), pfreq.size // FACET_BANDS)
    phase_centre = (0.0, FACET_DEC)
    image_centre = (0.0, FACET_DEC + np.deg2rad(FACET_OFFSET_DEG))
    w, os_ = 7, 63
    kern = pack_kernel(kbsinc(w, oversample=os_), w, os_)
    prow = puvw.shape[0]
    rng = np.random.default_rng(SEED)
    pshape = (prow, pfreq.size, 2)
    pvis = torch.as_tensor((rng.normal(size=pshape) + 1j * rng.normal(size=pshape))
                           .astype(np.complex64)).to(device)
    duvw = torch.as_tensor(puvw, device=device)
    common = (npix, cell_as, image_centre, phase_centre)
    gplan = pp.pp_tile_plan(puvw, wl, chanmap, *common, w, os_, "rotate", "grid",
                            torch.float32, device)
    dplan = pp.pp_tile_plan(puvw, wl, chanmap, *common, w, os_, "rotate", "degrid",
                            torch.float32, device)
    torch.cuda.synchronize()
    psetup = time.perf_counter() - t0
    pvis_n = prow * pfreq.size * 2
    gargs = (duvw, pvis, wl, chanmap, *common, kern, w, os_, "rotate",
             "phase_rotate", "I_FROM_XXYY", "conv_1d_axisymmetric_packed_scatter")

    def pp_grid():
        return pp.gridder(*gargs, tile_plan=gplan)

    def pp_degrid(g):
        return pp.degridder(duvw, g, wl, chanmap, cell_as, image_centre,
                            phase_centre, kern, w, os_, "rotate", "phase_rotate",
                            "XXYY_FROM_I", "conv_1d_axisymmetric_packed_gather",
                            tile_plan=dplan)

    gt.grid_table.launches = gt.degrid_table.launches = 0
    t0 = time.perf_counter()
    fgrid = pp_grid()
    fvis = pp_degrid(fgrid)
    torch.cuda.synchronize()
    pwall = time.perf_counter() - t0
    plaunches = {"grid_table": gt.grid_table.launches,
                 "degrid_table": gt.degrid_table.launches}
    check(plaunches == {"grid_table": 1, "degrid_table": 1}, f"PP launches {plaunches}")
    check(tuple(fgrid.shape) == (FACET_BANDS, npix, npix)
          and fgrid.dtype == torch.complex64 and tuple(fvis.shape) == pshape
          and fvis.dtype == torch.complex64, "PP output shapes")
    check(bool(torch.isfinite(torch.view_as_real(fgrid)).all())
          and bool(torch.isfinite(torch.view_as_real(fvis)).all()), "PP: non-finite")
    table = torch.as_tensor(pp.kernels.unpack_kernel(kern, w, os_)).to(
        device=device, dtype=torch.float32)
    stokes = pol.corr2stokes(pol.phase_transform(
        pvis, duvw, wl, *phase_centre, *image_centre, "phase_rotate"),
        "I_FROM_XXYY").reshape(-1).contiguous()
    gtab_p, gtab_plain_ms = cuda_once_ms(
        lambda: gt.grid_table_reference(gplan, table, stokes))
    gtab_abs = float((fgrid - gtab_p).abs().max())
    gtab_scale = float(gtab_p.abs().max())
    check(gtab_abs <= GRIDDER_BOUND * gtab_scale,
          f"PP grid_table vs plain: {gtab_abs:.3e} > 1e-5 x {gtab_scale:.3e}")
    del gtab_p
    dtab = gt.degrid_table(dplan, table, fgrid)
    dtab_p, dtab_plain_ms = cuda_once_ms(
        lambda: gt.degrid_table_reference(dplan, table, fgrid))
    dtab_abs = float((dtab - dtab_p).abs().max())
    dtab_scale = float(dtab_p.abs().max())
    check(dtab_abs <= GRIDDER_BOUND * dtab_scale,
          f"PP degrid_table vs plain: {dtab_abs:.3e} > 1e-5 x {dtab_scale:.3e}")
    del dtab_p
    # the adjoint identity of the table pair on the facet plan:
    # <G, grid(S)> = <degrid(G), S>
    G = torch.complex(torch.randn(fgrid.shape, device=device),
                      torch.randn(fgrid.shape, device=device))
    lhs = complex(torch.vdot(G.reshape(-1).to(torch.complex128),
                             gt.grid_table(gplan, table, stokes).reshape(-1)
                             .to(torch.complex128)))
    rhs = complex(torch.vdot(gt.degrid_table(gplan, table, G).to(torch.complex128),
                             stokes.to(torch.complex128)))
    pp_adj = abs(lhs - rhs) / abs(lhs)
    check(pp_adj <= 1e-5, f"PP table adjointness {pp_adj:.3e} > 1e-5")
    kept = gplan.nkeep / gplan.nsamples
    print(f"[17/{PHASES}] PP facet gridder: {prow} rows x {pfreq.size} chan x 2 corr "
          f"(I_FROM_XXYY / XXYY_FROM_I), {npix}² x {FACET_BANDS} bands, kbsinc W {w} "
          f"os {os_} packed, image centre {FACET_OFFSET_DEG} deg off, rotate + "
          f"phase_rotate; set-up with both plans {psetup:.1f} s ({kept:.2%} of "
          f"samples in the grid, {gplan.ntr}² tiles of {gplan.tile}); gridder + "
          f"degridder in {pwall:.3f} s wall (first call); launches {plaunches}; "
          f"kernel vs plain: grid max abs {gtab_abs:.3e} (max {gtab_scale:.3e}), "
          f"degrid {dtab_abs:.3e} (max {dtab_scale:.3e}); table-pair adjointness "
          f"{pp_adj:.2e}", flush=True)

    # 18. times
    grid2d_ms = kernel_median_ms(lambda: g2.grid_2d(wplan, vals))
    degrid2d_ms = kernel_median_ms(lambda: g2.degrid_2d(wplan, mg))
    gtab_ms = kernel_median_ms(lambda: gt.grid_table(gplan, table, stokes))
    dtab_ms = kernel_median_ms(lambda: gt.degrid_table(dplan, table, fgrid))
    nifty_grid_ms, ng_runs = cuda_median_ms(
        lambda: nifty.dirty(nifty.grid(vis, uvw, flags, None, freq, gc), gc))
    nifty_degrid_ms, nd_runs = cuda_median_ms(
        lambda: nifty.degrid(nifty.model(image, gc), uvw, flags, None, freq, gc))
    pp_grid_ms, pg_runs = cuda_median_ms(pp_grid)
    pp_degrid_ms, pd_runs = cuda_median_ms(lambda: pp_degrid(fgrid))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nifty.degrid(nifty.model(image, gc), uvw, flags, None, freq, gc)
    nifty.dirty(nifty.grid(vis, uvw, flags, None, freq, gc), gc)
    torch.cuda.synchronize()
    nifty_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    pp_degrid(pp_grid())
    torch.cuda.synchronize()
    pp_peak = torch.cuda.max_memory_allocated() / 2**30
    profiles = {
        "nifty grid+dirty": _profile(
            lambda: nifty.dirty(nifty.grid(vis, uvw, flags, None, freq, gc), gc)),
        "nifty model+degrid": _profile(
            lambda: nifty.degrid(nifty.model(image, gc), uvw, flags, None, freq, gc)),
        "PP gridder": _profile(pp_grid),
        "PP degridder": _profile(lambda: pp_degrid(fgrid)),
    }
    print(f"[18/{PHASES}] gridder times on {card}: nifty grid + dirty "
          f"{nifty_grid_ms:.3f} ms (runs {', '.join(f'{t:.3f}' for t in ng_runs)}) "
          f"= {_mvis(nvis, nifty_grid_ms):.1f} Mvis/s, model + degrid "
          f"{nifty_degrid_ms:.3f} ms (runs {', '.join(f'{t:.3f}' for t in nd_runs)}) "
          f"= {_mvis(nvis, nifty_degrid_ms):.1f} Mvis/s; PP gridder {pp_grid_ms:.3f} "
          f"ms (runs {', '.join(f'{t:.3f}' for t in pg_runs)}) = "
          f"{_mvis(pvis_n, pp_grid_ms):.1f} Mvis/s, degridder {pp_degrid_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.3f}' for t in pd_runs)}) = "
          f"{_mvis(pvis_n, pp_degrid_ms):.1f} Mvis/s; kernels (CUDA graph of "
          f"{BURST}): grid_2d {grid2d_ms:.4f} ms (one kernel, no fold; tiles of "
          f"{wplan.tile_u}, {wplan.nentries / max(wplan.nsamples, 1):.3f} entries "
          f"per sample), degrid_2d {degrid2d_ms:.4f} ms (tile gather, "
          f"{wplan.ngather} tiles with samples; was {PREVIOUS_MS['degrid_2d']}), "
          f"grid_table {gtab_ms:.4f} ms (tile spread, one kernel, no fold; tiles "
          f"of {gplan.tile}, {gplan.nentries / max(gplan.nkeep, 1):.3f} entries per "
          f"kept sample; was {PREVIOUS_MS['grid_table']}), "
          f"degrid_table {dtab_ms:.4f} ms (tile gather, {dplan.ngather} tile-band "
          f"blocks; was {PREVIOUS_MS['degrid_table']}); plain grid_2d "
          f"{grid2d_plain_ms:.1f} ms, "
          f"degrid_2d {degrid2d_plain_ms:.1f} ms, grid_table {gtab_plain_ms:.1f} ms, "
          f"degrid_table {dtab_plain_ms:.1f} ms; peak device memory nifty "
          f"{nifty_peak:.2f} GiB, PP {pp_peak:.2f} GiB", flush=True)
    for name, (pwall_, busy, rows) in profiles.items():
        top = "; ".join(f"{k[:40]} x{count // 3} {ms / 3:.4f} ms"
                        for k, count, ms in rows[:6])
        print(f"[18/{PHASES}] profiler, {name}, per call of 3: host "
              f"{pwall_ / 3:.3f} ms, device busy {busy / 3:.4f} ms (idle "
              f"{1 - busy / pwall_:.1%}), by device time: {top}", flush=True)

    # bounds: the map's own operands (window starts and offsets, or the
    # quantised starts, fractions and bands, the values, the table, the
    # grids); per tap ku·kv once and 2 FMAs per correlation, 2 ES
    # evaluations per axis tap, table taps read, not evaluated
    geo2d = (wplan.iu0, wplan.iv0, wplan.uf, wplan.vf)
    taps2d = wplan.nsamples * wplan.support ** 2
    es2d = wplan.nsamples * 2 * wplan.support * ES_INSTR
    keep = gplan.order.long()
    geo_t = tuple(x[keep] for x in (gplan.ir0, gplan.ic0, gplan.fr, gplan.fc,
                                    gplan.band))
    dkeep = dplan.order.long()
    dgeo_t = tuple(x[dkeep] for x in (dplan.ir0, dplan.ic0, dplan.fr, dplan.fc,
                                      dplan.band))
    entries = [
        {"name": "grid_2d", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/grid2d.cu",
         "replaces": "africanus_tpu/ops/pallas_grid.py:533, "
                     "africanus_tpu/ops/pallas_grid.py:2503",
         "launches": launches["grid_2d"], "max_abs_err": grid2d_abs,
         "ms": grid2d_ms, "plain_ms": grid2d_plain_ms,
         **bound(nbytes(geo2d, vals, grid),
                 taps2d * (1 + 2 * NIFTY_NCORR) + es2d),
         "library_ms": None},
        {"name": "degrid_2d", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/grid2d.cu",
         "replaces": "africanus_tpu/ops/pallas_grid.py:733, "
                     "africanus_tpu/ops/pallas_grid.py:2599",
         "launches": launches["degrid_2d"], "max_abs_err": degrid2d_abs,
         "ms": degrid2d_ms, "plain_ms": degrid2d_plain_ms,
         **bound(nbytes(geo2d, mg, model),
                 taps2d * DEGRID_TAP_INSTR * NIFTY_NCORR + es2d),
         "library_ms": None},
        {"name": "grid_table", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/gridtab.cu",
         "replaces": "africanus_tpu/ops/pallas_grid.py:1098",
         "launches": plaunches["grid_table"], "max_abs_err": gtab_abs,
         "ms": gtab_ms, "plain_ms": gtab_plain_ms,
         **bound(nbytes(geo_t, stokes[keep], table, fgrid),
                 gplan.nkeep * w * w * GRID_TAP_INSTR),
         "library_ms": None},
        {"name": "degrid_table", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/gridtab.cu",
         "replaces": "africanus_tpu/ops/pallas_grid.py:1195",
         "launches": plaunches["degrid_table"], "max_abs_err": dtab_abs,
         "ms": dtab_ms, "plain_ms": dtab_plain_ms,
         **bound(nbytes(dgeo_t, table, fgrid, dtab),
                 dplan.nkeep * w * w * DEGRID_TAP_INSTR),
         "library_ms": None},
    ]
    print(f"[18/{PHASES}] bounds: " + ", ".join(
        f"{e['name']} {e['bound_ms']:.4f} ms ({e['bound_by']})" for e in entries),
        flush=True)
    return entries


# phase 19: the averagers. The bench cell (bench.py:1018-1038, drawn
# from SEED) and MeerKAT-64 in 1K mode (64 antennas in a 4 km box, 2016
# baselines, 16 dumps of 8 s with Earth rotation, 1024 channels, 4
# correlations, 2% of the rows flagged); bda at decorrelation 0.98 and
# max_fov 3°, time_and_channel at 16 s × 4 channels
AVG_TC = dict(time_bin_secs=16.0, chan_bin_size=4)
MEERKAT = dict(nant=64, ntime=16, dump=8.0, nchan=1024, ncorr=4, seed=19)
AVG_SUBSET_BL = 256
# card vs CPU, relative to max, float32: each bin summed in another order
AVG_BOUND = 1e-6
# a call's peak allocation above its resident inputs, in the inputs' bytes
AVG_MEMORY_FACTOR = 4
AVG_DATA = ("visibilities", "flag", "weight_spectrum", "sigma_spectrum")
AVG_META = ("time", "interval", "antenna1", "antenna2", "uvw", "chan_freq",
            "chan_width", "flag_row")
# phase 20: the fused RIME at the flagship's MeerKAT-64 chunk (the draws
# of flagship_inputs(100, 4, 64, 4096, SEED)), and config 3's cube
FUSED = dict(nsrc=NSRC, ntime=NTIME, nant=NANT, nchan=NCHAN)
KGB_SPEC = "(Kpq, Gpq, Bpq): [I,Q,U,V] -> [XX,XY,YX,YY]"
E_SPEC = "[Ep, (Kpq, Gpq, Bpq), Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]"
FUSED_BOUND = 5e-6  # the flagship's bar against float64 (PERF.md §2)
FUSED_E_BOUND = 1e-5  # the E chain on the card against the CPU
FUSED_BLOCKS_BOUND = 1e-6  # two block sizes
FUSED_WINDOW = (256, 16)  # rows × channels held against a reference
# fused_dde against its plain version at the DDE chunk, of max: sincospif
# and ex2.approx against torch's cos, sin and exp2 (the card tests' bound)
FUSED_PLAIN_BOUND = 1e-6
# the pairs kernel's FP32 instructions a (source, row) pair, by the count
# of its error-free transformations (n - 1's two_prods, df_add, df_div and
# df_sqrt with its float64 square root ~120, the dot with w ~80, the delay's
# df_mul ~25, the envelope 7)
PAIRS_INSTRUCTIONS = 230
# a chosen block's measured peak over the library's estimate: the
# allocator's rounding and a block's small index tensors
FUSED_ESTIMATE_SLACK = 1.02
# the benchmark cell of the direction-dependent predict, one chunk of it
DDE_CELL = "meerkat64pb.beam100"
DDE_SPEC = "[Ep, Lp, Kpq, Gpq, Bpq, Lq, Eq]: [I,Q,U,V] -> [XX,XY,YX,YY]"


def _avg_calls(o, data):
    """{"bda": fn, "time_and_channel": fn}: the two averagers on the
    numpy metadata of ``o`` and the data tensors ``data``."""
    from africanus_tpu_torch.averaging import bda, time_and_channel

    meta = {k: o[k] for k in AVG_META if k in o}
    return {"bda": lambda: bda(**meta, **data, decorrelation=o["decorrelation"],
                               max_fov=o.get("max_fov", 3.0)),
            "time_and_channel": lambda: time_and_channel(**meta, **data, **AVG_TC)}


def _avg_tensors(out):
    return {k: v for k, v in out._asdict().items() if hasattr(v, "numel")}


def _avg_equal(a, b):
    ta, tb = _avg_tensors(a), _avg_tensors(b)
    return ta.keys() == tb.keys() and all(
        ta[k].dtype == tb[k].dtype and bool((ta[k] == tb[k].to(ta[k].device)).all())
        for k in ta)


def _avg_err(got, want):
    """The largest error of ``got``'s tensors against ``want``'s (CPU),
    relative to each field's max; bool and integer fields must be equal."""
    import torch

    worst = 0.0
    for k, g in _avg_tensors(got).items():
        w = _avg_tensors(want)[k]
        g = g.cpu()
        check(g.shape == w.shape and g.dtype == w.dtype, f"{k}: {g.shape} {g.dtype}")
        if not (g.is_floating_point() or g.is_complex()):
            check(torch.equal(g, w), f"{k}: card and CPU differ")
            continue
        scale = float(w.abs().max()) if w.numel() else 0.0
        if scale:
            worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def _avg_totals(out, data):
    """The preserved weighted totals (tests/test_bda.py:83): over the
    unflagged samples, Σ w and Σ w·v of the inputs against the outputs'
    Σ w and Σ w·v̄, each relative to its scale."""
    import torch

    keep_in, keep_out = ~data["flag"], ~out.flag
    w_in = data["weight_spectrum"].double()
    w_out = out.weight_spectrum.double()
    wsum = float(w_in[keep_in].sum())
    werr = abs(float(w_out[keep_out].sum()) - wsum) / wsum
    vw_in = (data["visibilities"].to(torch.complex128) * w_in)[keep_in]
    vw_out = (out.visibilities.to(torch.complex128) * w_out)[keep_out]
    scale = float(vw_in.abs().sum())
    verr = float((vw_out.sum() - vw_in.sum()).abs()) / scale
    return werr, verr


def averaging(device, card):
    """Phase 19: bda and time_and_channel at the bench cell and at
    MeerKAT-64 1K, on the card against the CPU. Returns phase 21's state:
    the calls of both cells and the host timings."""
    import torch
    from africanus_tpu_torch import native
    from africanus_tpu_torch.averaging import bda_avg, row_mapper
    from africanus_tpu_torch.averaging.bda_mapping import bda_mapper
    from africanus_tpu_torch.averaging.time_and_channel_avg import (
        _TABLE_CACHE, _flat_segments, _map_segments,
    )
    from africanus_tpu_torch.averaging.time_and_channel_mapping import channel_mapper
    from africanus_tpu_torch.testing.averaging import bench_bda_inputs, meerkat_inputs

    # no phase may run the numpy binner in the C++ binner's place
    check(native.available(), f"the native binner did not load: {native.load_error()}")

    def on(o, dev):
        return {k: torch.as_tensor(o[k], device=dev) for k in AVG_DATA if k in o}

    # (a) the bench cell: the card against the CPU, two card runs bitwise
    ob = bench_bda_inputs(SEED)
    bench = _avg_calls(ob, on(ob, device))
    bench_err = {}
    for name, fn in bench.items():
        a, b = fn(), fn()
        torch.cuda.synchronize()
        check(_avg_equal(a, b), f"bench cell {name}: two card runs differ")
        bench_err[name] = _avg_err(a, _avg_calls(ob, on(ob, "cpu"))[name]())
        check(bench_err[name] <= AVG_BOUND,
              f"bench cell {name} card vs CPU {bench_err[name]:.2e}")
    nvis_bench = ob["visibilities"].size

    # (b) MeerKAT-64 1K: the mapper and the tables timed alone, cold
    t0 = time.perf_counter()
    om = meerkat_inputs(**MEERKAT)
    draw_s = time.perf_counter() - t0
    data = on(om, device)
    torch.cuda.synchronize()
    in_bytes = nbytes(*data.values())
    meerkat = _avg_calls(om, data)
    t0 = time.perf_counter()
    meta = bda_mapper(om["time"], om["interval"], om["antenna1"], om["antenna2"],
                      om["uvw"], om["chan_width"], om["chan_freq"], None,
                      flag_row=om["flag_row"], max_fov=om["max_fov"],
                      decorrelation=om["decorrelation"])
    bda_map_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tbl = bda_avg._tables(meta, device)
    torch.cuda.synchronize()
    bda_csr_s = time.perf_counter() - t0
    rc = tbl.row_chans
    nin, nout = meta.map.size, meta.time.shape[0]
    lengths = rc.lengths.cpu().numpy()
    largest, median = int(lengths.max()), float(np.median(lengths))
    check(rc.nin + rc.nout == nin + nout, f"CSR holds {rc.nin + rc.nout} entries")
    t0 = time.perf_counter()
    row_meta = row_mapper(om["time"], om["interval"], om["antenna1"], om["antenna2"],
                          flag_row=om["flag_row"], time_bin_secs=AVG_TC["time_bin_secs"])
    tc_map_s = time.perf_counter() - t0
    chan_map, out_chans = channel_mapper(MEERKAT["nchan"], AVG_TC["chan_bin_size"])
    t0 = time.perf_counter()
    _map_segments(row_meta.map, row_meta.time.shape[0], device)
    _flat_segments(row_meta.map, row_meta.time.shape[0], chan_map, out_chans, device)
    torch.cuda.synchronize()
    tc_csr_s = time.perf_counter() - t0
    del tbl, rc

    # each call's first run, its tables built inside it: the peak above
    # the resident inputs; a second run bitwise equal; the totals
    peaks, totals, outs = {}, {}, {}
    for name, fn in meerkat.items():
        bda_avg._TABLE_CACHE.clear()
        _TABLE_CACHE.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        check(peaks[name] <= AVG_MEMORY_FACTOR * in_bytes,
              f"MeerKAT {name}: peak {peaks[name] / 2**30:.2f} GiB above the inputs' "
              f"{in_bytes / 2**30:.2f} GiB")
        check(_avg_equal(out, fn()), f"MeerKAT {name}: two card runs differ")
        totals[name] = _avg_totals(out, data)
        check(max(totals[name]) <= AVG_BOUND, f"MeerKAT {name} totals {totals[name]}")
        outs[name] = tuple(out.visibilities.shape)
        del out

    # a 256-baseline subset on the card against the CPU
    bl = om["antenna1"].astype(np.int64) * MEERKAT["nant"] + om["antenna2"]
    rows = np.isin(bl, np.unique(bl)[:AVG_SUBSET_BL])
    sub = {k: (v[rows] if isinstance(v, np.ndarray) and v.shape[:1] == rows.shape
               else v) for k, v in om.items()}
    rows_t = torch.as_tensor(np.flatnonzero(rows), device=device)
    sub_card = {k: v.index_select(0, rows_t) for k, v in data.items()}
    sub_cpu = {k: v.cpu() for k, v in sub_card.items()}
    subset_err = {}
    for name in meerkat:
        got = _avg_calls(sub, sub_card)[name]()
        subset_err[name] = _avg_err(got, _avg_calls(sub, sub_cpu)[name]())
        check(subset_err[name] <= AVG_BOUND,
              f"MeerKAT {name} subset card vs CPU {subset_err[name]:.2e}")
    del sub_card, sub_cpu

    nvis = om["visibilities"].size
    print(f"[19/{PHASES}] averaging: native binner {native.library_path().name}; "
          f"bench cell (300 bl x 60 dumps, 64 chan, 4 corr = {nvis_bench} vis) card vs "
          "CPU " + ", ".join(f"{k} {v:.2e}" for k, v in bench_err.items())
          + f" (bound {AVG_BOUND}), two runs bitwise equal; MeerKAT-64 1K "
          f"({len(om['time'])} rows x {MEERKAT['nchan']} chan x {MEERKAT['ncorr']} corr "
          f"= {nvis} vis, {int(om['flag_row'].sum())} rows flagged; draws "
          f"{draw_s:.1f} s): bda {nin} inputs -> {nout} outputs, largest bin "
          f"{largest} (median {median:g}; a padded (outputs x largest bin) table "
          f"would hold {nout * largest / nin:.0f}x the inputs), CSR {nin + nout} "
          f"entries; outputs " + ", ".join(f"{k} {v}" for k, v in outs.items())
          + "; peak above the inputs' "
          f"{in_bytes / 2**30:.2f} GiB: " + ", ".join(
              f"{k} {v / 2**30:.2f} GiB ({v / in_bytes:.2f}x)" for k, v in peaks.items())
          + f" (bound {AVG_MEMORY_FACTOR}x); two runs bitwise equal; totals (w, w.v) "
          + ", ".join(f"{k} {w:.1e} {v:.1e}" for k, (w, v) in totals.items())
          + f"; {AVG_SUBSET_BL}-baseline subset card vs CPU "
          + ", ".join(f"{k} {v:.2e}" for k, v in subset_err.items()), flush=True)
    return {"cells": {"bench": (bench, nvis_bench), "meerkat": (meerkat, nvis)},
            "host_s": {"bda mapper": bda_map_s, "bda CSR": bda_csr_s,
                       "tc mapper": tc_map_s, "tc CSR": tc_csr_s}}


def _peak_of(fn):
    """(result, peak device bytes above the allocation before ``fn()``)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _chosen_block(spec, device, args, what):
    """``rime(spec, **args)`` with no source block, the library choosing
    it on the kernel route: checks the block against the route's estimate
    and the free memory read with the state, the launches (the counts set
    to 0 before the call: one fused_pairs and one fused_dde a block), and
    the measured peak against the estimate. Returns (the visibilities,
    the state, a dict of the block, the blocks, the estimate, the budget,
    the peak, the first call's seconds and the launches)."""
    import torch
    from africanus_tpu_torch.ops import cuda_fused as cf
    from africanus_tpu_torch.rime.fused import RimeFactory, core

    factory = RimeFactory(spec)
    state = factory.build_state(device=device, **args)
    torch.cuda.synchronize()
    route = factory.route(state)
    check(route is not None, f"{what}: the kernel route not taken")
    nsrc = state["lm"].shape[0]
    budget = core.MEMORY_SHARE * state["free_bytes"]
    block = factory._kernel_block(state, route, budget)
    nblocks = -(-nsrc // block)
    est = factory.kernel_bytes(state, block, route)
    check(est <= budget or block == 1, f"{what}: block {block} estimated at "
          f"{est / 2**30:.2f} GiB, over the budget of {budget / 2**30:.2f} GiB")
    if nblocks > 1:  # one block fewer would not fit
        larger = -(-nsrc // (nblocks - 1))
        check(factory.kernel_bytes(state, larger, route) > budget,
              f"{what}: block {larger} would fit beside {block}")
    cf.fused_dde.launches = cf.fused_pairs.launches = 0
    t0 = time.perf_counter()
    vis, peak = _peak_of(lambda: factory.evaluate(state))
    first_s = time.perf_counter() - t0
    launches = {"fused_pairs": cf.fused_pairs.launches, "fused_dde": cf.fused_dde.launches}
    check(launches == {"fused_pairs": nblocks, "fused_dde": nblocks},
          f"{what}: launches {launches}, {nblocks} blocks")
    check(peak <= FUSED_ESTIMATE_SLACK * est,
          f"{what}: peak {peak / 2**30:.2f} GiB over the estimate {est / 2**30:.2f} GiB")
    return vis, state, dict(block=block, nblocks=nblocks, est=est, budget=budget,
                            peak=peak, first_s=first_s, launches=launches)


def _fused_line(name, run):
    return (f"{name}: source block {run['block']} ({run['nblocks']} blocks), "
            f"estimate {run['est'] / 2**30:.2f} GiB of a budget of "
            f"{run['budget'] / 2**30:.2f} GiB, peak {run['peak'] / 2**30:.2f} GiB "
            f"({run['peak'] / run['est']:.3f} of the estimate), first call "
            f"{run['first_s']:.2f} s")


def fused(device, card):
    """Phase 20: the fused RIME at the flagship's chunk in the blocks the
    library chooses, KGB against the float64 oracle, the E chain against
    the CPU, and the benchmark cell's direction-dependent chunk against
    its reference, the beam kernels' launches counted and held to their
    plain versions there. Returns phase 21's state."""
    import torch
    from africanus_tpu_torch.ops import cuda_beam as cb
    from africanus_tpu_torch.rime.fast_beam_cubes import beam_cube_dde
    from africanus_tpu_torch.rime.fused import rime
    from africanus_tpu_torch.rime.fused.inputs import (
        from_numpy, fused_inputs, fused_oracle_f64,
    )
    from africanus_tpu_torch.ops import cuda_fused as cf
    from africanus_tpu_torch.rime.fused import RimeFactory
    from perfbench import run as bench
    from perfbench.work import fused_dde as work

    nant = FUSED["nant"]
    nrow, nchan = FUSED["ntime"] * nant * (nant - 1) // 2, FUSED["nchan"]
    wr, wc = FUSED_WINDOW
    runs = {}
    # KGB: windows vs float64
    args = fused_inputs(**FUSED, seed=SEED)
    t = from_numpy(args, device)
    vis, _, runs["KGB"] = _chosen_block(KGB_SPEC, device, t, "KGB")
    check(tuple(vis.shape) == (nrow, nchan, 4) and vis.dtype == torch.complex64,
          f"KGB {tuple(vis.shape)} {vis.dtype}")
    check(bool(torch.isfinite(torch.view_as_real(vis)).all()), "KGB non-finite")
    kgb_err = 0.0
    for r0, c0 in ((0, 0), ((nrow - wr) // 2, (nchan - wc) // 2), (nrow - wr, nchan - wc)):
        want = fused_oracle_f64(args, slice(r0, r0 + wr), slice(c0, c0 + wc))
        kgb_err = max(kgb_err, rel_err(vis[r0:r0 + wr, c0:c0 + wc].cpu().numpy(), want))
    check(kgb_err <= FUSED_BOUND, f"KGB vs float64 oracle {kgb_err:.3e}")
    del vis
    runs["KGB"]["fn"] = lambda: rime(KGB_SPEC, **t)

    # the E chain on config 3's cube: launches, a window vs the CPU, two
    # block sizes
    eargs = fused_inputs(**FUSED, seed=SEED, beam_seed=BEAM["seed"])
    te = from_numpy(eargs, device)
    _zero_beam_counts()
    evis, _, erun = _chosen_block(E_SPEC, device, te, "E chain")
    counts = _beam_counts()
    eblock, nblocks = erun["block"], erun["nblocks"]
    check(counts == {"beam_interp": nblocks, "beam_blend": nblocks,
                     "beam_blend_cell": 0}, f"E chain launches {counts}, "
          f"{nblocks} blocks")
    check(bool(torch.isfinite(torch.view_as_real(evis)).all()), "E chain non-finite")
    # the window: the first wr rows (time 0, every antenna) and wc
    # channels mid-band, evaluated on the CPU from the same draws
    c0 = nchan // 2 - 8
    rows, chans = slice(0, wr), slice(c0, c0 + wc)
    wargs = dict(eargs, chan_freq=eargs["chan_freq"][chans],
                 beam_parangle=eargs["beam_parangle"][:1],
                 **{k: eargs[k][rows] for k in ("time", "antenna1", "antenna2",
                                                 "feed1", "feed2", "uvw")})
    check(np.unique(np.concatenate([wargs["antenna1"], wargs["antenna2"]])).size == nant,
          "the E window misses an antenna")
    want = rime(E_SPEC, **from_numpy(wargs, "cpu"), source_block=eblock)
    e_err = rel_err(evis[rows, chans].cpu().numpy(), want.numpy())
    check(e_err <= FUSED_E_BOUND, f"E chain card vs CPU {e_err:.3e}")
    eblock2 = max(eblock // 2, 1) if eblock > 1 else 2
    evis2 = rime(E_SPEC, **te, source_block=eblock2)
    blocks_err = float((evis2 - evis).abs().max() / evis.abs().max())
    check(blocks_err <= FUSED_BLOCKS_BOUND,
          f"E chain blocks {eblock} vs {eblock2}: {blocks_err:.3e}")
    del evis, evis2
    runs["E"] = dict(erun, fn=lambda: rime(E_SPEC, **te))

    # the benchmark cell's chunk: the cell's own draws (its entry's set-up
    # with one chunk in the pool), no block given
    cell, cfg = bench.cell_spec(DDE_CELL, {"traffic": {"pool_chunks": 1}})
    entry = bench.load_module("entries", cell["entry"]).setup(
        cfg, cell["traffic"], SEED, device)
    dargs = entry.arguments(0)
    before = _beam_counts()
    dvis, dstate, drun = _chosen_block(DDE_SPEC, device, dargs, "DDE chunk")
    dcounts = {k: v - before[k] for k, v in _beam_counts().items()}
    dblock, dblocks = drun["block"], drun["nblocks"]
    check(dcounts == {"beam_interp": dblocks, "beam_blend": dblocks,
                      "beam_blend_cell": 0}, f"DDE chunk launches {dcounts}, "
          f"{dblocks} blocks")
    for k, v in dcounts.items():
        counts[k] += v
    dnvis, dnrow = dvis.numel(), dvis.shape[0]
    vis_err = entry.readings([entry.keep(0, dvis)])["vis_err"]
    limit = cell["limits"]["vis_err"]
    check(vis_err <= limit, f"DDE chunk vs the float64 reference {vis_err:.3e}")
    del dvis
    # the beam kernels on the first source block's operands of the chunk
    ops = {}
    beam_cube_dde(dstate["beam"], dstate["beam_lm_extents"], dstate["beam_freq_map"],
                  dstate["lm"][:dblock], dstate["beam_parangle"],
                  dstate["beam_point_errors"], dstate["beam_antenna_scaling"],
                  dstate["chan_freq"], operands=ops)
    check(set(ops) == {"beam_interp", "beam_blend"}, f"DDE chunk route {sorted(ops)}")
    kernel_err = {}
    for name, plain in (("beam_interp", cb.beam_interp_reference),
                        ("beam_blend", cb.beam_blend_reference)):
        got = getattr(cb, name)(*ops[name])
        want = plain(*ops[name])
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} at the DDE chunk: {tuple(got.shape)} {got.dtype}")
        kernel_err[name] = float((got - want).abs().max() / want.abs().max())
        check(kernel_err[name] <= BEAM_BOUND,
              f"{name} vs plain at the DDE chunk: {kernel_err[name]:.3e}")
        del got, want
    nsamp = ops["beam_interp"][1].shape[0]
    del ops
    # the pairs kernel alone on the chunk's sources and rows: equal to its
    # plain version bit for bit, timed beside its bound and the plain time
    convention = dstate.get("convention", "fourier")
    pair_args = (dstate["lm"], dstate["uvw"], dstate["gauss_shape"], convention)
    pairs = cf.fused_pairs(*pair_args)
    plain_pairs, pairs_plain_ms = cuda_once_ms(lambda: cf.fused_pairs_reference(*pair_args))
    check(pairs.shape == plain_pairs.shape == (dstate["lm"].shape[0], dnrow, 4),
          f"fused_pairs at the DDE chunk: {tuple(pairs.shape)}")
    pairs_equal = torch.equal(pairs, plain_pairs)
    check(pairs_equal, "fused_pairs vs plain at the DDE chunk: not equal, max abs "
          f"{float((pairs - plain_pairs).abs().max()):.3e}")
    pairs_ms = kernel_median_ms(lambda: cf.fused_pairs(*pair_args))
    npairs = pairs.shape[0] * pairs.shape[1]
    pairs_bound = bound(nbytes(pairs, *pair_args[:3]), PAIRS_INSTRUCTIONS * npairs)
    del pairs, plain_pairs
    # the kernel alone on the chunk's operands (every source, one block):
    # against its plain version, timed beside its bound and the plain time
    factory = RimeFactory(DDE_SPEC)
    kops = factory.kernel_operands(dstate)
    kout = torch.empty((dstate["uvw"].shape[0], dstate["chan_freq"].shape[0], 4),
                       dtype=torch.complex64, device=device)
    cf.fused_dde(kops, kout)
    plain_out = torch.empty_like(kout)
    _, plain_ms = cuda_once_ms(lambda: cf.fused_dde_reference(kops, plain_out))
    fused_abs = float((kout - plain_out).abs().max())
    fused_err = fused_abs / float(plain_out.abs().max())
    check(fused_err <= FUSED_PLAIN_BOUND,
          f"fused_dde vs plain at the DDE chunk: {fused_err:.3e}")
    del plain_out
    fused_ms = kernel_median_ms(lambda: cf.fused_dde(kops, kout))
    least, bound_by = work.least_seconds(**work.shape(entry.shapes))
    source = "africanus_tpu_torch/csrc/fused_dde.cu"
    kernel_entries = [
        {"name": "fused_pairs", "route": "cuda", "source": source, "replaces": None,
         "launches": drun["launches"]["fused_pairs"], "max_abs_err": 0.0,
         "ms": pairs_ms, "plain_ms": pairs_plain_ms, **pairs_bound, "library_ms": None},
        {"name": "fused_dde", "route": "cuda", "source": source, "replaces": None,
         "launches": drun["launches"]["fused_dde"], "max_abs_err": fused_abs,
         "ms": fused_ms, "plain_ms": plain_ms, "bound_ms": least * 1e3,
         "bound_by": bound_by, "library_ms": None}]
    del kops, kout, dstate
    runs["DDE"] = dict(drun, fn=lambda: rime(DDE_SPEC, **dargs))
    print(f"[20/{PHASES}] fused RIME, no block given: {nrow} rows x {nchan} chan x "
          f"4 corr, {FUSED['nsrc']} gaussian sources; {KGB_SPEC!r}: "
          + _fused_line("KGB", runs["KGB"]) + f", 3 windows of {wr} rows x {wc} chan "
          f"vs float64 oracle {kgb_err:.2e} (bound {FUSED_BOUND}); {E_SPEC!r} (129² x "
          f"8 x 4 cube): " + _fused_line("E", runs["E"]) + f", launches {counts}, "
          f"window vs CPU {e_err:.2e} (bound {FUSED_E_BOUND}), blocks {eblock} vs "
          f"{eblock2} {blocks_err:.2e} (bound {FUSED_BLOCKS_BOUND}); {DDE_SPEC!r} at "
          f"{DDE_CELL}'s chunk ({tuple(entry.beam['beam'].shape)} cube): "
          + _fused_line("DDE", runs["DDE"]) + f", launches {dict(dcounts, **drun['launches'])}, "
          f"{cell['traffic']['kept_rows']} kept rows vs the cell's float64 "
          f"reference {vis_err:.2e} (the cell's limit {limit}); beam_interp and "
          f"beam_blend on a block's {nsamp} samples vs plain "
          + ", ".join(f"{k} {v:.2e}" for k, v in kernel_err.items())
          + f" (bound {BEAM_BOUND}); fused_pairs alone on the chunk's {npairs} pairs "
          f"{pairs_ms:.4f} ms (bound {pairs_bound['bound_ms']:.4f} ms, "
          f"{pairs_bound['bound_by']}; plain {pairs_plain_ms:.1f} ms), equal to plain "
          f"{pairs_equal}; fused_dde alone on the chunk {fused_ms:.3f} ms "
          f"(bound {least * 1e3:.3f} ms, {bound_by}; plain {plain_ms:.1f} ms), vs "
          f"plain {fused_err:.2e} (bound {FUSED_PLAIN_BOUND})", flush=True)
    return {"runs": runs, "launches": counts, "kernels": kernel_entries,
            "nvis": {"KGB": nrow * nchan * 4, "E": nrow * nchan * 4, "DDE": dnvis}}


def slice_times(card, avg, fz):
    """Phase 21: times of the averagers at both cells and of the fused
    RIME, with profiles."""
    import torch

    lines = []
    for cell, (calls, nvis) in avg["cells"].items():
        for name, fn in calls.items():
            ms, _ = cuda_median_ms(fn)
            host = host_median_ms(fn)
            lines.append(f"{name} at {cell} {ms:.3f} ms (host clock {host:.3f} ms) = "
                         f"{_mvis(nvis, ms):.1f} Mvis/s")
    for name, run in fz["runs"].items():
        ms, _ = cuda_median_ms(run["fn"], reps=3, warmup=1)
        lines.append(f"fused {name} per chunk {ms:.1f} ms = {_mvis(fz['nvis'][name], ms):.1f} "
                     f"Mvis/s (block {run['block']})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for calls, _ in avg["cells"].values():
        for fn in calls.values():
            fn()
    torch.cuda.synchronize()
    avg_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[21/{PHASES}] slice times on {card} (CUDA-event medians of 7 after 2 "
          "warm-ups, mapper and tables cached; the fused RIME 3 after 1): "
          + "; ".join(lines) + "; host (cold): " + ", ".join(
              f"{k} {v:.2f} s" for k, v in avg["host_s"].items())
          + f"; peak device memory: averaging {avg_peak:.2f} GiB, fused "
          + ", ".join(f"{k} {r['peak'] / 2**30:.2f} GiB" for k, r in fz["runs"].items()),
          flush=True)
    profiles = {f"{name} at meerkat": fn
                for name, fn in avg["cells"]["meerkat"][0].items()}
    profiles.update({f"{name} at bench": fn
                     for name, fn in avg["cells"]["bench"][0].items()})
    profiles.update({f"fused {name}": r["fn"] for name, r in fz["runs"].items()})
    for name, fn in profiles.items():
        reps = 1 if name.startswith("fused") else 3
        wall, busy, rows = _profile(fn, reps=reps)
        top = "; ".join(f"{k[:40]} x{count // reps} {ms / reps:.3f} ms"
                        for k, count, ms in rows[:5])
        print(f"[21/{PHASES}] profiler, {name}, per call of {reps}: host "
              f"{wall / reps:.3f} ms, device busy {busy / reps:.3f} ms (idle "
              f"{1 - busy / wall:.1%}), by device time: {top}", flush=True)


# phases 22-25: the sky-model tail. Phase 22: the WSClean store path at
# MeerKAT-64 full band — 64 antennas in a 4 km box, 16 dumps of 8 s with
# Earth rotation (32,256 rows), 4096 channels 0.856-1.712 GHz, one
# correlation — and a seeded WSClean list of 2,000 components (70% POINT,
# 30% GAUSSIAN, within 1 deg of the phase centre), streamed in chunks of
# 8064 rows
STORE = dict(nant=64, ntime=16, nchan=4096, seed=22)
STORE_NSRC, STORE_CHUNK = 2000, 8064
STORE_PHASE_DIR = (1.0472, -0.5236)
STORE_WINDOW = (256, 16)  # rows × channels of every chunk against float64
STORE_PLAIN_ROWS = 512  # rows of the kernel against its plain version
STORE_BOUND = 1e-5  # both, relative to max|V|
# phase 23: Zernike DDE, the first 20 Noll terms per (antenna, channel,
# correlation); phase 24: shapelets of nmax 8×8 at the MeerKAT-64 chunk;
# phase 25: the SPI fit of a 1024² model's components in 8 bands
ZERNIKE = dict(nsrc=100, ntime=4, nant=64, nchan=4096, npoly=20, seed=23)
SHAPELET = dict(nant=64, ntime=4, nchan=4096, nsrc=4, nmax=8, seed=24)
SHAPELET_ROWS = 64  # rows held against the CPU in float64
SPI = dict(ncomp=1 << 20, nband=8, maxiter=100, seed=25)
SPI_SUBSET = 4096
TAIL_BOUND = 1e-5  # Zernike and shapelets on the card against CPU float64
# the SPI fit: float64 on the card against the CPU, and both precisions
# against the true (α, I₀) of noiseless spectra and float32 against the
# CPU's float64 at the bounds of tests/test_zernike_shapelets_spi.py:227-228
SPI_F64_BOUND, SPI_TRUE_BOUND = 1e-6, 1e-4
TAIL_MEMORY = 40 * 2**30


def wsclean_oracle_f64(uvw, sky, freq):
    """(row, chan) float64 visibilities of a loaded component list: the
    formula of tests/test_wsclean.py:109-131 with the spectra of its
    np_ordinary/np_log, vectorised over sources, on the float32 inputs
    widened to float64."""
    f64 = np.float64
    lm, uvw, freq = sky["lm"].astype(f64), uvw.astype(f64), freq.astype(f64)
    flux, coeffs = sky["flux"].astype(f64), sky["coeffs"].astype(f64)
    ratio = freq[None, :] / sky["ref_freq"].astype(f64)[:, None]
    exps = np.arange(1, coeffs.shape[1] + 1)
    ordinary = flux[:, None] + (coeffs[:, None, :] * (ratio - 1.0)[:, :, None] ** exps).sum(2)
    logarithmic = flux[:, None] * np.exp(
        (coeffs[:, None, :] * np.log(ratio)[:, :, None] ** exps).sum(2))
    spectrum = np.where(sky["log_poly"][:, None], logarithmic, ordinary)
    l, m = lm[:, 0, None], lm[:, 1, None]  # noqa: E741
    n = np.sqrt(1 - l * l - m * m) - 1
    u, v, w = uvw.T
    rp = 2 * np.pi / 2.99792458e8 * (u * l + v * m + w * n)  # (src, row)
    amp = spectrum[:, None, :] * np.exp(1j * rp[:, :, None] * freq)
    emaj, emin, ang = sky["gauss_shape"].astype(f64).T
    el, em = (emaj * np.sin(ang))[:, None], (emaj * np.cos(ang))[:, None]
    er = (emin / np.where(emaj == 0, 1.0, emaj))[:, None]
    u1, v1 = (u * em - v * el) * er, u * el + v * em
    sf = freq * (np.sqrt(2) * np.pi / (2 * np.sqrt(2 * np.log(2))) / 2.99792458e8)
    env = np.exp(-((u1[:, :, None] * sf) ** 2 + (v1[:, :, None] * sf) ** 2))
    gauss = (sky["source_type"] == "GAUSSIAN")[:, None, None]
    return (amp * np.where(gauss, env, 1.0)).sum(0)


def store_path(device, card):
    """Phase 22: the WSClean store path through the user's entry point,
    predict_to_ms_store, at MeerKAT-64 full band. Returns its predict_kb
    launches."""
    import shutil
    import tempfile

    import torch
    from africanus_tpu_torch.examples.predict_to_ms_store import (
        chunk_digest, predict_to_ms_store, random_component_list, sky_arrays,
    )
    from africanus_tpu_torch.io import MSStore
    from africanus_tpu_torch.model.wsclean import load
    from africanus_tpu_torch.ops.cuda_predict import predict_kb, predict_kb_reference
    from africanus_tpu_torch.rime.wsclean_predict import kb_operands
    from africanus_tpu_torch.testing.averaging import meerkat_inputs

    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        t0 = time.perf_counter()
        geo = meerkat_inputs(nant=STORE["nant"], ntime=STORE["ntime"], nchan=1, ncorr=1,
                             flag_frac=0.0, seed=STORE["seed"])
        nrow, nchan = geo["uvw"].shape[0], STORE["nchan"]
        freq = np.linspace(0.856e9, 1.712e9, nchan)
        store_dir = os.path.join(tmp, "store")
        MSStore.create(store_dir, dict(
            TIME=geo["time"], ANTENNA1=geo["antenna1"].astype(np.int32),
            ANTENNA2=geo["antenna2"].astype(np.int32), UVW=geo["uvw"],
            MODEL_DATA=np.zeros((nrow, nchan, 1), np.complex64)),
            dict(FIELD=dict(PHASE_DIR=list(STORE_PHASE_DIR)),
                 SPECTRAL_WINDOW=dict(CHAN_FREQ=freq)))
        model_file = os.path.join(tmp, "sky_model.txt")
        with open(model_file, "w") as fh:
            fh.write(random_component_list(STORE_NSRC, STORE_PHASE_DIR,
                                           seed=STORE["seed"]))
        setup_s = time.perf_counter() - t0

        # the user's entry point, counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        predict_kb.launches = 0
        t0 = time.perf_counter()
        run = predict_to_ms_store(store_dir, model_file, chunk=STORE_CHUNK, device=device)
        wall = time.perf_counter() - t0
        launches = predict_kb.launches
        peak = torch.cuda.max_memory_allocated() - resident
        nchunk = -(-nrow // STORE_CHUNK)
        check(launches == nchunk == run.launches == len(run.slices),
              f"store path: predict_kb launched {launches} times for {nchunk} chunks")
        check(run.nvis == nrow * nchan, f"store path wrote {run.nvis} visibilities")

        # MODEL_DATA through a fresh handle: bitwise what was predicted, and
        # a window of every chunk against float64
        store = MSStore(store_dir)
        for sl, digest in zip(run.slices, run.digests):
            check(chunk_digest(store.read_pair("MODEL_DATA", sl)) == digest,
                  f"MODEL_DATA rows {sl.start}-{sl.stop} differ from the prediction")
        sky = sky_arrays(dict(load(model_file)), STORE_PHASE_DIR)
        freq32 = freq.astype(np.float32)
        wr, wc = STORE_WINDOW
        chans = np.unique(np.linspace(0, nchan - 1, wc).round().astype(int))
        uvw32 = geo["uvw"].astype(np.float32)
        errs = []
        for sl in run.slices:
            rows = np.unique(np.linspace(sl.start, sl.stop - 1, wr).round().astype(int))
            got = store.read("MODEL_DATA", rows)[:, chans, 0]
            check(np.isfinite(got).all(), "non-finite MODEL_DATA")
            errs.append(rel_err(got, wsclean_oracle_f64(uvw32[rows], sky, freq32[chans])))
        check(max(errs) <= STORE_BOUND, f"store path vs float64: {max(errs):.3e}")
        ngauss = int((sky["source_type"] == "GAUSSIAN").sum())

        # where a chunk's write goes: MSStore.write's three steps timed
        # apart on the first chunk's values, written again
        values = store.read("MODEL_DATA", run.slices[0])
        t0 = time.perf_counter()
        pairs = np.stack([values.real, values.imag], axis=-1)
        t1 = time.perf_counter()
        column = np.load(os.path.join(store_dir, "MODEL_DATA.npy"), mmap_mode="r+")
        column[run.slices[0]] = pairs
        t2 = time.perf_counter()
        column.flush()
        write_split = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        del column, pairs, values

        # the kernel against its plain version, then its time per chunk
        def operands(rows):
            return kb_operands(torch.as_tensor(uvw32[rows], device=device),
                               frequency=torch.as_tensor(freq32, device=device),
                               **{k: (torch.as_tensor(v, device=device)
                                      if k != "source_type" else v)
                                  for k, v in sky.items()})

        ops = operands(slice(0, STORE_PLAIN_ROWS))
        got = predict_kb(*ops)
        want = predict_kb_reference(*ops)
        kb_abs = float((got - want).abs().max())
        kb_scale = float(want.abs().max())
        check(kb_abs <= STORE_BOUND * kb_scale,
              f"store path kernel vs plain: {kb_abs:.3e} > 1e-5 x {kb_scale:.3e}")
        ops = operands(run.slices[0])
        kernel_ms, _ = cuda_median_ms(lambda: predict_kb(*ops), reps=3, warmup=1)
        nr = run.slices[0].stop
        # the map's work: the envelope only on the gaussian components
        kb = bound(nbytes(ops) + nr * nchan * 8,
                   nr * nchan * (ngauss * predict_instr(1, True)
                                 + (STORE_NSRC - ngauss) * predict_instr(1, False)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    stages = {k: [s[k] for s in run.stage_seconds] for k in run.stage_seconds[0]}
    print(f"[22/{PHASES}] WSClean store path on {card}: {nrow} rows x {nchan} chan x 1 "
          f"corr in {nchunk} chunks of {STORE_CHUNK}, {STORE_NSRC} components "
          f"({ngauss} gaussian), store and list made in {setup_s:.1f} s; "
          f"predict_to_ms_store {wall:.2f} s = {run.nvis / wall / 1e6:.1f} Mvis/s incl. "
          f"IO, per chunk (s) " + ", ".join(
              f"{k} " + "/".join(f"{x:.3f}" for x in v) for k, v in stages.items())
          + "; a chunk's write again: split into (re, im) {:.3f}, into the mapped "
          "column {:.3f}, flush {:.3f} s (store under {})".format(
              *write_split, tempfile.gettempdir())
          + f"; predict_kb launches {launches}, kernel {kernel_ms:.2f} ms a chunk "
          f"(bound {kb['bound_ms']:.2f} ms by {kb['bound_by']}, "
          f"{kb['bound_ms'] / kernel_ms:.0%} of it; was {PREVIOUS_MS['predict_kb_store']}"
          f"); peak device memory "
          f"{peak / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB resident before "
          f"the pass; MODEL_DATA re-read bitwise equal; {wr} rows x "
          f"{wc} chan of every chunk vs float64 " + ", ".join(f"{e:.2e}" for e in errs)
          + f"; kernel vs plain on {STORE_PLAIN_ROWS} rows max abs err {kb_abs:.3e} "
          f"(max|V| {kb_scale:.3e}); bounds {STORE_BOUND}", flush=True)
    return {"predict_kb": launches}


def zernike_problem(nsrc, ntime, nant, nchan, npoly, seed, device):
    """Seeded zernike_dde operands on ``device`` (float32, complex64
    coefficients; ``noll`` the first ``npoly`` Noll indices in every
    (antenna, channel, correlation)), as a tuple in its argument order."""
    import torch

    rng = np.random.default_rng(seed)
    f32 = np.float32

    def t(x):
        return torch.as_tensor(x, device=device)

    lm = rng.uniform(-0.7, 0.7, (nsrc, 2)).astype(f32)
    coords = torch.empty((3, nsrc, ntime, nant, nchan), dtype=torch.float32,
                         device=device)
    coords[0] = t(lm[:, 0])[:, None, None, None]
    coords[1] = t(lm[:, 1])[:, None, None, None]
    coords[2] = t(np.linspace(0.856e9, 1.712e9, nchan).astype(f32))
    shape = (nant, nchan, 2, 2, npoly)
    coeffs = np.empty(shape, np.complex64)
    coeffs.real = rng.standard_normal(shape, f32)
    coeffs.imag = rng.standard_normal(shape, f32)
    coeffs /= np.arange(1, npoly + 1, dtype=f32)  # falling with order
    noll = np.broadcast_to(np.arange(npoly), shape)
    return (coords, t(coeffs), noll,
            t(rng.uniform(-np.pi, np.pi, (ntime, nant)).astype(f32)),
            t(rng.uniform(0.95, 1.05, nchan).astype(f32)),
            t(rng.uniform(0.95, 1.05, (nant, nchan, 2)).astype(f32)),
            t(rng.normal(scale=0.01, size=(ntime, nant, nchan, 2)).astype(f32)))


def shapelet_problem(nant, ntime, nchan, nsrc, nmax, seed, device):
    """Seeded shapelet operands on ``device``: the uvw of ``ntime`` dumps of
    ``nant`` antennas (meerkat_inputs), channels over 0.856-1.712 GHz,
    (nmax, nmax) coefficients, scales of 0.4-2″, positions within 0.6°;
    float32. Returns (coords, frequency, coeffs, beta, delta_lm, lm)."""
    import torch
    from africanus_tpu_torch.testing.averaging import meerkat_inputs

    rng = np.random.default_rng(seed)
    uvw = meerkat_inputs(nant=nant, ntime=ntime, nchan=1, ncorr=1, flag_frac=0.0,
                         seed=seed)["uvw"]

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return (t(uvw), t(np.linspace(0.856e9, 1.712e9, nchan)),
            t(rng.normal(size=(nsrc, nmax, nmax))),
            t(rng.uniform(2e-6, 1e-5, (nsrc, 2))), (1e-5, 1e-5),
            t(rng.uniform(-0.01, 0.01, (nsrc, 2))))


def spi_problem(ncomp, nband, seed):
    """Noiseless power-law spectra of ``ncomp`` components in ``nband``
    bands (float64 numpy), α in [-1.2, -0.2] and I₀ in [0.5, 5) (the
    draws of tests/test_zernike_shapelets_spi.py:216-217): (data,
    weights, freqs, freq0, alpha, I0)."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(0.856e9, 1.712e9, nband + 1)
    freqs = (edges[1:] + edges[:-1]) / 2
    freq0 = 1.284e9
    alpha = rng.uniform(-1.2, -0.2, ncomp)
    i0 = rng.uniform(0.5, 5.0, ncomp)
    data = i0[:, None] * (freqs / freq0) ** alpha[:, None]
    return data, np.ones(nband), freqs, freq0, alpha, i0


def sky_tail(device, card):
    """Phases 23-25: the Zernike DDE, shapelets and the SPI fit on the
    card against the CPU in float64."""
    import torch
    from africanus_tpu_torch.model.shape import shapelet, shapelet_with_w_term
    from africanus_tpu_torch.model.spi import fit_spi_components
    from africanus_tpu_torch.rime import zernike_dde

    def cpu64(x):
        if not isinstance(x, torch.Tensor):
            return x
        return x.cpu().to(torch.complex128 if x.is_complex() else torch.float64)

    # 23. Zernike
    z = ZERNIKE
    args = zernike_problem(**z, device=device)
    out, peak = _peak_of(lambda: zernike_dde(*args))
    check(tuple(out.shape) == (z["nsrc"], z["ntime"], z["nant"], z["nchan"], 2, 2)
          and out.dtype == torch.complex64, f"zernike {tuple(out.shape)} {out.dtype}")
    check(bool(torch.isfinite(torch.view_as_real(out)).all()), "zernike non-finite")
    check(peak < TAIL_MEMORY, f"zernike peak {peak / 2**30:.2f} GiB")
    coords, coeffs, noll, pa, fscale, ascale, pe = args
    sub = (coords[:, :2, :1], coeffs, noll, pa[:1], fscale, ascale, pe[:1])
    want = zernike_dde(*map(cpu64, sub))
    z_err = rel_err(out[:2, :1].cpu().numpy(), want.numpy())
    check(z_err <= TAIL_BOUND, f"zernike vs CPU float64: {z_err:.3e}")
    out_gib = out.numel() * out.element_size() / 2**30
    del out
    z_ms, _ = cuda_median_ms(lambda: zernike_dde(*args), reps=3, warmup=1)
    print(f"[23/{PHASES}] Zernike DDE on {card}: {z['nsrc']} src x {z['ntime']} times x "
          f"{z['nant']} ant x {z['nchan']} chan x 2x2 corr, {z['npoly']} Noll terms "
          f"({out_gib:.2f} GiB complex64): {z_ms:.1f} ms, peak device memory "
          f"{peak / 2**30:.2f} GiB; 2 src x 1 time vs CPU float64 {z_err:.2e} "
          f"(bound {TAIL_BOUND})", flush=True)
    del args, sub, want

    # 24. shapelets, with and without the w term
    s = SHAPELET
    coords, freq, coeffs, beta, delta, lm = shapelet_problem(**s, device=device)
    nrow = coords.shape[0]
    rows = torch.as_tensor(np.linspace(0, nrow - 1, SHAPELET_ROWS).round().astype(int))
    lines = []
    for name, fn, extra in (("shapelet", shapelet, ()),
                            ("shapelet_with_w_term", shapelet_with_w_term, (lm,))):
        out, peak = _peak_of(lambda: fn(coords, freq, coeffs, beta, delta, *extra,
                                        dtype=torch.complex64))
        check(tuple(out.shape) == (nrow, s["nchan"], s["nsrc"]), f"{name} {out.shape}")
        check(bool(torch.isfinite(torch.view_as_real(out)).all()), f"{name} non-finite")
        check(peak < TAIL_MEMORY, f"{name} peak {peak / 2**30:.2f} GiB")
        want = fn(cpu64(coords)[rows], cpu64(freq), cpu64(coeffs), cpu64(beta), delta,
                  *map(cpu64, extra))
        err = rel_err(out[rows.to(device)].cpu().numpy(), want.numpy())
        check(err <= TAIL_BOUND, f"{name} vs CPU float64: {err:.3e}")
        del out
        ms, _ = cuda_median_ms(lambda: fn(coords, freq, coeffs, beta, delta, *extra,
                                          dtype=torch.complex64), reps=3, warmup=1)
        lines.append(f"{name} {ms:.1f} ms, peak {peak / 2**30:.2f} GiB, "
                     f"{SHAPELET_ROWS} rows vs CPU float64 {err:.2e}")
    print(f"[24/{PHASES}] shapelets on {card}: {nrow} rows x {s['nchan']} chan x "
          f"{s['nsrc']} src, nmax {s['nmax']}x{s['nmax']}, complex64: "
          + "; ".join(lines) + f" (bound {TAIL_BOUND})", flush=True)

    # 25. the SPI fit in float64 and float32
    p = SPI
    data, weights, freqs, freq0, alpha, i0 = spi_problem(p["ncomp"], p["nband"],
                                                         p["seed"])
    ref = fit_spi_components(*(torch.as_tensor(x[:SPI_SUBSET] if x.ndim == 2 else x)
                               for x in (data, weights, freqs)), freq0,
                             maxiter=p["maxiter"]).numpy()
    lines = []
    for dtype in (torch.float64, torch.float32):
        ops = [torch.as_tensor(x, device=device).to(dtype) for x in (data, weights, freqs)]
        out = fit_spi_components(*ops, freq0, maxiter=p["maxiter"])
        iters = fit_spi_components.iterations
        check(tuple(out.shape) == (4, p["ncomp"]) and out.dtype == dtype,
              f"SPI {tuple(out.shape)} {out.dtype}")
        got = out.cpu().double().numpy()
        check(np.isfinite(got).all(), "SPI non-finite")
        true_err = max(np.abs(got[0] - alpha).max(),
                       np.abs(got[2] / i0 - 1).max())
        check(true_err <= SPI_TRUE_BOUND, f"SPI {dtype} vs the truth: {true_err:.3e}")
        cpu_err = max(np.abs(got[0, :SPI_SUBSET] - ref[0]).max(),
                      np.abs(got[2, :SPI_SUBSET] / ref[2] - 1).max())
        cpu_bound = SPI_F64_BOUND if dtype == torch.float64 else SPI_TRUE_BOUND
        check(cpu_err <= cpu_bound, f"SPI {dtype} card vs CPU float64: {cpu_err:.3e}")
        ms, _ = cuda_median_ms(lambda: fit_spi_components(*ops, freq0,
                                                          maxiter=p["maxiter"]),
                               reps=3, warmup=1)
        lines.append(f"{str(dtype)[6:]} {ms:.2f} ms, {iters} iterations, vs the truth "
                     f"{true_err:.2e}, {SPI_SUBSET} comps vs CPU float64 {cpu_err:.2e}")
    print(f"[25/{PHASES}] SPI fit on {card}: {p['ncomp']} components x {p['nband']} "
          f"bands, maxiter {p['maxiter']}: " + "; ".join(lines)
          + f" (bounds: α and I₀ relative {SPI_TRUE_BOUND} vs the truth and the "
          f"float32 fit vs CPU, {SPI_F64_BOUND} the float64 fit vs CPU)", flush=True)


# phases 26-28: the application layer. Phase 26: GP phase gains (the
# generate_gains path) at MeerKAT-64 × 256 dumps × 4096 channels (0.856-
# 1.712 GHz) × 16 directions: covariance factors 256², 4096² and 16², N =
# 16,777,216 draws per antenna; phase 27: the two MS-store pipelines at the
# MeerKAT-64 1K geometry (64 antennas, 16 dumps: 32,256 rows, 1024
# channels, 1 correlation), selfcal with 20 sources as config 5, the screen
# with its 3 directions; phase 28: the other ten examples on the card
GP = dict(nant=64, ntime=256, nchan=4096, ndir=16, seed=26)
GP_FACTOR_BOUND = 1e-12  # ‖LLᵀ − K‖/‖K‖, float64
GP_CPU_BOUND = 1e-10     # antenna 0's draw against the CPU, float64
GP_F32_BOUND = 1e-5      # float32 against float64 on the card
GP_UNIT_BOUND = 1e-12    # ||g| − 1|, float64
GP_MEMORY = 60e9
# dense peaks of the H100 SXM at 700 W (NVIDIA's data sheet): FP64 on the
# tensor cores (cuBLAS DGEMM) and FP32 outside them, 67 TFLOP/s each
FP64_FLOPS, FP32_FLOPS = 67e12, 67e12
STORE_1K = dict(nant=64, ntime=16, nchan=1024)
STORE_SELFCAL_NSRC, STORE_SCREEN_NSRC = 20, 3
# the examples' own bounds: the selfcal store's gain products
# (examples/selfcal_ms_store.py:181), the screen's (apply_phase_screen_
# ms_store.py:203)
STORE_SELFCAL_BOUND, STORE_SCREEN_BOUND = 5e-4, 1e-3
# the selfcal store's MODEL_DATA against plain predict_kb on its first
# rows (two dumps), at phase 3's compensated-mode bound
STORE_MODEL_ROWS, STORE_MODEL_BOUND = 4032, 2e-6
# phase 28: predict_dft at config 1 (bench.py:474-549: KAT-7 × 96 dumps),
# make_dirty at 1024² from 1M rows × 4 channels, spi_fitter_cube on an
# 8-band 4096² cube (0.0002° cells, 0.9-1.6 GHz) of 10,000 power-law
# components on a jittered 100 × 100 grid (≥ 20 pixels apart), a noise
# residual and a 257² beam cube over 3°; the rest at the JAX examples'
# defaults. The cube spans ±0.41°, inside the radius where the factory's
# cos³ beam is clipped at 1.6 GHz (0.6°): across that kink a component's
# interpolated beam moves its α by up to ~0.07
EX_DFT = dict(nsrc=100, nant=7, nchan=64, ntime=96)
EX_DIRTY = dict(nx=1024, nrow=1_000_000)
EX_CUBE = dict(nband=8, npix=4096, ncomp=10_000, cell=0.0002, seed=28)
EX_ALPHA_BOUND = 0.05  # tests/test_examples.py:143
EX_PLAIN_BOUND = 1e-5  # an example on the card against its CPU run, of max
# predict_shapelet in float32 against float64: its Hermite basis at
# arguments to ~70 and the phases put the CPU's own float32 run 6.9e-6 of
# max from float64
EX_SHAPELET_BOUND = 2e-5


def _taps_per_cell(plan):
    """The most taps of a w-stack plan's samples that land on one cell."""
    import torch
    from africanus_tpu_torch.ops import cuda_wgrid as cw

    counts = torch.zeros(plan.nplanes * plan.nu * plan.nv, dtype=torch.int64,
                         device=plan.device)
    for lo, hi, _ in cw._chunks(plan):
        idx, _ = cw._chunk_taps(plan, lo, hi)
        counts += torch.bincount(idx.reshape(-1), minlength=counts.numel())
    return int(counts.max())


def _grid_vs_plain(what, plan, flat):
    """grid_wstack on an imaging plan's w-stack against its plain version
    (float32 sums) and the plain version with float64 sums of the same
    products (the oracle), one launch each. Checks the kernel against
    the oracle; returns the errors, times, the most taps a cell and the
    oracle grid rounded to the plan's dtype."""
    from africanus_tpu_torch.ops import cuda_wgrid as cw
    import torch

    w = plan.wgrid
    grid, ms = cuda_once_ms(lambda: cw.grid_wstack(w, flat))
    plain, plain_ms = cuda_once_ms(lambda: cw.grid_wstack_reference(w, flat))
    oracle = cw.grid_wstack_reference(w, flat, accumulate=torch.float64)
    scale = float(oracle.abs().max())
    out = dict(ms=ms, plain_ms=plain_ms, taps=_taps_per_cell(w),
               kernel=float((grid - oracle).abs().max()) / scale,
               plain=float((plain - oracle).abs().max()) / scale,
               kernel_plain=float((grid - plain).abs().max()) / scale)
    check(out["kernel"] <= WGRID_BOUND,
          f"{what} grid_wstack vs float64 sums: {out['kernel']:.3e}")
    out["oracle"] = oracle.to(grid.dtype)
    return out


def _grid_line(g):
    return (f"grid_wstack {g['ms']:.2f} ms, plain {g['plain_ms']:.1f} ms; at up to "
            f"{g['taps']} taps a cell, of max|grid| from float64 sums: kernel "
            f"{g['kernel']:.2e} ({WGRID_BOUND}), plain {g['plain']:.2e}; kernel vs "
            f"plain {g['kernel_plain']:.2e}")


def zero_counts():
    from africanus_tpu_torch.examples import launches

    for fn in launches.WRAPPERS:
        fn.launches = 0


def read_counts():
    """{wrapper: launches} of the wrappers that launched since
    :func:`zero_counts`."""
    from africanus_tpu_torch.examples import launches

    return {fn.__name__: fn.launches for fn in launches.WRAPPERS if fn.launches}


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def gp_gains(device, card):
    """Phase 26: the generate_gains path at full width in float64 and
    float32, its four checks, times and peaks. Returns its launches
    (none: the products are cuBLAS's)."""
    import torch
    from africanus_tpu_torch.examples.generate_gains import (
        example_coordinates, gp_phase_gains,
    )
    from africanus_tpu_torch.linalg import kron_matmat, kron_matvec

    g = GP
    rng = np.random.default_rng(g["seed"])
    t, nu, src = example_coordinates(rng, g["ntime"], g["nchan"], g["ndir"])
    n = g["ntime"] * g["nchan"] * g["ndir"]
    flops = 2 * n * (g["ntime"] + g["nchan"] + g["ndir"]) * g["nant"]

    def run(dtype, xi=None):
        gen = torch.Generator(device=device).manual_seed(g["seed"])
        return gp_phase_gains(t, nu, src, g["nant"], xi=xi, generator=gen,
                              device=device, dtype=dtype)

    zero_counts()
    out, peak64 = _peak_of(lambda: run(torch.float64))
    launches = read_counts()
    check(peak64 < GP_MEMORY, f"GP gains float64 peak {peak64 / 1e9:.2f} GB")
    check(tuple(out.gains.shape) == (g["ntime"], g["nant"], g["nchan"], g["ndir"], 1)
          and out.gains.dtype == torch.complex128, f"GP gains {tuple(out.gains.shape)}")
    factor_err = max(float(torch.linalg.matrix_norm(L @ L.T - K)
                           / torch.linalg.matrix_norm(K))
                     for K, L in zip(out.covariances, out.factors))
    check(factor_err <= GP_FACTOR_BOUND, f"GP factors ‖LLᵀ − K‖/‖K‖ {factor_err:.3e}")
    unit_err = float((out.gains.abs() - 1).abs().max())
    check(unit_err <= GP_UNIT_BOUND, f"GP ||g| − 1| {unit_err:.3e}")
    phases64 = out.phases
    factors_card = list(out.factors)
    factors = [L.cpu() for L in factors_card]
    del out
    ms64, _ = cuda_median_ms(lambda: run(torch.float64), reps=3, warmup=1)

    # the same draws again (the generator's seed), antenna 0 on the CPU
    xi = torch.randn((g["nant"], n), generator=torch.Generator(device=device).manual_seed(
        g["seed"]), dtype=torch.float64, device=device)
    want = kron_matvec(factors, xi[0].cpu()).reshape(g["ntime"], g["nchan"], g["ndir"])
    cpu_err = rel_err(phases64[:, 0].cpu().numpy(), want.numpy())
    check(cpu_err <= GP_CPU_BOUND, f"GP antenna 0 vs CPU float64: {cpu_err:.3e}")
    # the Kronecker products alone (cuBLAS) on draws made beforehand
    matmat_ms = {}
    matmat_ms[64], _ = cuda_median_ms(lambda: kron_matmat(factors_card, xi.T), reps=3,
                                      warmup=1)
    xi32 = xi.float()
    del xi
    factors32 = [L.float() for L in factors_card]
    matmat_ms[32], _ = cuda_median_ms(lambda: kron_matmat(factors32, xi32.T), reps=3,
                                      warmup=1)
    del factors_card, factors32
    out32, peak32 = _peak_of(lambda: run(torch.float32, xi32))
    check(out32.gains.dtype == torch.complex64, f"GP float32 gains {out32.gains.dtype}")
    scale = float(phases64.abs().max())
    f32_err = float((out32.phases.double() - phases64).abs().max()) / scale
    check(f32_err <= GP_F32_BOUND, f"GP float32 vs float64: {f32_err:.3e}")
    del out32, phases64, xi32
    ms32, _ = cuda_median_ms(lambda: run(torch.float32), reps=3, warmup=1)
    torch.cuda.empty_cache()
    print(f"[26/{PHASES}] GP phase gains on {card}: {g['nant']} ant x {g['ntime']} times "
          f"x {g['nchan']} chan x {g['ndir']} dir (N = {n} a antenna; factors "
          f"{g['ntime']}², {g['nchan']}², {g['ndir']}²), {flops / 1e12:.2f} TFLOP a call: "
          f"float64 {ms64:.1f} ms ({flops / ms64 / 1e9:.1f} TFLOP/s; bound "
          f"{flops / FP64_FLOPS * 1e3:.1f} ms at 67 TFLOP/s FP64 tensor cores), peak "
          f"{peak64 / 1e9:.2f} GB; float32 {ms32:.1f} ms ({flops / ms32 / 1e9:.1f} "
          f"TFLOP/s; bound {flops / FP32_FLOPS * 1e3:.1f} ms at 67 TFLOP/s FP32, no TF32), "
          f"peak {peak32 / 1e9:.2f} GB; the Kronecker products alone (kron_matmat on "
          f"draws made beforehand) float64 {matmat_ms[64]:.1f} ms "
          f"({flops / matmat_ms[64] / 1e9:.1f} TFLOP/s), float32 {matmat_ms[32]:.1f} ms "
          f"({flops / matmat_ms[32] / 1e9:.1f} TFLOP/s); ‖LLᵀ − K‖/‖K‖ {factor_err:.2e} (bound "
          f"{GP_FACTOR_BOUND}), antenna 0 vs CPU float64 {cpu_err:.2e} ({GP_CPU_BOUND}), "
          f"float32 vs float64 {f32_err:.2e} ({GP_F32_BOUND}), ||g| − 1| {unit_err:.1e} "
          f"({GP_UNIT_BOUND}); kernel launches {launches or 'none'}", flush=True)
    return launches


def store_examples(device, card):
    """Phase 27: selfcal_ms_store and apply_phase_screen_ms_store at the
    MeerKAT-64 1K geometry in a temporary directory, their own checks,
    the written columns re-read bitwise. Returns their launches."""
    import shutil
    import tempfile

    import torch
    from africanus_tpu_torch.examples import apply_phase_screen_ms_store as screen
    from africanus_tpu_torch.examples import selfcal_ms_store as sc
    from africanus_tpu_torch.examples.predict_to_ms_store import chunk_digest
    from africanus_tpu_torch.gridding.wgridder.core import (
        grid_adjoint, grid_to_image, make_plan,
    )
    from africanus_tpu_torch.io import MSStore
    from africanus_tpu_torch.ops import cuda_wgrid as cw
    from africanus_tpu_torch.ops.cuda_predict import predict_kb_reference
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    s = STORE_1K
    total, lines = {}, []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        path = os.path.join(tmp, "selfcal")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        true_phase = sc.make_corrupted_store(path, np.random.default_rng(17), s["nant"],
                                             s["ntime"], s["nchan"], STORE_SELFCAL_NSRC,
                                             device)
        fabricate = time.perf_counter() - t0
        run = sc.selfcal_ms_store(path, true_phase, device)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() - resident
        _add(total, launches)
        store = MSStore(path)
        nrow = store.nrow
        check(run.gain_error < STORE_SELFCAL_BOUND,
              f"selfcal store gain products {run.gain_error:.3e}")
        check(float(run.clean.max()) > 0, "selfcal store: CLEAN found no component")
        check(chunk_digest(store.read_pair("CORRECTED_DATA")) == run.corrected_digest,
              "selfcal store: CORRECTED_DATA re-read differs")
        check(launches.get("predict_kb") == 1 and launches.get("grid_wstack") == 2
              and launches.get("hogbom") == 1, f"selfcal store launches {launches}")
        stages = dict(fabricate=fabricate, **run.stage_seconds)
        uvw = store.read("UVW").astype(np.float32)
        freq = np.asarray(store.subtables["SPECTRAL_WINDOW"]["CHAN_FREQ"], np.float32)

        # MODEL_DATA (predict_kb) against its plain version on a row slice
        # of the same operands: DATA was corrupted from the same model, so
        # the gains cannot see a wrong one
        sky = store.subtables["SKY"]
        lm = torch.as_tensor(np.asarray(sky["LM"], np.float32), device=device)
        flux = np.asarray(sky["FLUX"], np.float32)
        b = torch.as_tensor(np.broadcast_to(flux[:, None, None],
                                            (flux.size, s["nchan"], 1)).copy(),
                            device=device).to(torch.complex64)
        rows = slice(0, STORE_MODEL_ROWS)
        t_freq = torch.as_tensor(freq, device=device)
        model_p = predict_kb_reference(
            phase_dot_cycles(lm, torch.as_tensor(uvw[rows], device=device)),
            None, None, t_freq, torch.zeros_like(t_freq), b)
        model = torch.as_tensor(store.read("MODEL_DATA")[rows], device=device)
        model_err = float((model - model_p).abs().max() / model_p.abs().max())
        check(model_err <= STORE_MODEL_BOUND,
              f"selfcal store MODEL_DATA vs plain: {model_err:.3e}")
        del model, model_p

        # where the image stage goes: the dirty image again on its cached
        # plan (a content key of uvw and freq), and the kernel alone; then
        # both grids (image and PSF) against their plain versions on the
        # same plans, and the example's normalised image against the one
        # made from the plain grids
        vis = torch.as_tensor(store.read("CORRECTED_DATA")[..., 0], device=device)
        cell = np.float32(0.03 / sc.NX)

        def image():
            return grid_adjoint(uvw, freq, vis, None, sc.NX, sc.NX, cell, cell, 1e-4,
                                do_wstacking=False)

        again = host_median_ms(image, reps=1, warmup=0) / 1e3
        grids = {}
        for name, nx, values in (("image", sc.NX, vis), ("psf", 2 * sc.NX,
                                                         torch.ones_like(vis))):
            plan = make_plan(uvw, freq, nx, nx, cell, cell, 1e-4, False,
                             torch.float32, device)
            grids[name] = _grid_vs_plain(f"selfcal store {name}", plan,
                                         values.reshape(-1).contiguous())
            grids[name]["image"] = grid_to_image(plan, grids[name].pop("oracle"))
            del plan
        ndirty_p = grids["image"].pop("image") / grids["psf"].pop("image").max()
        dirty_err = float((run.dirty - ndirty_p).abs().max() / ndirty_p.abs().max())
        check(dirty_err <= WGRID_BOUND, f"selfcal store dirty image vs the float64-sum "
              f"grids' image: {dirty_err:.3e}")
        del vis, ndirty_p
        lines.append(
            f"selfcal_ms_store {nrow} rows x {s['nchan']} chan x 1 corr, "
            f"{STORE_SELFCAL_NSRC} sources: seconds " + ", ".join(
                f"{k} {v:.2f}" for k, v in stages.items())
            + f" (the dirty image again on its cached plan {again:.2f} s); "
            + "; ".join(f"{k} grid: {_grid_line(v)}" for k, v in grids.items())
            + f"; normalised dirty image vs the float64-sum grids' {dirty_err:.2e} "
            f"({WGRID_BOUND}); MODEL_DATA rows 0-{STORE_MODEL_ROWS} vs plain predict_kb "
            f"{model_err:.2e} ({STORE_MODEL_BOUND}); {run.iterations} GN iterations, "
            f"gain products {run.gain_error:.2e} (bound {STORE_SELFCAL_BOUND}), "
            f"CORRECTED_DATA re-read bitwise; launches {launches}; peak "
            f"{peak / 2**30:.2f} GiB")

        path = os.path.join(tmp, "screen")
        rng = np.random.default_rng(23)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        screen.fabricate_store(path, rng, s["nant"], s["ntime"], s["nchan"],
                               STORE_SCREEN_NSRC)
        fabricate = time.perf_counter() - t0
        t0 = time.perf_counter()
        srun = screen.apply_phase_screen(path, rng, device)
        corrupt = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, iterations, err = screen.calibrate(path, srun.phases, device)
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() - resident
        _add(total, launches)
        store = MSStore(path)
        for sl, digest in zip(srun.slices, srun.digests):
            check(chunk_digest(store.read_pair("DATA", sl)) == digest,
                  f"screen store: DATA rows {sl.start}-{sl.stop} re-read differ")
        check(err < STORE_SCREEN_BOUND, f"screen store gain products {err:.3e}")
        chunks = {k: [x[k] for x in srun.stage_seconds] for k in srun.stage_seconds[0]}
        lines.append(
            f"apply_phase_screen_ms_store {store.nrow} rows x {s['nchan']} chan x "
            f"{STORE_SCREEN_NSRC} directions, float64: seconds fabricate {fabricate:.2f}, "
            f"corrupt + write {corrupt:.2f} ({len(srun.slices)} chunks: " + "; ".join(
                f"{k} " + "/".join(f"{x:.2f}" for x in v) for k, v in chunks.items())
            + f"), read + solve {solve:.2f}; {iterations} GN iterations, gain products "
            f"{err:.2e} (bound {STORE_SCREEN_BOUND}), DATA re-read bitwise; launches "
            f"{launches or 'none'}; peak {peak / 2**30:.2f} GiB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"[27/{PHASES}] the MS-store examples on {card}: " + " | ".join(lines),
          flush=True)
    return total


def spi_cube_problem(path, nband, npix, ncomp, cell, seed):
    """spi_fitter_cube's inputs at full width under ``path``: a 257² beam
    cube (testing.beam_factory), and an (nband, npix, npix) model of
    ``ncomp`` power-law components on a jittered grid (≥ 20 pixels
    apart) times the factory's cos³ beam at their radius, with a noise
    residual, as FITS. Returns (model, residual, schema, truth) with
    truth = (px, py, I₀, α) arrays."""
    from africanus_tpu_torch.testing import beam_factory
    from africanus_tpu_torch.utils.fits import write_fits

    rng = np.random.default_rng(seed)
    ref_freq = 1.2e9
    freqs = np.linspace(0.9e9, 1.6e9, nband)
    side = int(round(np.sqrt(ncomp)))
    step = npix // side
    grid = (np.arange(side) * step + step // 2)
    px = (grid[:, None] + rng.integers(-step // 4, step // 4 + 1, (side, side))).ravel()
    py = (grid[None, :] + rng.integers(-step // 4, step // 4 + 1, (side, side))).ravel()
    i0 = rng.uniform(0.5, 5.0, px.size)
    alpha = rng.uniform(-1.2, 0.3, px.size)
    crpix = npix / 2 + 1.0
    # the factory's beam: cos³(65 ν[GHz] r) clipped at 1.0881 rad
    # the file's array is (band, m, l) — NAXIS1 (l) fastest — and the
    # fitter's maps are read back in the same layout: a component at
    # [px, py] lies at l of py and m of px
    l = np.deg2rad((py + 1 - crpix) * -cell)  # noqa: E741
    m = np.deg2rad((px + 1 - crpix) * cell)
    r = np.hypot(l, m)
    beam = np.cos(np.minimum(65 * freqs[:, None] * 1e-9 * r, 1.0881)) ** 3
    cube = np.zeros((nband, npix, npix))
    cube[:, px, py] = i0 * (freqs[:, None] / ref_freq) ** alpha * beam
    cards = [
        ("CTYPE1", "RA---SIN"), ("CUNIT1", "deg"),
        ("CRPIX1", crpix), ("CDELT1", -cell), ("CRVAL1", 0.0),
        ("CTYPE2", "DEC--SIN"), ("CUNIT2", "deg"),
        ("CRPIX2", crpix), ("CDELT2", cell), ("CRVAL2", 0.0),
        ("CTYPE3", "FREQ"), ("CUNIT3", "Hz"),
        ("CRPIX3", 1.0 + (ref_freq - freqs[0]) / (freqs[1] - freqs[0])),
        ("CDELT3", freqs[1] - freqs[0]), ("CRVAL3", ref_freq),
        ("CTYPE4", "STOKES"),
        ("BMAJ", 3 * cell), ("BMIN", 2 * cell), ("BPA", 30.0),
    ]
    model = os.path.join(path, "model.fits")
    resid = os.path.join(path, "resid.fits")
    write_fits(model, cube.reshape(1, nband, npix, npix), cards)
    del cube
    write_fits(resid, rng.normal(scale=1e-4, size=(1, nband, npix, npix)), cards)
    schema = os.path.join(path, "beam_$(corr)_$(reim).fits")
    beam_factory(schema=schema, rng=np.random.default_rng(seed))
    return model, resid, schema, (px, py, i0, alpha)


def other_examples(device, card):
    """Phase 28: the other ten examples on the card through their library
    functions, each example's own check, its launches and time. Returns
    their launches."""
    import shutil
    import tempfile

    import torch
    from africanus_tpu_torch.examples import (
        apply_gains, custom_rime_term, fit_spi, make_dirty, predict_dft,
        predict_from_fits, predict_shapelet, predict_wsclean, selfcal,
        spi_fitter_cube,
    )
    from africanus_tpu_torch.gridding.wgridder.core import grid_to_image, make_plan
    from africanus_tpu_torch.ops import cuda_beam as cb
    from africanus_tpu_torch.ops import cuda_wgrid as cw
    from africanus_tpu_torch.utils.fits import read_fits

    cpu = torch.device("cpu")
    total, lines = {}, []

    def on_card(name, fn):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        _add(total, launches)
        return out, seconds, launches

    def report(name, seconds, launches, what):
        lines.append(f"{name} {seconds:.2f} s, launches {launches or 'none'}: {what}")

    def vs_cpu(got, want):
        return rel_err(got.cpu().numpy() if isinstance(got, torch.Tensor) else got,
                       want.numpy() if isinstance(want, torch.Tensor) else want)

    # predict_dft at config 1
    inputs = predict_dft.dft_inputs(**EX_DFT)
    vis, sec, n = on_card("predict_dft", lambda: predict_dft.predict_dft(**inputs,
                                                                        device=device))
    err = vs_cpu(vis, predict_dft.predict_dft(**inputs, device=cpu))
    check(tuple(vis.shape) == (2016, EX_DFT["nchan"], 2) and n.get("dft_forward") == 1,
          f"predict_dft {tuple(vis.shape)} {n}")
    check(err <= DFT_BOUND, f"predict_dft vs CPU {err:.3e}")
    report("predict_dft", sec, n, f"{tuple(vis.shape)} vs CPU {err:.2e} ({DFT_BOUND})")

    # make_dirty at 1024² from 1M rows x 4 channels
    nx = EX_DIRTY["nx"]
    uvw, freq, cell, srcs = make_dirty.dirty_inputs(nx, EX_DIRTY["nrow"])
    vis = make_dirty.point_source_vis(uvw, freq, cell, srcs, device)
    dirty, sec, n = on_card("make_dirty", lambda: make_dirty.make_dirty(uvw, freq, vis,
                                                                        nx, cell))
    dirty = dirty.cpu().numpy()
    nvis = EX_DIRTY["nrow"] * make_dirty.NCHAN
    got = [dirty[nx // 2 + x, nx // 2 + y] / nvis for x, y, _ in srcs]
    check(all(abs(v - a) < 0.1 * a for v, (_, _, a) in zip(got, srcs)),
          f"make_dirty recovered {got}")
    check(np.unravel_index(np.argmax(dirty), dirty.shape) == (nx // 2, nx // 2),
          "make_dirty peak off centre")
    check(n.get("grid_wstack") == 1, f"make_dirty launches {n}")
    # its grid against the plain version on the same (cached) plan, and its
    # image against the one made from the plain grid
    plan = make_plan(uvw, freq, nx, nx, cell, cell, make_dirty.EPSILON, True,
                     torch.float32, device)
    g = _grid_vs_plain("make_dirty", plan, vis.reshape(-1).contiguous())
    dirty_err = rel_err(dirty, grid_to_image(plan, g.pop("oracle")).cpu().numpy())
    check(dirty_err <= WGRID_BOUND, f"make_dirty image vs the float64-sum grid's: "
          f"{dirty_err:.3e}")
    report("make_dirty", sec, n, f"{nx}² from {nvis} vis ({plan.wgrid.nplanes} planes), "
           "recovered " + "/".join(f"{v:.3f}" for v in got) + " (within 10%), peak at "
           f"centre; grid: {_grid_line(g)}; image vs the float64-sum grid's "
           f"{dirty_err:.2e} ({WGRID_BOUND})")
    del vis, plan, g

    # spi_fitter_cube with --beammodel at 8 x 4096²
    c = EX_CUBE
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cube_")
    try:
        t0 = time.perf_counter()
        model, resid, schema, (px, py, i0, alpha) = spi_cube_problem(tmp, **c)
        setup = time.perf_counter() - t0
        fit, sec, n = on_card("spi_fitter_cube", lambda: spi_fitter_cube.fit_cube(
            model, resid, os.path.join(tmp, "out-"), threshold=50.0, beammodel=schema,
            device=device))
        _, alpha_map = read_fits(os.path.join(tmp, "out-alpha.fits"))
        _, i0_map = read_fits(os.path.join(tmp, "out-I0.fits"))
        # the beam kernels against their plain versions on the operands
        # this run gives them (the primary beam evaluated again)
        hdr, _ = read_fits(model)
        l_coord, m_coord, freqs = spi_fitter_cube.parse_cube_header(hdr)[:3]
        ops = {}
        spi_fitter_cube.evaluate_primary_beam(schema, fit.maskindices, l_coord, m_coord,
                                              freqs, device, operands=ops)
        beam_errs = {}
        for name, kernel, plain in (("beam_interp", cb.beam_interp,
                                     cb.beam_interp_reference),
                                    ("beam_blend", cb.beam_blend,
                                     cb.beam_blend_reference)):
            check(name in ops, f"spi_fitter_cube: the beam route ran no {name}")
            got, want = kernel(*ops[name]), plain(*ops[name])
            beam_errs[name] = float((got - want).abs().max() / want.abs().max())
            check(beam_errs[name] <= BEAM_BOUND,
                  f"spi_fitter_cube {name} vs plain: {beam_errs[name]:.3e}")
        nsamp = ops["beam_interp"][1].shape[0]
        del ops, got, want
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    a_err = float(np.abs(alpha_map[px, py] - alpha).max())
    check(a_err < EX_ALPHA_BOUND, f"spi_fitter_cube α vs the truth {a_err:.3e}")
    check(bool((i0_map[px, py] > 0.5 * i0).all()), "spi_fitter_cube I0 below half")
    check(n.get("beam_interp") == 1 and n.get("beam_blend") == 1,
          f"spi_fitter_cube launches {n}")
    report("spi_fitter_cube", sec, n,
           f"{c['nband']} x {c['npix']}² float64, {c['ncomp']} components "
           f"({fit.maskindices.shape[0]} pixels fitted), inputs written in {setup:.1f} s, "
           "stages " + ", ".join(f"{k} {v:.2f}" for k, v in fit.stage_seconds.items())
           + f"; α at the components vs the truth {a_err:.2e} ({EX_ALPHA_BOUND}) with "
           f"the beam model divided out (chan-invariant route); at its {nsamp} samples "
           + ", ".join(f"{k} vs plain {v:.2e}" for k, v in beam_errs.items())
           + f" ({BEAM_BOUND})")
    del fit
    torch.cuda.empty_cache()

    # the rest at the JAX examples' defaults
    obs = selfcal.observation()
    run, sec, n = on_card("selfcal", lambda: selfcal.selfcal(obs, device))
    peak = np.unravel_index(int(torch.argmax(run.clean)), tuple(run.clean.shape))
    check(peak == (selfcal.NPIX // 2, selfcal.NPIX // 2) and run.iterations < 60,
          f"selfcal CLEAN peak {peak}, {run.iterations} iterations")
    check(n.get("dft_forward") == 1 and n.get("grid_wstack") == 2
          and n.get("hogbom") == 1, f"selfcal {n}")
    report("selfcal", sec, n, f"{run.iterations} GN iterations, CLEAN peak at centre")

    (vis, fixed, k), sec, n = on_card("apply_gains", lambda: apply_gains.apply_and_undo(
        **apply_gains.gain_inputs(), device=device))
    err = float((fixed - k).abs().max() / k.abs().max())
    check(err < 1e-5, f"apply_gains {err:.3e}")
    report("apply_gains", sec, n, f"corrected vs uncorrupted {err:.2e} (1e-5)")

    ds = custom_rime_term.dataset()
    vis, sec, n = on_card("custom_rime_term",
                          lambda: custom_rime_term.custom_rime(ds, device))
    err = float((vis - custom_rime_term.explicit(ds, device)).abs().max()
                / vis.abs().max())
    check(err < 1e-6, f"custom_rime_term {err:.3e}")
    report("custom_rime_term", sec, n, f"float64 vs the explicit sum {err:.2e} (1e-6)")

    from africanus_tpu_torch.examples.predict_to_ms_store import DEMO_MODEL

    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_model_"), "demo.txt")
    try:
        with open(path, "w") as fh:
            fh.write(DEMO_MODEL)
        _, sky = predict_wsclean.sky_model(path)
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    uvw, freq = predict_wsclean.observation()
    vis, sec, n = on_card("predict_wsclean", lambda: predict_wsclean.predict_wsclean(
        sky, uvw, freq, device))
    err = vs_cpu(vis, predict_wsclean.predict_wsclean(sky, uvw, freq, cpu, torch.float64))
    check(err <= EX_PLAIN_BOUND and n.get("predict_kb") == 1, f"predict_wsclean {err} {n}")
    report("predict_wsclean", sec, n, f"vs CPU float64 {err:.2e} ({EX_PLAIN_BOUND})")

    sinputs = predict_shapelet.shapelet_inputs()
    vis, sec, n = on_card("predict_shapelet", lambda: predict_shapelet.predict_shapelet(
        **sinputs, device=device))
    err = vs_cpu(vis, predict_shapelet.predict_shapelet(**sinputs, device=cpu,
                                                        dtype=torch.float64))
    check(err <= EX_SHAPELET_BOUND, f"predict_shapelet vs CPU float64 {err:.3e}")
    report("predict_shapelet", sec, n, f"vs CPU float64 {err:.2e} ({EX_SHAPELET_BOUND})")

    rng = np.random.default_rng(0)
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_fits_"), "demo.fits")
    try:
        predict_from_fits.write_demo_model(path, rng)
        flux, lm = predict_from_fits.fits_components(path)
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    uvw, freq = predict_from_fits.observation(rng)
    vis, sec, n = on_card("predict_from_fits", lambda: predict_from_fits.predict_from_fits(
        flux, lm, uvw, freq, device=device))
    err = vs_cpu(vis, predict_from_fits.predict_from_fits(flux, lm, uvw, freq, device=cpu))
    check(np.abs(vis).max() <= flux.sum() * (1 + 1e-4) and err <= DFT_BOUND
          and n.get("dft_forward") == 3, f"predict_from_fits {err:.3e} {n}")
    report("predict_from_fits", sec, n, f"|V| ≤ total flux, vs CPU {err:.2e} ({DFT_BOUND})")

    data, weights, freqs, alpha_true, _ = fit_spi.spectra()
    out, sec, n = on_card("fit_spi", lambda: fit_spi.fit_spi(data, weights, freqs, device))
    want = fit_spi.fit_spi(data, weights, freqs, cpu)
    a_err = float((out[0].cpu() - want[0]).abs().max())
    mean_err = float(np.abs(out[0].cpu().double().numpy() - alpha_true).mean())
    check(a_err <= 1e-4 and mean_err < 0.01, f"fit_spi α {a_err:.3e} {mean_err:.3e}")
    report("fit_spi", sec, n, f"α vs CPU {a_err:.2e} (1e-4), mean α error {mean_err:.4f}")

    print(f"[28/{PHASES}] the other examples on {card}: " + " | ".join(lines), flush=True)
    return total



# phase 29: the sharded paths (parallel/) on one card, as meshes of 8 shards
# of the card ([cuda:0] * 8) and the default make_mesh() (the card alone)
SHARDS = 8
SHARD_DFT = dict(nsrc=100, nant=7, ntime=96, nchan=64, seed=1)  # config 1
SHARD_BOUND = 1e-6  # sharded against unsharded (not the DFT), of max
SHARD_PREDICT_MESH = (4, 2)
SHARD_PREDICT_BOUND = 1e-10  # the (4, 2) mesh against one shard, float64
SHARD_PREDICT_KB_BOUND = 5e-6  # against predict_kb: the flagship's bar
PREDICT_KB_PLAIN_BOUND = 2e-6  # a shard's predict_kb vs plain: phase 3's compensated bar
SHARD_BEAM = 4  # channel shards of the config-3 chan-invariant leg
SHARD_GN = dict(tol=1e-10, maxiter=50)  # tests/test_parallel.py:445-447


def sharded_paths(device, card):
    """Phase 29: every sharded entry point of africanus_tpu_torch.parallel
    at full width on two meshes, 8 shards of the card and the default
    make_mesh() (the card alone), each held against the unsharded call;
    one shard of each kernel held against its plain version; reruns of
    the sums bitwise; times beside the unsharded calls'. Returns the
    sharded calls' launches."""
    import torch
    from africanus_tpu_torch import parallel as par
    from africanus_tpu_torch.averaging import bda, time_and_channel
    from africanus_tpu_torch.calibration.phase_only import gauss_newton
    from africanus_tpu_torch.calibration.selfcal import (
        grid_lm, make_data, selfcal_inputs,
    )
    from africanus_tpu_torch.calibration.utils import residual_vis
    from africanus_tpu_torch.constants import ARCSEC2RAD
    from africanus_tpu_torch.dft import im_to_vis, vis_to_im
    from africanus_tpu_torch.dft.kernels import dft_plan
    from africanus_tpu_torch.gridding import perleypolyhedron as pp
    from africanus_tpu_torch.gridding.perleypolyhedron.kernels import (
        kbsinc, pack_kernel,
    )
    from africanus_tpu_torch.gridding.wgridder.core import (
        degrid, grid_adjoint, make_plan,
    )
    from africanus_tpu_torch.gridding.wgridder.imaging import imaging_inputs
    from africanus_tpu_torch.ops import cuda_beam as cb
    from africanus_tpu_torch.ops import cuda_dft as cd
    from africanus_tpu_torch.ops import cuda_gridtab as gt
    from africanus_tpu_torch.ops import cuda_wgrid as cw
    from africanus_tpu_torch.ops.cuda_predict import predict_kb, predict_kb_reference
    from africanus_tpu_torch.rime.beam_chain import beam_inputs
    from africanus_tpu_torch.rime.beam_chain import from_numpy as beam_from_numpy
    from africanus_tpu_torch.rime.flagship import from_numpy as flagship_from_numpy
    from africanus_tpu_torch.rime.phase import phase_dot_cycles
    from africanus_tpu_torch.testing.averaging import meerkat_inputs

    mesh8 = par.make_mesh((SHARDS,), ("row",), devices=[device] * SHARDS)
    mesh1 = par.make_mesh()
    check(mesh1.size == 1 and mesh1.first == device, f"default mesh {mesh1}")
    meshes = {"8 shards": mesh8, "the card": mesh1}
    total, lines, times = {}, [], []

    def counted(fn):
        """(fn(), its launches): the counts zeroed just before, read just
        after; added to the phase's total."""
        torch.cuda.synchronize()
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        n = read_counts()
        _add(total, n)
        return out, n

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            a if isinstance(a, (tuple, list)) else (a,),
            b if isinstance(b, (tuple, list)) else (b,)))

    def timed(name, sharded, unsharded, reps=5, on=None):
        """CUDA-event medians of the sharded call on each mesh of ``on``
        (default: 8 shards and the card) and of the unsharded call."""
        ms = {k: cuda_median_ms(lambda m=m: sharded(m), reps=reps, warmup=1)[0]
              for k, m in (on or meshes).items()}
        ms["unsharded"] = cuda_median_ms(unsharded, reps=reps, warmup=1)[0]
        times.append(f"{name} " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

    def vs_plain(name, fn, plain, ops, bound):
        got, want = fn(*ops), plain(*ops)
        err = rel(got, want)
        check(err <= bound, f"{name} on a shard vs plain: {err:.3e}")
        return err

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x), device=device, dtype=dtype)

    plain_errs = {}

    # (a) the DFTs at config 1 and at the config-5 selfcal shape
    rng = np.random.default_rng(SHARD_DFT["seed"])
    nrow = SHARD_DFT["nant"] * (SHARD_DFT["nant"] - 1) // 2 * SHARD_DFT["ntime"]
    f32 = np.float32
    c1 = dict(uvw=rng.uniform(-200.0, 200.0, (nrow, 3)).astype(f32),
              lm=rng.uniform(-0.02, 0.02, (SHARD_DFT["nsrc"], 2)).astype(f32),
              freq=np.linspace(1.4e9, 1.5e9, SHARD_DFT["nchan"]).astype(f32),
              image=rng.uniform(0.1, 1.0, (SHARD_DFT["nsrc"], SHARD_DFT["nchan"],
                                           1)).astype(f32))
    sc = selfcal_inputs(seed=SELFCAL_SEED, **SELFCAL)
    sc.update(make_data(sc, device))
    pad = par.pad_rows(sc["uvw"].shape[0], SHARDS)
    s_uvw = np.concatenate([sc["uvw"], np.zeros((pad, 3), f32)])
    s_data = sc["data"][0] + 1j * sc["data"][1]
    s_vis = np.concatenate([s_data, np.zeros((pad,) + s_data.shape[1:], s_data.dtype)])
    dft_cells = [
        ("config 1", c1["image"], c1["uvw"], c1["lm"], c1["freq"], nrow),
        (f"config 5 ({sc['uvw'].shape[0]} rows padded by {pad})", sc["image"],
         s_uvw, sc["lm"], sc["frequency"], sc["uvw"].shape[0]),
    ]
    for cell, image, uvw, lm, freq, n in dft_cells:
        img_d, lm_d, uvw_d = t(image), t(lm), t(uvw)
        want = im_to_vis(img_d, uvw_d[:n], lm_d, freq)
        got, launched = counted(lambda: par.sharded_im_to_vis(mesh8, image, uvw, lm_d,
                                                               freq))
        check(launched == {"dft_forward": SHARDS}, f"sharded im_to_vis {cell} {launched}")
        fwd_err = rel(got[:n], want)
        check(fwd_err <= SHARD_BOUND, f"sharded im_to_vis {cell}: {fwd_err:.3e}")
        one = par.sharded_im_to_vis(mesh1, image, uvw, lm_d, freq)
        one_err = rel(one[:n], want)
        check(one_err <= SHARD_BOUND, f"one-shard im_to_vis {cell}: {one_err:.3e}")
        # the adjoint of the data (config 5) or of the forward's output, on
        # the pixels of a 64² image (config 5) or the sources (config 1)
        if cell.startswith("config 5"):
            lm_a, vis = t(grid_lm(SELFCAL_NPX)).to(torch.float32), t(s_vis)
        else:
            lm_a = lm_d
            vis = torch.cat([want, torch.zeros((uvw.shape[0] - n,) + want.shape[1:],
                                               dtype=want.dtype, device=device)])
        flags = torch.zeros(vis.shape, dtype=torch.bool, device=device)
        want_im = vis_to_im(vis[:n], uvw_d[:n], lm_a, freq, flags[:n])
        got_im, launched = counted(lambda: par.sharded_vis_to_im(mesh8, vis, uvw, lm_a,
                                                                 freq, flags))
        check(launched == {"dft_adjoint": SHARDS}, f"sharded vis_to_im {cell} {launched}")
        adj_err = rel(got_im, want_im)
        check(adj_err <= DFT_BOUND, f"sharded vis_to_im {cell}: {adj_err:.3e}")
        again = par.sharded_vis_to_im(mesh8, vis, uvw, lm_a, freq, flags)
        check(torch.equal(again, got_im), f"sharded vis_to_im {cell}: reruns differ")
        adj_one = rel(par.sharded_vis_to_im(mesh1, vis, uvw, lm_a, freq, flags), want_im)
        check(adj_one <= DFT_BOUND, f"one-shard vis_to_im {cell}: {adj_one:.3e}")
        # one shard's launches against the plain versions, on its plans
        rows = slice(0, uvw.shape[0] // SHARDS)
        fplan = dft_plan(uvw_d, lm_d, freq, image.shape[2])
        aplan = dft_plan(uvw_d, lm_a, freq, vis.shape[2], adjoint=True)
        plain_errs[f"dft_forward {cell}"] = vs_plain(
            "dft_forward", cd.dft_forward, cd.dft_forward_reference,
            (fplan, uvw_d[rows].contiguous(), img_d), DFT_BOUND)
        plain_errs[f"dft_adjoint {cell}"] = vs_plain(
            "dft_adjoint", cd.dft_adjoint, cd.dft_adjoint_reference,
            (aplan, uvw_d[rows].contiguous(), vis[rows].contiguous()), DFT_BOUND)
        lines.append(f"DFTs at {cell}: im_to_vis 8 shards {fwd_err:.2e}, the card "
                     f"{one_err:.2e} ({SHARD_BOUND}); vis_to_im ({lm_a.shape[0]} "
                     f"directions) 8 shards {adj_err:.2e}, the card {adj_one:.2e} "
                     f"({DFT_BOUND}), reruns bitwise")
        timed(f"im_to_vis {cell}",
              lambda m: par.sharded_im_to_vis(m, image, uvw, lm_d, freq),
              lambda: im_to_vis(img_d, uvw_d, lm_d, freq))
        timed(f"vis_to_im {cell}",
              lambda m: par.sharded_vis_to_im(m, vis, uvw, lm_a, freq, flags),
              lambda: vis_to_im(vis, uvw_d, lm_a, freq, flags))
    print(f"[29/{PHASES}] sharded paths: " + "; ".join(lines), flush=True)
    lines = []

    # (b) the flagship chunk: sharded_rime_predict in float64 on a (4, 2)
    # row x chan mesh and on one shard, against predict_kb; and
    # sharded_im_to_vis at 4096 channels (predict_kb's route)
    chunk = slice_chunks()[0]
    model, inputs = flagship_from_numpy(chunk, device)
    ops = model.kernel_operands(inputs[3], inputs[4])
    b = ops[-1]
    lm64 = chunk[3].astype(np.float64)
    uvw64, freq64 = chunk[4].astype(np.float64), chunk[5].astype(np.float64)
    gs64 = chunk[9].astype(np.float64)
    b64 = b.to(torch.complex128)
    mesh42 = par.make_mesh(SHARD_PREDICT_MESH, devices=[device] * SHARDS)

    def rime(mesh):
        return par.sharded_rime_predict(mesh, lm64, uvw64, freq64, b64, gs64)

    (got, launched), peak42 = _peak_of(lambda: counted(lambda: rime(mesh42)))
    check(launched == {}, f"sharded_rime_predict launched {launched}")
    check(tuple(got.shape) == (uvw64.shape[0], freq64.size, NCORR)
          and got.dtype == torch.complex128, f"sharded_rime_predict {got.shape}")
    one, peak1 = _peak_of(lambda: rime(mesh1))
    one_err = rel(got, one)
    check(one_err <= SHARD_PREDICT_BOUND, f"(4, 2) vs one shard: {one_err:.3e}")
    check(torch.equal(rime(mesh42), got), "sharded_rime_predict reruns differ")
    kb = predict_kb(*ops)
    kb_err = rel(kb.to(torch.complex128), got)
    check(kb_err <= SHARD_PREDICT_KB_BOUND, f"sharded_rime_predict vs predict_kb "
          f"{kb_err:.3e}")
    del one
    lm32, uvw32, freq32 = t(chunk[3]), t(chunk[4]), chunk[5]
    want = im_to_vis(b, uvw32, lm32, freq32)
    got_kb, launched = counted(lambda: par.sharded_im_to_vis(mesh8, b, uvw32, lm32, freq32))
    check(launched == {"predict_kb": SHARDS}, f"sharded im_to_vis ({NCHAN} chan) {launched}")
    kb_shard_err = rel(got_kb, want)
    check(kb_shard_err <= SHARD_BOUND, f"sharded im_to_vis ({NCHAN} chan) {kb_shard_err:.3e}")
    del got_kb, want
    # shard 0's predict_kb launch against its plain version, on the
    # operands im_to_vis gives it (dft/kernels.py: the predict_kb route)
    rows = slice(0, uvw32.shape[0] // SHARDS)
    freq_d = torch.as_tensor(freq32, device=device, dtype=torch.float32)
    kb_ops = (phase_dot_cycles(lm32.to(torch.float32).contiguous(),
                               uvw32[rows].to(torch.float32).contiguous()),
              None, None, freq_d, torch.zeros_like(freq_d), b)
    plain_errs["predict_kb"] = vs_plain("predict_kb", predict_kb, predict_kb_reference,
                                        kb_ops, PREDICT_KB_PLAIN_BOUND)
    del kb_ops
    lines.append(f"sharded_rime_predict at the flagship chunk ({uvw64.shape[0]} rows x "
                 f"{freq64.size} chan x {NCORR} corr, {lm64.shape[0]} gaussian src, "
                 f"float64) on a {SHARD_PREDICT_MESH} mesh vs one shard {one_err:.2e} "
                 f"({SHARD_PREDICT_BOUND}), vs predict_kb {kb_err:.2e} "
                 f"({SHARD_PREDICT_KB_BOUND}), rerun bitwise, peak {peak42 / 2**30:.2f} "
                 f"GiB ((4, 2)) / {peak1 / 2**30:.2f} GiB (one shard); im_to_vis there "
                 f"(predict_kb x {SHARDS}) vs unsharded {kb_shard_err:.2e}")
    timed("sharded_rime_predict (unsharded: predict_kb)", rime,
          lambda: predict_kb(*ops), reps=3,
          on={f"{SHARD_PREDICT_MESH} mesh": mesh42, "the card": mesh1})
    timed(f"im_to_vis at {NCHAN} chan", lambda m: par.sharded_im_to_vis(
        m, b, uvw32, lm32, freq32), lambda: im_to_vis(b, uvw32, lm32, freq32))
    del got, kb, b64, ops
    torch.cuda.empty_cache()

    # (c) config-4 imaging: dirty, PSF, degrid, residual on one geometry
    args = imaging_inputs(**IMAGING)
    nx, cell, uvw, freq = args["nx"], args["cell"], args["uvw"], args["freq"]
    vis = t(args["vis"])
    image = t(args["image"], torch.float32)
    eps = IMAGING_EPS
    plan = make_plan(uvw, freq, nx, nx, cell, cell, eps, True, device=device)
    ones = torch.ones(vis.shape, dtype=torch.complex64, device=device)
    want = {"dirty": grid_adjoint(uvw, freq, vis, None, nx, nx, cell, cell, eps, True,
                                  plan=plan),
            "psf": grid_adjoint(uvw, freq, ones, None, nx, nx, cell, cell, eps, True,
                                plan=plan),
            "degrid": degrid(uvw, freq, image, None, cell, cell, eps, True, plan=plan)}
    want["residual"] = grid_adjoint(uvw, freq, vis - want["degrid"], None, nx, nx,
                                    cell, cell, eps, True, plan=plan)
    calls = {
        "dirty": lambda m: par.sharded_dirty(m, uvw, freq, vis, nx, nx, cell, eps, True),
        "psf": lambda m: par.sharded_psf(m, uvw, freq, nx, nx, cell, eps, True),
        "degrid": lambda m: par.sharded_degrid(m, uvw, freq, image, cell=cell,
                                               epsilon=eps, do_wstacking=True),
        "residual": lambda m: par.sharded_residual(m, uvw, freq, vis, image, cell, eps,
                                                   True),
    }
    expect = {"dirty": {"grid_wstack": SHARDS}, "psf": {"grid_wstack": SHARDS},
              "degrid": {"degrid_wstack": SHARDS},
              "residual": {"grid_wstack": SHARDS, "degrid_wstack": SHARDS}}
    t0 = time.perf_counter()
    plans = par.imaging.shard_plans(mesh8, uvw, freq, nx, nx, cell, eps, True,
                                    torch.float32)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    check(all(p.wgrid.nplanes == plan.wgrid.nplanes for p in plans),
          "shard plans: w-planes differ from the full uvw's")
    errs = {}
    for name, fn in calls.items():
        got, launched = counted(lambda: fn(mesh8))
        check(launched == expect[name], f"sharded {name} launches {launched}")
        check(same(fn(mesh8), got), f"sharded {name}: reruns differ")
        errs[name] = rel(got, want[name])
        check(errs[name] <= WGRID_BOUND, f"sharded {name} vs unsharded: {errs[name]:.3e}")
        one = rel(fn(mesh1), want[name])
        check(one <= WGRID_BOUND, f"one-shard {name}: {one:.3e}")
        errs[name + " (card)"] = one
    rows = slice(0, uvw.shape[0] // SHARDS)
    flat = vis[rows].reshape(-1).contiguous()
    plain_errs["grid_wstack"] = vs_plain("grid_wstack", cw.grid_wstack,
                                         cw.grid_wstack_reference,
                                         (plans[0].wgrid, flat), WGRID_BOUND)
    grid0 = cw.grid_wstack(plans[0].wgrid, flat)
    plain_errs["degrid_wstack"] = vs_plain("degrid_wstack", cw.degrid_wstack,
                                           cw.degrid_wstack_reference,
                                           (plans[0].wgrid, grid0), WGRID_BOUND)
    del grid0
    lines.append(f"config-4 imaging ({uvw.shape[0]} rows x {freq.size} chan, {nx}², "
                 f"{plan.wgrid.nplanes} planes; {SHARDS} shard plans on the full uvw's "
                 f"geometry in {plan_s:.2f} s) vs unsharded: " + ", ".join(
                     f"{k} {v:.2e}" for k, v in errs.items())
                 + f" ({WGRID_BOUND}); reruns bitwise")
    for name, fn in calls.items():
        timed(f"{name} (config 4)", fn, {
            "dirty": lambda: grid_adjoint(uvw, freq, vis, None, nx, nx, cell, cell, eps,
                                          True, plan=plan),
            "psf": lambda: grid_adjoint(uvw, freq, ones, None, nx, nx, cell, cell, eps,
                                        True, plan=plan),
            "degrid": lambda: degrid(uvw, freq, image, None, cell, cell, eps, True,
                                     plan=plan),
            "residual": lambda: grid_adjoint(
                uvw, freq, vis - degrid(uvw, freq, image, None, cell, cell, eps, True,
                                        plan=plan), None, nx, nx, cell, cell, eps,
                True, plan=plan)}[name])
    del want, plans, vis, ones

    # (d) the PP facet cell: the sharded gridder and degridder
    args = imaging_inputs(**FACET)
    npix, cell_as = args["nx"], args["cell"] / ARCSEC2RAD
    puvw, pfreq = args["uvw"].astype(np.float64), args["freq"].astype(np.float64)
    wl = 2.99792458e8 / pfreq
    chanmap = np.repeat(np.arange(FACET_BANDS), pfreq.size // FACET_BANDS)
    phase_centre = (0.0, FACET_DEC)
    image_centre = (0.0, FACET_DEC + np.deg2rad(FACET_OFFSET_DEG))
    w, os_ = 7, 63
    kern = pack_kernel(kbsinc(w, oversample=os_), w, os_)
    prng = np.random.default_rng(SEED)
    pshape = (puvw.shape[0], pfreq.size, 2)
    pvis = t((prng.normal(size=pshape) + 1j * prng.normal(size=pshape))
             .astype(np.complex64))
    duvw = t(puvw)
    gpol = ("rotate", "phase_rotate", "I_FROM_XXYY", "conv_1d_axisymmetric_packed_scatter")
    dpol = ("rotate", "phase_rotate", "XXYY_FROM_I", "conv_1d_axisymmetric_packed_gather")
    gargs = (wl, chanmap, npix, cell_as, image_centre, phase_centre, kern, w, os_) + gpol
    dargs = (wl, chanmap, cell_as, image_centre, phase_centre, kern, w, os_) + dpol
    common = (npix, cell_as, image_centre, phase_centre)
    gplan = pp.pp_tile_plan(puvw, wl, chanmap, *common, w, os_, "rotate", "grid",
                            torch.float32, device)
    dplan = pp.pp_tile_plan(puvw, wl, chanmap, *common, w, os_, "rotate", "degrid",
                            torch.float32, device)
    want_g = pp.gridder(duvw, pvis, *gargs, tile_plan=gplan)
    want_v = pp.degridder(duvw, want_g, *dargs, tile_plan=dplan)
    pp_calls = {"gridder": (lambda m: par.sharded_pp_gridder(m, duvw, pvis, *gargs),
                            want_g, {"grid_table": SHARDS}),
                "degridder": (lambda m: par.sharded_pp_degridder(m, duvw, want_g, *dargs),
                              want_v, {"degrid_table": SHARDS})}
    pp_errs = {}
    for name, (fn, want_x, n_expect) in pp_calls.items():
        got, launched = counted(lambda: fn(mesh8))
        check(launched == n_expect, f"sharded PP {name} launches {launched}")
        check(torch.equal(fn(mesh8), got), f"sharded PP {name}: reruns differ")
        pp_errs[name] = rel(got, want_x)
        check(pp_errs[name] <= GRIDDER_BOUND, f"sharded PP {name}: {pp_errs[name]:.3e}")
        pp_errs[name + " (card)"] = rel(fn(mesh1), want_x)
        check(pp_errs[name + " (card)"] <= GRIDDER_BOUND, f"one-shard PP {name}")
    sg = par.imaging._pp_shard_plans(mesh8, duvw, wl, chanmap, npix, cell_as,
                                     image_centre, phase_centre, w, os_, "rotate",
                                     gpol[-1], "grid", torch.float32)[0]
    sd = par.imaging._pp_shard_plans(mesh8, duvw, wl, chanmap, npix, cell_as,
                                     image_centre, phase_centre, w, os_, "rotate",
                                     dpol[-1], "degrid", torch.float32)[0]
    table = t(pp.kernels.unpack_kernel(kern, w, os_), torch.float32)
    n = sg.ir0.shape[0]
    stokes = t((prng.normal(size=n) + 1j * prng.normal(size=n)).astype(np.complex64))
    plain_errs["grid_table"] = vs_plain("grid_table", gt.grid_table,
                                        gt.grid_table_reference, (sg, table, stokes),
                                        GRIDDER_BOUND)
    plain_errs["degrid_table"] = vs_plain("degrid_table", gt.degrid_table,
                                          gt.degrid_table_reference,
                                          (sd, table, want_g.contiguous()), GRIDDER_BOUND)
    lines.append(f"PP facet ({puvw.shape[0]} rows x {pfreq.size} chan, {npix}² x "
                 f"{FACET_BANDS} bands) vs unsharded: " + ", ".join(
                     f"{k} {v:.2e}" for k, v in pp_errs.items())
                 + f" ({GRIDDER_BOUND}); reruns bitwise")
    timed("PP gridder", pp_calls["gridder"][0],
          lambda: pp.gridder(duvw, pvis, *gargs, tile_plan=gplan))
    timed("PP degridder", pp_calls["degridder"][0],
          lambda: pp.degridder(duvw, want_g, *dargs, tile_plan=dplan))
    del want_g, want_v, pvis, duvw
    print(f"[29/{PHASES}] sharded paths: " + "; ".join(lines), flush=True)
    lines = []

    # (e) config-5 calibration: 2 time bins over 2 shards, float64
    mesh2 = par.make_mesh((2,), ("row",), devices=[device] * 2)
    meta = (sc["time_bin_indices"], sc["time_bin_counts"], sc["antenna1"],
            sc["antenna2"])
    gains = t(np.exp(1j * sc["true_phase"].astype(np.float64)))
    data = t(s_data.astype(np.complex128))
    model_c = t((sc["model"][0] + 1j * sc["model"][1]).astype(np.complex128))
    flag, weight = t(sc["flag"]), t(sc["weight"].astype(np.float64))
    jones0 = torch.ones(gains.shape, dtype=torch.complex128, device=device)
    want_r = residual_vis(*meta, gains, data, flag, model_c)
    got_r, _ = counted(lambda: par.sharded_residual_vis(mesh2, *meta, gains, data,
                                                        flag, model_c))
    r_err = float(((got_r - want_r).abs() - 1e-12 * want_r.abs()).max())
    check(r_err <= 1e-12, f"sharded residual_vis: {r_err:.3e} over rtol 1e-12")
    gw = gauss_newton(*meta, jones0, data, flag, model_c, weight, **SHARD_GN)
    gs_, _ = counted(lambda: par.sharded_gauss_newton(mesh2, *meta, jones0, data,
                                                      flag, model_c, weight,
                                                      **SHARD_GN))
    a1u, a2u = np.triu_indices(SELFCAL["nant"], 1)

    def prods(g):
        g = g.cpu()
        return g[:, a1u] * g[:, a2u].conj()

    pw, pg = prods(gw[0]), prods(gs_[0])
    gn_err = float(((pg - pw).abs() - 1e-8 * pw.abs()).max())
    check(gn_err <= 1e-8, f"sharded gauss_newton products: {gn_err:.3e} over 1e-8")
    lines.append(f"config-5 calibration on 2 shards of {sc['time_bin_indices'].size} "
                 f"bins ({sc['uvw'].shape[0]} rows, float64): residual within rtol "
                 f"1e-12 (excess {r_err:.1e}), gain products within 1e-8 (excess "
                 f"{gn_err:.1e}), iterations {gs_[3]} (unsharded {int(gw[3])})")
    cal_meshes = {"2 shards": mesh2, "the card": mesh1}
    timed("residual_vis", lambda m: par.sharded_residual_vis(
        m, *meta, gains, data, flag, model_c),
        lambda: residual_vis(*meta, gains, data, flag, model_c), on=cal_meshes)
    timed("gauss_newton", lambda m: par.sharded_gauss_newton(
        m, *meta, jones0, data, flag, model_c, weight, **SHARD_GN),
        lambda: gauss_newton(*meta, jones0, data, flag, model_c, weight, **SHARD_GN),
        reps=3, on=cal_meshes)
    del gains, data, model_c, flag, weight, got_r, want_r

    # (f) MeerKAT-64 1K averaging: 8 shards of 2 dumps
    om = meerkat_inputs(**MEERKAT)
    d = {k: t(om[k]) for k in AVG_DATA if k in om}
    rp = om["time"].size // SHARDS
    kb = dict(visibilities=d["visibilities"], flag=d["flag"],
              weight_spectrum=d["weight_spectrum"])
    geo = (om["time"], om["interval"], om["antenna1"], om["antenna2"])

    def avg_bda(m):
        return par.sharded_bda(m, *geo, om["uvw"], om["chan_freq"], om["chan_width"],
                               **kb, max_fov=om["max_fov"],
                               decorrelation=om["decorrelation"])

    tc_kw = dict(flag_row=om["flag_row"], uvw=om["uvw"], chan_freq=om["chan_freq"],
                 chan_width=om["chan_width"], **d, **AVG_TC)

    def avg_tc(m):
        return par.sharded_time_and_channel(m, *geo, **tc_kw)

    avg_lines = []
    for name, fn, fields in (("bda", avg_bda, ("antenna1", "antenna2", "uvw",
                                               "visibilities", "flag",
                                               "weight_spectrum")),
                             ("time_and_channel", avg_tc,
                              ("antenna1", "antenna2", "uvw", "visibilities", "flag",
                               "weight_spectrum", "sigma_spectrum"))):
        (out, launched), peak = _peak_of(lambda: counted(lambda: fn(mesh8)))
        check(launched == {}, f"sharded {name} launched {launched}")
        again = fn(mesh8)
        for k in fields:
            check(torch.equal(getattr(out, k), getattr(again, k)),
                  f"sharded {name} {k}: reruns differ")
        del again
        for s in range(SHARDS):
            sl = slice(s * rp, (s + 1) * rp)
            if name == "bda":
                ref = bda(*(x[sl] for x in geo), uvw=om["uvw"][sl],
                          chan_freq=om["chan_freq"], chan_width=om["chan_width"],
                          **{k: v[sl] for k, v in kb.items()}, max_fov=om["max_fov"],
                          decorrelation=om["decorrelation"])
            else:
                ref = time_and_channel(*(x[sl] for x in geo), flag_row=om["flag_row"][sl],
                                       uvw=om["uvw"][sl],
                                       **{k: v[sl] for k, v in d.items()}, **AVG_TC)
            n = int(out.nout[s])
            check(n == ref.time.shape[0], f"sharded {name} shard {s}: {n} outputs")
            for k in fields:
                x = getattr(out, k)
                check(torch.equal(x[s, :n], getattr(ref, k)),
                      f"sharded {name} shard {s} {k} differs from its call")
                pad_ok = bool(x[s, n:].all()) if k == "flag" else not bool(
                    x[s, n:].abs().sum() if x.is_floating_point() or x.is_complex()
                    else x[s, n:].any())
                check(pad_ok, f"sharded {name} shard {s} {k}: padding not inert")
            del ref
        avg_lines.append(f"{name} nout {int(out.nout.min())}-{int(out.nout.max())} a "
                         f"shard, peak {peak / 2**30:.2f} GiB above the inputs "
                         f"({nbytes(*d.values()) / 2**30:.2f} GiB)")
        del out
    lines.append(f"MeerKAT-64 1K averaging on {SHARDS} shards of {rp} rows (2 dumps): "
                 "each shard bitwise its averager's call, padding inert, reruns "
                 "bitwise; " + "; ".join(avg_lines))
    timed("bda (MeerKAT-64 1K)", avg_bda, lambda: bda(
        *geo, uvw=om["uvw"], chan_freq=om["chan_freq"], chan_width=om["chan_width"],
        **kb, max_fov=om["max_fov"], decorrelation=om["decorrelation"]), reps=3)
    timed("time_and_channel (MeerKAT-64 1K)", avg_tc, lambda: time_and_channel(
        *geo, **tc_kw), reps=3)
    del d, kb, tc_kw
    torch.cuda.empty_cache()

    # (g) the config-3 chan-invariant E·F leg on channel shards
    bargs = beam_inputs(**BEAM)
    chain, pa = beam_from_numpy(bargs, device)
    want = chain(pa)
    c = BEAM["nchan"] // SHARD_BEAM

    def leg(s):
        cs = slice(s * c, (s + 1) * c)
        return beam_from_numpy(dict(bargs, freq=bargs["freq"][cs],
                                    pe=bargs["pe"][:, :, cs],
                                    asc=bargs["asc"][:, cs]), device)

    legs = [leg(s) for s in range(SHARD_BEAM)]
    got, launched = counted(lambda: torch.cat([m(p) for m, p in legs], dim=3))
    check(launched == {"beam_interp": SHARD_BEAM, "beam_blend": SHARD_BEAM},
          f"chan-split beam launches {launched}")
    excess = float(((got - want).abs() - 1e-5 * want.abs()).max())
    check(excess <= 1e-6, f"chan-split beam vs unsharded: {excess:.3e} over "
          "rtol 1e-5 + atol 1e-6")
    _, bops = legs[0][0].kernel_operands(legs[0][1])
    plain_errs["beam_interp"] = vs_plain("beam_interp", cb.beam_interp,
                                         cb.beam_interp_reference,
                                         bops["beam_interp"], BEAM_BOUND)
    plain_errs["beam_blend"] = vs_plain("beam_blend", cb.beam_blend,
                                        cb.beam_blend_reference, bops["beam_blend"],
                                        BEAM_BOUND)
    timed("config-3 chan-invariant leg", lambda m: torch.cat(
        [leg_m(p) for leg_m, p in legs], dim=3), lambda: chain(pa),
        on={f"{SHARD_BEAM} channel shards": None})
    lines.append(f"config-3 chan-invariant E·F on {SHARD_BEAM} channel shards of {c}: "
                 f"within rtol 1e-5 + atol 1e-6 of the unsharded leg (excess "
                 f"{excess:.1e})")
    del got, want, legs

    print(f"[29/{PHASES}] sharded paths: " + "; ".join(lines), flush=True)
    print(f"[29/{PHASES}] one shard's kernels vs plain (relative to max): " + ", ".join(
        f"{k} {v:.2e}" for k, v in plain_errs.items()) + f"; launches of the sharded "
          f"calls {total}", flush=True)
    print(f"[29/{PHASES}] sharded times on {card}, CUDA-event medians in ms (8 shards "
          "of the card, the card as a one-device mesh, the unsharded call; on one "
          "card the shards run one after another: the cost of sharding, no "
          "speed-up): " + "; ".join(times), flush=True)
    return total

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "main path runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from africanus_tpu_torch import native
    from africanus_tpu_torch.ops import _build

    # full-f32 references: no TF32 in any matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[1/{PHASES}] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    print(smi, flush=True)

    # 2. build, one nvcc per source and g++ for the averaging mappers,
    # started together
    def build_native():
        t0 = time.perf_counter()
        check(native.available(), f"the native mappers did not build: "
              f"{native.load_error()}")
        return native.library_path(), time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        mappers = pool.submit(build_native)
        builds = _build.build_all()
        lib, seconds = mappers.result()
    print(f"[2/{PHASES}] built {os.path.relpath(lib)} (g++) in {seconds:.1f} s",
          flush=True)
    for lib, seconds, log in builds.values():
        ptxas = "; ".join(ln.split("ptxas info    : ")[-1]
                          for ln in log.splitlines() if "Used" in ln)
        print(f"[2/{PHASES}] built {os.path.relpath(lib)} in {seconds:.1f} s "
              f"(ptxas: {ptxas})", flush=True)

    # 3-4. kernels against their plain versions
    phase_kernel_checks(device)
    dft_kernel_checks(device)

    # 5-9. the first two paths
    kernels = [flagship(device, card)] + selfcal(device, card)

    # 10-12. the wgrid kernels against their plain versions, then imaging
    wgrid_kernel_checks(device)
    kernels += imaging(device, card)

    # 13-15. the beam kernels against their plain versions, then config 3
    beam_kernel_checks(device)
    kernels += beam_chain(device, card)

    # 16-18. the gridder kernels against their plain versions, then the
    # nifty and Perley-polyhedron gridders
    gridder_kernel_checks(device)
    kernels += gridders(device, card)

    # 19-21. the averagers, the fused RIME (its E terms launch beam_interp
    # and beam_blend, counted in the kernels line), their times
    avg = averaging(device, card)
    fz = fused(device, card)
    for entry in kernels:
        entry["launches"] += fz["launches"].get(entry["name"], 0)
    kernels.extend(fz["kernels"])
    slice_times(card, avg, fz)

    # 22-25. the WSClean store path (predict_kb once a chunk, counted in
    # the kernels line), then the Zernike DDE, shapelets and the SPI fit
    store = store_path(device, card)
    for entry in kernels:
        entry["launches"] += store.get(entry["name"], 0)
    sky_tail(device, card)

    # 26-28. the application layer: GP gains, the two store pipelines and
    # the other ten examples, each path's launches counted in the kernels
    # line
    for path in (gp_gains, store_examples, other_examples):
        launched = path(device, card)
        for entry in kernels:
            entry["launches"] += launched.get(entry["name"], 0)

    # 29. the sharded paths: every parallel/ entry point on 8 shards of the
    # card and on the card alone, their launches counted in the kernels line
    launched = sharded_paths(device, card)
    for entry in kernels:
        entry["launches"] += launched.get(entry["name"], 0)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
