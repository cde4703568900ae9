#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (africanus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's two paths — the flagship RIME predict at a MeerKAT-64
full-band size, and one config-5 selfcal step at SKA-mid width — and
checks them, in nine phases that each print one line:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles csrc/predict_kb.cu and csrc/dft.cu with nvcc into
   build/ (first use), both at once;
3. predict kernel vs plain: predict_kb against its plain PyTorch version
   on the card (four modes × corr 1/2/4 at a ragged shape), and against
   a float64 oracle at 1e4 rad phases;
4. DFT kernels vs plain: dft_forward and dft_adjoint against their plain
   versions on the card (three phase modes × corr 1/2/4 × both
   conventions × real and complex sky, ragged shapes), two launches
   bitwise equal, and im_to_vis's ≥ 128-channel route through
   predict_kb against the CPU;
5. the flagship: FlagshipPredict over 3 row chunks of 4 time steps
   (64 antennas, 2016 baselines, 8064 rows, 4096 channels 0.856-1.712
   GHz, 4 correlations, 100 gaussian sources), counting the predict
   kernel's launches and checking windows of every chunk against a
   float64 oracle;
6. flagship times: CUDA-event medians of the kernel and of the whole
   forward at that shape, and one run of the plain version;
7. the selfcal step (bench.py config 5): SelfcalStep at 197 antennas
   (19306 baselines), 2 times (38612 rows), 16 channels, 2
   correlations, 20 sources, 10 Gauss-Newton iterations, a 64² residual
   image, counting the DFT kernels' launches;
8. selfcal checks: a 40-iteration solve against the true gains, and
   vis_to_im (64 pixels) and im_to_vis (256 rows) of the slice against
   float64 oracles;
9. selfcal times: CUDA-event medians of each DFT kernel at the step's
   shapes (with the step's plans, launches captured into a CUDA graph
   and replayed, so that no host work is timed), of vis_to_im and
   im_to_vis as the step calls them, of the solve, of CLEAN and of the
   whole step (and the step's host-clock median: it is host-bound), one
   run of each plain version, and the step's rate in Mvis-iter/s.

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

SEED = 2026
NSRC, NTIME, NANT, NCHAN, NCORR = 100, 4, 64, 4096, 4
NCHUNK = 3
JAX_CONFIG2_ERR = 2.30e-6  # the JAX package's f32 accuracy at config 2 (BENCH_r05.json)

# config 5 (bench.py:1092-1143): SKA-mid width, one step
SELFCAL = dict(nant=197, ntime=2, nchan=16, nsrc=20, ncorr=2)
SELFCAL_SEED, SELFCAL_NPX, SELFCAL_GN_ITERS = 5, 64, 10
DFT_BOUND = 3e-6  # tests/test_dft.py:322,363, relative to max|out|
BURST = 10  # launches of a DFT kernel per timed CUDA-graph replay
PHASES = 9


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


def kernel_problem(rng, S, R, F, C, compensated, env, device):
    """Random predict_kb operands on ``device``, made with numpy (also used
    by tests/test_torch_cuda.py)."""
    import torch
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    def t(x):
        return torch.as_tensor(x, device=device)

    if compensated:
        lm = rng.uniform(-0.02, 0.02, (S, 2)).astype(np.float32)
        uvw = rng.uniform(-8000, 8000, (R, 3)).astype(np.float32)
        dot = phase_dot_cycles(t(lm), t(uvw))
    else:
        dot = t((rng.uniform(-100, 100, (S, R)) * 1e-7).astype(np.float32))
    u1 = t(rng.uniform(-100, 100, (S, R)).astype(np.float32)) if env else None
    v1 = t(rng.uniform(-100, 100, (S, R)).astype(np.float32)) if env else None
    freq = np.linspace(0.856e9, 1.712e9, F).astype(np.float32)
    b = (rng.normal(size=(S, F, C)) + 1j * rng.normal(size=(S, F, C))
         ).astype(np.complex64)
    return dot, u1, v1, t(freq), t((freq * 1e-12).astype(np.float32)), t(b)


def dft_problem(rng, S, P, R, F, C, grid, device):
    """Random DFT kernel operands on ``device``, made with numpy (also used
    by tests/test_torch_cuda.py): (source lm (S, 2), pixel lm (P, 2),
    uvw (R, 3), frequencies (F,), image (S, F, C) complex64, vis (R, F, C)
    complex64). ``grid`` picks frequencies that engage that phase mode:
    an f64 linspace ("exact"), an f32 linspace ("residual") or a
    non-uniform grid ("direct")."""
    import torch

    f32 = np.float32
    if grid == "exact":
        freq = np.linspace(0.856e9, 1.712e9, F)
    elif grid == "residual":
        freq = np.linspace(0.856e9, 1.712e9, F).astype(f32)
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


def phase_kernel_checks(device):
    import torch
    from africanus_tpu_torch.ops.cuda_predict import (
        predict_kb, predict_kb_reference,
    )
    from africanus_tpu_torch.rime.phase import phase_dot_cycles

    rng = np.random.default_rng(SEED)
    worst = {}
    for C in (4, 2, 1):
        for compensated in (True, False):
            for env in (True, False):
                ops = kernel_problem(rng, 37, 1000, 300, C, compensated, env,
                                     device)
                got = predict_kb(*ops)
                torch.cuda.synchronize()
                want = predict_kb_reference(*ops)
                check(got.shape == (1000, 300, C) and got.dtype == torch.complex64,
                      f"kernel output {tuple(got.shape)} {got.dtype}")
                err = float((got - want).abs().max() / want.abs().max())
                bound = 2e-6 if compensated else 1e-5
                key = f"C{C}/{'comp' if compensated else 'plain'}/{'env' if env else 'point'}"
                worst[key] = err
                check(err <= bound, f"kernel vs plain {key}: {err:.3e} > {bound}")

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
    print(f"[3/{PHASES}] predict_kb vs plain on the card (S=37 R=1000 F=300, "
          "rel to max|V|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; compensated vs f64 oracle (S=16 R=128 F=128 C=2): {f64_err:.2e}",
          flush=True)


def dft_kernel_checks(device):
    """Phase 4: both DFT kernels against their plain versions."""
    import torch
    from africanus_tpu_torch.dft import im_to_vis
    from africanus_tpu_torch.ops import cuda_dft as cd
    from africanus_tpu_torch.ops.cuda_predict import predict_kb

    rng = np.random.default_rng(SEED + 1)
    worst = {}

    def compare(key, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max() / want.abs().max())
        worst[key] = max(worst.get(key, 0.0), err)
        check(err <= DFT_BOUND, f"{key}: {err:.3e} > {DFT_BOUND}")

    modes = set()
    # (S, P, R, F): the ragged shape for every mode, corr and convention,
    # plus one-channel and many-group edges
    for S, P, R, F, grids in ((37, 300, 1000, 12, ("exact", "residual", "direct")),
                              (1, 5, 9, 1, ("exact",)),
                              (70, 129, 33, 16, ("residual",))):
        for grid in grids:
            for C in (1, 2, 4):
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
                        compare(f"forward/{sky}", got, want)
                    adj = cd.DftPlan("adjoint", lm_p, freq, C, conv)
                    got = cd.dft_adjoint(adj, uvw, vis)
                    want = cd.dft_adjoint_reference(adj, uvw, vis)
                    check(got.shape == (P, F, C) and got.dtype == torch.float32,
                          "adjoint shape")
                    compare("adjoint", got, want)
                    modes.update((fwd.mode, adj.mode))
    check(modes == {"exact", "residual", "direct"}, f"modes run: {modes}")

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
          f"F=12, modes {sorted(modes)}, C 1/2/4, both conventions, and edge "
          "shapes; rel to max|out|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; deterministic; im_to_vis 256 chan via predict_kb vs CPU {wide:.2e}",
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
    got = predict_kb(*ops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want, plain_ms = cuda_once_ms(lambda: predict_kb_reference(*ops))
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    max_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(max_abs <= 2e-6 * scale,
          f"kernel vs plain at the slice shape: {max_abs:.3e} > 2e-6 x {scale:.3e}")
    nvis = nrow * NCHAN * NCORR
    print(f"[6/{PHASES}] flagship times on {card}: predict_kb kernel "
          f"{kernel_ms:.3f} ms ({nvis / kernel_ms / 1e3:.1f} Mvis/s), forward "
          f"{forward_ms:.3f} ms ({nvis / forward_ms / 1e3:.1f} Mvis/s), plain "
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
    }


def selfcal(device, card):
    """Phases 7-9: one config-5 selfcal step. Returns the dft_forward and
    dft_adjoint entries of the kernels line."""
    import torch
    from africanus_tpu_torch.calibration.phase_only import gauss_newton
    from africanus_tpu_torch.calibration.selfcal import (
        from_numpy, gain_product_error, im_to_vis_oracle_f64, make_data,
        selfcal_inputs, vis_to_im_oracle_f64,
    )
    from africanus_tpu_torch.calibration.utils import corrupt_vis
    from africanus_tpu_torch.deconv.hogbom import hogbom_clean
    from africanus_tpu_torch.dft import im_to_vis, vis_to_im
    from africanus_tpu_torch.ops import cuda_dft as cd
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
    t0 = time.perf_counter()
    outs = step(data)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"dft_forward": cd.dft_forward.launches,
                "dft_adjoint": cd.dft_adjoint.launches,
                "predict_kb": predict_kb.launches}
    check(launches == {"dft_forward": 1, "dft_adjoint": 1, "predict_kb": 0},
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
    got = cd.dft_forward(fwd, step.uvw, step.image)
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
    step_ms, step_runs = cuda_median_ms(lambda: step(data))
    step_host_ms = host_median_ms(lambda: step(data))
    nvis = nrow * nchan
    rate = nvis * SELFCAL_GN_ITERS / (step_ms / 1e3) / 1e6
    print(f"[9/{PHASES}] selfcal times on {card}: step {step_ms:.3f} ms "
          f"(runs {', '.join(f'{t:.3f}' for t in step_runs)}) = {rate:.1f} "
          f"Mvis-iter/s (bench.py:1254's rate), host clock "
          f"{step_host_ms:.3f} ms; GN solve ({SELFCAL_GN_ITERS} it) "
          f"{gn_ms:.3f} ms; CLEAN {clean_ms:.3f} ms; dft_adjoint kernel "
          f"{adj_ms:.3f} ms per launch (CUDA graph of {BURST}), vis_to_im as the "
          f"step calls it {adj_call_ms:.3f} ms, plain {adj_plain_ms:.1f} ms "
          f"(residual image, {npx * npx} px x {nrow} rows x {nchan} chan); "
          f"dft_forward kernel {fwd_ms:.3f} ms per launch, im_to_vis "
          f"{fwd_call_ms:.3f} ms, plain {fwd_plain_ms:.1f} ms (re-predict); "
          f"the kernels line shows the per-launch times; kernel vs plain max "
          f"abs err adjoint {adj_abs:.3e} (max {adj_scale:.3e}), forward "
          f"{fwd_abs:.3e} (max {fwd_scale:.3e})", flush=True)
    return [
        {"name": "dft_forward", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/dft.cu",
         "replaces": "africanus_tpu/ops/pallas_dft.py:661",
         "launches": launches["dft_forward"], "max_abs_err": fwd_abs,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms},
        {"name": "dft_adjoint", "route": "cuda",
         "source": "africanus_tpu_torch/csrc/dft.cu",
         "replaces": "africanus_tpu/ops/pallas_dft.py:445",
         "launches": launches["dft_adjoint"], "max_abs_err": adj_abs,
         "ms": adj_ms, "plain_ms": adj_plain_ms},
    ]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "main path runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from africanus_tpu_torch.ops.cuda_dft import build_dft
    from africanus_tpu_torch.ops.cuda_predict import build_predict_kb

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

    # 2. build, one nvcc per source, started together
    with ThreadPoolExecutor(2) as pool:
        builds = [f.result() for f in [pool.submit(build_predict_kb),
                                       pool.submit(build_dft)]]
    for lib, seconds, log in builds:
        ptxas = "; ".join(ln.split("ptxas info    : ")[-1]
                          for ln in log.splitlines() if "Used" in ln)
        print(f"[2/{PHASES}] built {os.path.relpath(lib)} in {seconds:.1f} s "
              f"(ptxas: {ptxas})", flush=True)

    # 3-4. kernels against their plain versions
    phase_kernel_checks(device)
    dft_kernel_checks(device)

    # 5-9. the two paths
    kernels = [flagship(device, card)] + selfcal(device, card)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
