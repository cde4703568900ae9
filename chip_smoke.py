#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (africanus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, the flagship RIME predict, at a MeerKAT-64
full-band size and checks it, in five phases that each print one line:

1. environment: torch/CUDA versions, the card's name and power limit;
2. build: compiles csrc/predict_kb.cu with nvcc into build/ (first use);
3. kernel vs plain: the CUDA kernel against its plain PyTorch version on
   the card (four modes × corr 1/2/4 at a ragged shape), and against a
   float64 oracle at 1e4 rad phases;
4. the slice: FlagshipPredict over 3 row chunks of 4 time steps
   (64 antennas, 2016 baselines, 8064 rows, 4096 channels 0.856-1.712
   GHz, 4 correlations, 100 gaussian sources), counting the kernel's
   launches and checking windows of every chunk against a float64 oracle;
5. times: CUDA-event medians of the kernel and of the whole forward at
   that shape, and one run of the plain version.

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

import numpy as np

SEED = 2026
NSRC, NTIME, NANT, NCHAN, NCORR = 100, 4, 64, 4096, 4
NCHUNK = 3
JAX_CONFIG2_ERR = 2.30e-6  # the JAX package's f32 accuracy at config 2 (BENCH_r05.json)


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
    print("[3/5] kernel vs plain on the card (S=37 R=1000 F=300, rel to max|V|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; compensated vs f64 oracle (S=16 R=128 F=128 C=2): {f64_err:.2e}",
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "main path runs only on a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from africanus_tpu_torch.ops.cuda_predict import (
        build_predict_kb, predict_kb, predict_kb_reference,
    )
    from africanus_tpu_torch.rime.flagship import from_numpy, predict_oracle_f64

    # full-f32 references: no TF32 in any matmul or convolution
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[1/5] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
    print(smi, flush=True)

    # 2. build
    lib, seconds, log = build_predict_kb()
    ptxas = "; ".join(ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                      if "Used" in ln)
    print(f"[2/5] built {os.path.relpath(lib)} in {seconds:.1f} s "
          f"(ptxas: {ptxas})", flush=True)

    # 3. the kernel against its plain version and an f64 oracle
    phase_kernel_checks(device)

    # 4. the slice: 3 row chunks through one module
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
    print(f"[4/5] slice: {NCHUNK} chunks x ({nrow} rows, {NCHAN} chan, "
          f"{NCORR} corr, {NSRC} gaussian src) in {wall:.3f} s wall "
          f"(first call included); predict_kb launches {launches}; "
          f"max rel err vs f64 oracle per chunk "
          f"{', '.join(f'{e:.2e}' for e in errs)} "
          f"(JAX package, config 2, TPU: {JAX_CONFIG2_ERR:.2e})", flush=True)
    del outs

    # 5. times at the slice's shape (chunk 0), on this card
    ops = model.kernel_operands(inputs[0][3], inputs[0][4])
    kernel_ms, _ = cuda_median_ms(lambda: predict_kb(*ops))
    forward_ms, _ = cuda_median_ms(lambda: model(*inputs[0]))
    got = predict_kb(*ops)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = predict_kb_reference(*ops)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    max_abs = float((got - want).abs().max())
    scale = float(want.abs().max())
    check(max_abs <= 2e-6 * scale,
          f"kernel vs plain at the slice shape: {max_abs:.3e} > 2e-6 x {scale:.3e}")
    nvis = nrow * NCHAN * NCORR
    print(f"[5/5] times on {card}: predict_kb kernel {kernel_ms:.3f} ms "
          f"({nvis / kernel_ms / 1e3:.1f} Mvis/s), forward {forward_ms:.3f} ms "
          f"({nvis / forward_ms / 1e3:.1f} Mvis/s), plain predict_kb_reference "
          f"{plain_ms:.1f} ms ({nvis / plain_ms / 1e3:.1f} Mvis/s, peak "
          f"{plain_peak:.1f} GiB); kernel vs plain max abs err {max_abs:.3e} "
          f"(max|V| {scale:.3e})", flush=True)

    print(json.dumps({"kernels": [{
        "name": "predict_kb",
        "route": "cuda",
        "source": "africanus_tpu_torch/csrc/predict_kb.cu",
        "replaces": "africanus_tpu/ops/pallas_predict.py:393, "
                    "africanus_tpu/ops/pallas_predict.py:238",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
