// Fused K x envelope x B source contraction of the RIME predict, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
//   V[r,f,c] = sum_s exp(i*phase(s,r,f)) * env(s,r,f) * B[s,f,c]
//
//   compensated: phase = 2*pi*frac((hi+lo)[s,r] * nu[f])  (two-float delay
//                in seconds, reduced mod one cycle at ~48-bit precision)
//   plain:       phase = dot[s,r] * nu[f]                 (radians)
//   envelope:    env   = exp(-((u1[s,r]*sf[f])^2 + (v1[s,r]*sf[f])^2)),
//                or 1 for point sources (u1 = v1 = NULL)
//
// Replaces both Pallas TPU kernels of africanus_tpu/ops/pallas_predict.py,
// which compute this same map on different TPU units:
//   predict_kb_pallas_srclane / _predict_srclane_kernel (sources on lanes,
//     MXU dot), and
//   predict_kb_pallas / _predict_kernel (row x chan tiles, VPU multiply-sum).
// It computes their map, not their schedule (a cos/sin and an exp per
// term): no lane padding, no divisibility rules; any S, R and F.
//
// What bounds it on an H100: the operations. The map needs, per (source,
// row, channel) term, 4*C FMAs to multiply and accumulate, 4 to advance a
// phasor and 2 to apply an envelope. At C = 1, 2 all of them issue on the
// FP32 pipes (3.35e13 a second). At C = 4 the multiply-accumulate runs on
// the tensor cores in 3xTF32, 3 x 8*C operations a term at 495 TFLOP/s
// dense, beside the other 6 on the FP32 pipes: at the MeerKAT-64
// full-band chunk (100 sources x 8064 rows x 4096 channels) that is 0.64 ms
// of tensor-core time and 0.59 ms of FP32 issue, against ~1 GB of output
// (0.32 ms of HBM time).
//
// The phase (compensated; every caller's route). The host plans the
// channels in groups of cg <= 16 (ops/cuda_predict.py, PredictPlan, on
// ops/cuda_dft.chan_group_tables) in one of three modes:
//   DIRECT    one two-float phase and one sincospif per channel;
//   EXACT     the phasor at the group's base frequency, then a unit-phasor
//             recurrence by the grid's step along the group's channels;
//   RESIDUAL  EXACT plus a rotation by x = 2*pi*delay*delta_f per channel
//             (delta_f: the channel's offset from the fitted even grid,
//             e.g. the rounding of a float32 linspace): 1 + i*x where
//             x^2/2 <= 1e-7 (|delay| <= the plan's delay_small), else
//             cos = 1 - x^2/2 + x^4/24, sin = x - x^3/6, which hold to 1e-7
//             for |x| <= 0.1 rad (the plan engages the mode only there).
// A (source, row) pair whose |delay| exceeds the plan's delay_max takes
// the DIRECT phase, in the same kernel: a delay beyond the plan's bound is
// never inaccurate, only slower. A warp takes one path for a source (or a
// slice of sources) by vote over its pairs. The envelope is ex2.approx (the
// SFU, ~2 ulp) of (u1^2 + v1^2) * (-log2(e) * sf^2), the first factor per
// pair and the second per channel.
//
// The contraction. A block is 32 rows x 4 channel groups (or 2 groups of
// two 16-row tiles at C = 4); a warp walks the 16 channel slots of its
// group (a slot past the group's channels is zero padding, so that every
// thread runs all 16 without a branch). Per tile of SRC_TILE sources the
// block stages the pairs' scalars (delay, its Dekker split, u1^2 + v1^2,
// the step phasor and the kind: computed once per pair for all the block's
// groups) and B[s, block's channels, :] in shared memory, B by cp.async,
// in flight while the block computes the pairs (STAGES says why one
// buffer).
//  - C = 1, 2 (predict_kb_kernel): a thread owns one row's 16 x C complex
//    accumulators and its warp's channel tables in registers; a term reads
//    B from shared memory as a broadcast.
//  - C = 4 (predict_kb_mma_kernel): that read would be 32 B a lane a term,
//    more than shared memory delivers beside the 16 FMAs. So the
//    contraction over each slice of 4 sources runs on the tensor cores as
//    a real (16 rows x 8) . (8 x 8) product per channel,
//      [Kre Kim] . [[Bre Bim], [-Bim Bre]] -> [Vre Vim],
//    one m16n8k8 mma in 3xTF32 (small.big + big.small + big.big, ~float32
//    accuracy; plain TF32 would keep ~1e-3, the GPU's twin of the TPU's
//    bf16 trap). A thread computes the phasors of the (row, source) pairs
//    it holds in the A fragments (rows g and g+8 of the mma's group g,
//    source t of each slice), so K is built in registers in the fragment's
//    layout and never stored; a tile's products start from zero and are
//    added to the running sum in float32 (the tensor core's own sums
//    truncate).
// Every output is owned by one thread, which sums all sources in order: no
// cross-block reduction, no atomics, reruns are bitwise equal. Registers
// are the scarce resource: tools/predict_kb_variants.py times the designs
// this one was chosen over (CUDA cores at C = 4, other register caps, two
// buffers of sources).
//
// The DIE gains (GAINS, both kernels): a caller that multiplies V by
// diagonal direction-independent gains, G_p V G_q^H with (T, A, F, C)
// tables g1, g2, hands them to the kernel, which applies them as it
// stores V:
//   out[r,f,c] = (g1[t,p,f,c] * V[r,f,c]) * conj(g2[t,q,f,c]),
// (t, p, q) row r's dump (less the chunk's first), antenna1 and antenna2,
// loaded once a thread for each of its rows. Without it the map costs a
// pass of its own over the output: V written, read back and written again
// (2 x 1.06 GB at the MeerKAT-64 chunk, >= 0.63 ms of HBM time), besides
// the gathered gain planes; in the store it reads only the gains, whose
// rows a block's 32 rows (consecutive baselines of a dump) share in L1 and
// L2 (a MeerKAT-64 chunk's table is 33.5 MB). The sums and their order
// are untouched, so reruns stay bitwise; the epilogue is compiled only
// into the GAINS = true instances.
//
// The plain-phase kernel (predict_kb_plain_kernel; no caller on a main
// path) keeps the direct per-term evaluation: a thread a channel, ROWS rows
// of accumulators, sincosf and expf per term.
//
// Rounding hazards handled here:
//  - nvcc contracts a*b+c into an FMA by default (-fmad=true), which
//    silently turns Dekker's error-free two_prod into plain f32. The
//    two-float chain is written with __fmul_rn/__fadd_rn/__fsub_rn, which
//    are never contracted. (The recurrence, the rotation, the envelope and
//    the accumulation, where an FMA only helps, are left to the compiler.)
//  - round-half-to-even as jnp.round / torch.round: rintf, not roundf.
//  - accurate sincospif (never built with --use_fast_math, which would also
//    flush denormals to zero); ex2.approx only for the envelope.

#include <cuda_runtime.h>

namespace {

constexpr int DIRECT = 0, EXACT = 1, RESIDUAL = 2;
constexpr int SLOTS = 16;     // channel slots a warp (the plan's cg cap)
constexpr int LANES = 32;     // rows per block, one a lane
constexpr int GPB = 4;        // channel groups per block, one a warp (C < 4)
constexpr int MMA_GROUPS = 2; // C = 4: groups per block, two row tiles each
constexpr int SRC_TILE = 8;   // sources staged in shared memory per pass
// buffers of source tiles in shared memory: one, its B copied by cp.async
// while the block computes the pairs' scalars; two (the next tile staged
// while this one computes) time no faster (tools/predict_kb_variants.py)
constexpr int STAGES = 1;
constexpr int NSLICE = 2;     // C = 4: slices of 4 sources a thread takes together
// blocks an SM holds: at C = 1 and C = 4 a cap of 128 registers a thread
// (at C = 4 it spills a few hundred bytes, and still beats fewer warps to
// a scheduler: tools/predict_kb_variants.py); C = 2 needs up to ~200
constexpr int CORE_MIN_BLOCKS = 4;
constexpr int CORE2_MIN_BLOCKS = 2;
constexpr int MMA_MIN_BLOCKS = 4;
constexpr float NEG_LOG2E = -1.4426950408889634f;

__device__ __forceinline__ void dekker_split(float a, float& hi, float& lo) {
    const float c = __fmul_rn(a, 4097.0f);
    hi = __fsub_rn(c, __fsub_rn(c, a));
    lo = __fsub_rn(a, hi);
}

// cos/sin of 2*pi*frac((hi + lo) * (f + flo)); (hh, hl) split hi, (fhh,
// fhl) split f: the two-float product with hoisted splits, p - rint(p)
// exact (Sterbenz), frac in [-0.5, 0.5] (+ tiny), 2*frac exact
__device__ __forceinline__ void phasor(float hi, float hh, float hl, float lo,
                                       float4 f, float& cs, float& sn) {
    const float p = __fmul_rn(hi, f.x);
    float e = __fsub_rn(__fmul_rn(hh, f.y), p);
    e = __fadd_rn(e, __fmul_rn(hh, f.z));
    e = __fadd_rn(e, __fmul_rn(hl, f.y));
    e = __fadd_rn(e, __fmul_rn(hl, f.z));
    e = __fadd_rn(e, __fmul_rn(lo, f.x));
    e = __fadd_rn(e, __fmul_rn(hi, f.w));
    const float frac = __fadd_rn(__fsub_rn(p, rintf(p)), e);
    sincospif(2.0f * frac, &sn, &cs);
}

__device__ __forceinline__ float ex2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// per (source, row) pair, staged once for all the block's groups
struct Pair {
    float hi, hh, hl, lo;  // the delay (s) and the Dekker split of hi
    float a;               // u1^2 + v1^2 (envelope)
    float sre, sim;        // the step phasor (EXACT, RESIDUAL)
    float kind;            // SMALL, FULL or FAR (below)
};

// a pair's phase: |hi| <= delay_small, where a first-order rotation holds;
// |hi| <= delay_max, the full rotation polynomial; beyond, the DIRECT phase
constexpr float SMALL = 0.0f, FULL = 1.0f, FAR = 2.0f;
// the rotation applied to a term: none (EXACT), first order, or the
// polynomial of the RESIDUAL mode
constexpr int ROT_NONE = 0, ROT_SMALL = 1, ROT_FULL = 2;
template <int R>
struct Rot {
    static constexpr int value = R;
};

// A block's channel slots: warp ww of the block walks the SLOTS slots of
// group g0 + ww; a slot past the group's channels (or past F) is padding,
// staged as zeros (no B, no rotation, no envelope).
struct Slots {
    int g0, gpb, cg, F;
    __device__ __forceinline__ int chan(int ww, int k) const {
        const int f = (g0 + ww) * cg + k;
        return (ww < gpb && k < cg && f < F) ? f : -1;
    }
};

template <int MODE, bool ENV, int NG>
__device__ __forceinline__ void stage_channels(const Slots& sl, const float* sf,
                                               const float4* ftab, const float* rtab,
                                               float4 (*s_freq)[SLOTS],
                                               float2 (*s_chan)[SLOTS]) {
    for (int i = threadIdx.x; i < NG * SLOTS; i += blockDim.x) {
        const int ww = i / SLOTS, k = i % SLOTS, f = sl.chan(ww, k);
        const float x = (ENV && f >= 0) ? sf[f] : 0.0f;
        s_freq[ww][k] = f >= 0 ? ftab[f] : make_float4(0, 0, 0, 0);
        s_chan[ww][k] = make_float2(MODE == RESIDUAL && f >= 0 ? rtab[f] : 0.0f,
                                    NEG_LOG2E * x * x);
    }
}

// the pairs of sources s0 .. s0+ns and rows r0 .. r0+LANES
template <int MODE, bool ENV>
__device__ __forceinline__ void stage_pairs(Pair (*s_pair)[LANES],
                                            const float* __restrict__ hi,
                                            const float* __restrict__ lo,
                                            const float* __restrict__ u1,
                                            const float* __restrict__ v1,
                                            float4 step, float delay_max,
                                            float delay_small, int s0, int ns,
                                            int r0, int R) {
    for (int i = threadIdx.x; i < SRC_TILE * LANES; i += blockDim.x) {
        const int ls = i / LANES, lr = i % LANES;
        Pair q = {0, 0, 0, 0, 0, 1, 0, SMALL};
        if (ls < ns && r0 + lr < R) {
            const size_t at = (size_t)(s0 + ls) * R + r0 + lr;
            q.hi = hi[at];
            q.lo = lo[at];
            dekker_split(q.hi, q.hh, q.hl);
            if (ENV) q.a = u1[at] * u1[at] + v1[at] * v1[at];
            const float d = fabsf(q.hi);
            q.kind = d > delay_max ? FAR : d > delay_small ? FULL : SMALL;
            if (MODE != DIRECT && q.kind != FAR)
                phasor(q.hi, q.hh, q.hl, q.lo, step, q.sre, q.sim);
        }
        s_pair[ls][lr] = q;
    }
}

// an asynchronous copy of N = 8 or 16 bytes from global to shared memory
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (N == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// B[s0 .. s0+SRC_TILE, the block's slots, :], zero past S and in padding
template <int C, int NG>
__device__ __forceinline__ void stage_b(float2 (*s_b)[NG][SLOTS * C],
                                        const Slots& sl, const float2* __restrict__ b,
                                        int s0, int ns) {
    constexpr int N = NG * SLOTS * C;
    if (ns == SRC_TILE && sl.gpb == NG && sl.cg == SLOTS && (sl.g0 + NG) * SLOTS <= sl.F) {
        // every slot a channel: each source's block of B is contiguous, and
        // copied asynchronously (cp_async_wait before it is read)
        constexpr int V = (C % 2 == 0) ? 2 : 1;  // float2s a copy
        for (int i = threadIdx.x; i < SRC_TILE * N / V; i += blockDim.x) {
            const int ls = i / (N / V), j = i % (N / V);
            cp_async<8 * V>(s_b[ls][0] + V * j,
                            b + ((size_t)(s0 + ls) * sl.F + (size_t)sl.g0 * SLOTS) * C + V * j);
        }
        cp_async_commit();
        return;
    }
    for (int i = threadIdx.x; i < SRC_TILE * N; i += blockDim.x) {
        const int ls = i / N, j = i % N;
        const int ww = j / (SLOTS * C), k = (j / C) % SLOTS, c = j % C;
        const int f = sl.chan(ww, k);
        s_b[ls][ww][k * C + c] = (ls < ns && f >= 0)
            ? b[((size_t)(s0 + ls) * sl.F + f) * C + c] : make_float2(0.0f, 0.0f);
    }
}

// y = z x the residual rotation by x = 2*pi*delta*hi (ch.x = 2*pi*delta)
// x the envelope ex2(a * ch.y)
template <int ROT, bool ENV>
__device__ __forceinline__ void term(float zr, float zi, float hi, float a,
                                     float2 ch, float& yr, float& yi) {
    yr = zr;
    yi = zi;
    if (ROT == ROT_SMALL) {
        const float x = hi * ch.x;
        yr = zr - zi * x;
        yi = zi + zr * x;
    }
    if (ROT == ROT_FULL) {
        const float x = hi * ch.x;
        const float x2 = x * x;
        const float cr = 1.0f + x2 * (x2 * (1.0f / 24.0f) - 0.5f);
        const float sr = x * (1.0f - x2 * (1.0f / 6.0f));
        yr = zr * cr - zi * sr;
        yi = zi * cr + zr * sr;
    }
    if (ENV) {
        const float e = ex2_approx(a * ch.y);
        yr *= e;
        yi *= e;
    }
}

__device__ __forceinline__ void advance(float& zr, float& zi, const Pair& q) {
    const float nr = zr * q.sre - zi * q.sim;
    zi = zr * q.sim + zi * q.sre;
    zr = nr;
}

// The DIE gains of the store (GAINS; the header says how): the rows'
// dumps (less the chunk's first) and antennas, and the two (T, A, F, C)
// complex64 tables, which may be one.
struct Gains {
    const long long* time;
    const long long* a1;
    const long long* a2;
    const float2* g1;
    const float2* g2;
    int T, A;
};

// g1[t, p, f0 .., :] and g2[t, q, f0 .., :] of output row r, or NULL
// where r's indices lie outside the tables (its outputs are then NaN)
template <int C>
__device__ __forceinline__ void gain_rows(const Gains& gn, int r, int F, size_t f0,
                                          const float2*& g1, const float2*& g2) {
    const long long t = gn.time[r], p = gn.a1[r], q = gn.a2[r];
    if (t < 0 || t >= gn.T || p < 0 || p >= gn.A || q < 0 || q >= gn.A) {
        g1 = g2 = nullptr;
        return;
    }
    g1 = gn.g1 + ((size_t)t * gn.A + p) * F * C + f0 * C;
    g2 = gn.g2 + ((size_t)t * gn.A + q) * F * C + f0 * C;
}

// (g1 * v) * conj(g2), in the order of rime/predict.py's predict_vis
__device__ __forceinline__ float2 sandwich(float2 g1, float2 v, float2 g2) {
    const float pr = g1.x * v.x - g1.y * v.y, pi = g1.x * v.y + g1.y * v.x;
    return make_float2(pr * g2.x + pi * g2.y, pi * g2.x - pr * g2.y);
}

__device__ __forceinline__ float2 nan2() {
    const float x = __int_as_float(0x7fc00000);
    return make_float2(x, x);
}

#define PREDICT_ARGS                                                          \
    const float* __restrict__ hi, const float* __restrict__ lo,               \
        const float* __restrict__ u1, const float* __restrict__ v1,           \
        const float* __restrict__ sf, const float2* __restrict__ b,           \
        const float4* __restrict__ ftab, const float* __restrict__ rtab,      \
        const float4* __restrict__ gtab, int cg, int ngroups,                 \
        float delay_max, float delay_small, float2* __restrict__ out, int S,  \
        int R, int F

// C = 1, 2 on the CUDA cores: a thread keeps its row's SLOTS x C
// accumulators and its warp's channel tables in registers.
template <int C, int MODE, bool ENV, bool GAINS>
__global__ void __launch_bounds__(LANES * GPB, C == 1 ? CORE_MIN_BLOCKS : CORE2_MIN_BLOCKS)
predict_kb_kernel(PREDICT_ARGS, Gains gn) {
    __shared__ Pair s_pair[STAGES][SRC_TILE][LANES];
    __shared__ __align__(16) float2 s_b[STAGES][SRC_TILE][GPB][SLOTS * C];
    __shared__ float4 s_freq[GPB][SLOTS];  // [nu, hh, hl, lo] (DIRECT)
    __shared__ float2 s_chan[GPB][SLOTS];  // [2*pi*delta, -log2(e)*sf^2]

    const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
    const Slots sl = {(int)blockIdx.y * (int)(blockDim.x / LANES),
                      (int)(blockDim.x / LANES), cg, F};
    const int r0 = blockIdx.x * LANES;
    const int g = sl.g0 + w;
    const bool active = g < ngroups;  // per warp; rows past R are dropped

    stage_channels<MODE, ENV, GPB>(sl, sf, ftab, rtab, s_freq, s_chan);
    // the group's base and the grid's step, two-float [nu, hh, hl, lo]
    const float4 base = (MODE != DIRECT && active) ? gtab[2 * g]
                                                   : make_float4(0, 0, 0, 0);
    const float4 step = MODE != DIRECT ? gtab[1] : make_float4(0, 0, 0, 0);
    __syncthreads();
    float2 ch[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) ch[k] = s_chan[w][k];

    float acc_re[SLOTS][C], acc_im[SLOTS][C];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) acc_re[k][c] = acc_im[k][c] = 0.0f;

    // slot k: multiply-accumulate y into the C correlations of B
    auto mac = [&](int k, const float2* bp, float yr, float yi) {
        float2 bv[C];
        if constexpr (C % 2 == 0) {
#pragma unroll
            for (int c = 0; c < C; c += 2) {
                const float4 v = reinterpret_cast<const float4*>(bp + k * C)[c / 2];
                bv[c] = make_float2(v.x, v.y);
                bv[c + 1] = make_float2(v.z, v.w);
            }
        } else {
            bv[0] = bp[k];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
            acc_re[k][c] += yr * bv[c].x - yi * bv[c].y;
            acc_im[k][c] += yr * bv[c].y + yi * bv[c].x;
        }
    };
    // the recurrence along the slots, with rotation ROT
    auto recur = [&](auto rot, const Pair& q, const float2* bp) {
        float zr, zi;
        phasor(q.hi, q.hh, q.hl, q.lo, base, zr, zi);
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            float yr, yi;
            term<decltype(rot)::value, ENV>(zr, zi, q.hi, q.a, ch[k], yr, yi);
            mac(k, bp, yr, yi);
            advance(zr, zi, q);
        }
    };

    // the tile of sources from s0 into buffer buf
    auto stage = [&](int s0, int buf) {
        const int ns = min(SRC_TILE, S - s0);
        stage_b<C, GPB>(s_b[buf], sl, b, s0, ns);
        stage_pairs<MODE, ENV>(s_pair[buf], hi, lo, u1, v1, step, delay_max,
                               delay_small, s0, ns, r0, R);
    };
    if (STAGES == 2) stage(0, 0);
    for (int s0 = 0, t = 0; s0 < S; s0 += SRC_TILE, ++t) {
        const int ns = min(SRC_TILE, S - s0), buf = t % STAGES;
        if (STAGES == 1) {
            __syncthreads();  // the previous tile has been consumed
            stage(s0, 0);
        }
        cp_async_wait();
        __syncthreads();  // this tile is staged, the previous one consumed
        if (STAGES == 2 && s0 + SRC_TILE < S) stage(s0 + SRC_TILE, buf ^ 1);
        if (!active) continue;

        for (int ls = 0; ls < ns; ++ls) {
            const Pair q = s_pair[buf][ls][lane];
            const float2* bp = s_b[buf][ls][w];
            if (MODE == DIRECT || __any_sync(0xffffffffu, q.kind == FAR)) {
#pragma unroll
                for (int k = 0; k < SLOTS; ++k) {
                    float cs, sn, yr, yi;
                    phasor(q.hi, q.hh, q.hl, q.lo, s_freq[w][k], cs, sn);
                    term<ROT_NONE, ENV>(cs, sn, q.hi, q.a, ch[k], yr, yi);
                    mac(k, bp, yr, yi);
                }
            } else if (MODE == EXACT) {
                recur(Rot<ROT_NONE>(), q, bp);
            } else if (__all_sync(0xffffffffu, q.kind == SMALL)) {
                recur(Rot<ROT_SMALL>(), q, bp);
            } else {
                recur(Rot<ROT_FULL>(), q, bp);
            }
        }
    }

    const int r = r0 + lane;
    if (!active || r >= R) return;
    float2* op = out + ((size_t)r * F + (size_t)g * cg) * C;
    const float2 *g1r = nullptr, *g2r = nullptr;
    if constexpr (GAINS) gain_rows<C>(gn, r, F, (size_t)g * cg, g1r, g2r);
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
        if (sl.chan(w, k) < 0) break;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float2 v = make_float2(acc_re[k][c], acc_im[k][c]);
            if constexpr (GAINS)
                v = g1r == nullptr ? nan2()
                                   : sandwich(__ldg(g1r + k * C + c), v, __ldg(g2r + k * C + c));
            op[k * C + c] = v;
        }
    }
}

// tf32 halves of x for 3xTF32: big rounded to tf32 (an integer add and a
// mask), small = x - big exactly, truncated by the tensor core
// (|error| <= 2^-21 |x|)
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
    big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(x - __uint_as_float(big));
}

// d += a . b on the tensor cores: m16n8k8, tf32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C = 4 on the tensor cores (the header says how). A warp owns one 16-row
// tile of one channel group and takes NSLICE slices of 4 sources together;
// pair (u, j) of a thread is source 4u + t and row g + 8j of its tile.
template <int MODE, bool ENV, bool GAINS>
__global__ void __launch_bounds__(LANES * 2 * MMA_GROUPS, MMA_MIN_BLOCKS)
predict_kb_mma_kernel(PREDICT_ARGS, Gains gn) {
    constexpr int C = 4;
    __shared__ Pair s_pair[STAGES][SRC_TILE][LANES];
    __shared__ __align__(16) float2 s_b[STAGES][SRC_TILE][MMA_GROUPS][SLOTS * C];
    __shared__ float4 s_freq[MMA_GROUPS][SLOTS];
    __shared__ float2 s_chan[MMA_GROUPS][SLOTS];

    const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
    const int gq = lane / 4, tq = lane % 4;  // the mma's group and thread in it
    const int tile = w % 2, wg = w / 2;      // the warp's row tile and group
    const Slots sl = {(int)blockIdx.y * (int)(blockDim.x / (2 * LANES)),
                      (int)(blockDim.x / (2 * LANES)), cg, F};
    const int r0 = blockIdx.x * LANES;
    const int g = sl.g0 + wg;
    const bool active = g < ngroups;

    stage_channels<MODE, ENV, MMA_GROUPS>(sl, sf, ftab, rtab, s_freq, s_chan);
    const float4 base = (MODE != DIRECT && active) ? gtab[2 * g]
                                                   : make_float4(0, 0, 0, 0);
    const float4 step = MODE != DIRECT ? gtab[1] : make_float4(0, 0, 0, 0);

    float acc[SLOTS][4];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[k][i] = 0.0f;

    // slot k: A from the pairs' terms y, B from shared memory; the slices'
    // products summed from zero, then added to the running sum
    auto product = [&](const float2 (*sb)[MMA_GROUPS][SLOTS * C], int h, int k,
                       const float (&yr)[NSLICE][2], const float (&yi)[NSLICE][2]) {
        float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int u = 0; u < NSLICE; ++u) {
            // b0 = Bm[(source t, re), n = g], b1 = Bm[(source t, im), n = g];
            // n < 4 is correlation n's real part, n >= 4 correlation n-4's
            // imaginary part
            const float2 bv = sb[h + 4 * u + tq][wg][k * C + (gq & 3)];
            unsigned b0b, b0s, b1b, b1s;
            split_tf32(gq < 4 ? bv.x : bv.y, b0b, b0s);
            split_tf32(gq < 4 ? -bv.y : bv.x, b1b, b1s);
            unsigned rb[2], rs[2], ib[2], is[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                split_tf32(yr[u][j], rb[j], rs[j]);
                split_tf32(yi[u][j], ib[j], is[j]);
            }
            mma_tf32(d, rs[0], rs[1], is[0], is[1], b0b, b1b);
            mma_tf32(d, rb[0], rb[1], ib[0], ib[1], b0s, b1s);
            mma_tf32(d, rb[0], rb[1], ib[0], ib[1], b0b, b1b);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[k][i] += d[i];
    };
    // the recurrence along the slots, with rotation ROT
    auto recur = [&](auto rot, const float2 (*sb)[MMA_GROUPS][SLOTS * C], int h,
                     const Pair (&q)[NSLICE][2]) {
        float zr[NSLICE][2], zi[NSLICE][2], yr[NSLICE][2], yi[NSLICE][2];
#pragma unroll
        for (int u = 0; u < NSLICE; ++u)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                phasor(q[u][j].hi, q[u][j].hh, q[u][j].hl, q[u][j].lo, base,
                       zr[u][j], zi[u][j]);
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const float2 ck = s_chan[wg][k];
#pragma unroll
            for (int u = 0; u < NSLICE; ++u)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    term<decltype(rot)::value, ENV>(zr[u][j], zi[u][j], q[u][j].hi,
                                                    q[u][j].a, ck, yr[u][j], yi[u][j]);
                    advance(zr[u][j], zi[u][j], q[u][j]);
                }
            product(sb, h, k, yr, yi);
        }
    };

    // the tile of sources from s0 into buffer buf
    auto stage = [&](int s0, int buf) {
        const int ns = min(SRC_TILE, S - s0);
        stage_b<C, MMA_GROUPS>(s_b[buf], sl, b, s0, ns);
        stage_pairs<MODE, ENV>(s_pair[buf], hi, lo, u1, v1, step, delay_max,
                               delay_small, s0, ns, r0, R);
    };
    if (STAGES == 2) stage(0, 0);
    for (int s0 = 0, t = 0; s0 < S; s0 += SRC_TILE, ++t) {
        const int ns = min(SRC_TILE, S - s0), buf = t % STAGES;
        if (STAGES == 1) {
            __syncthreads();  // the previous tile has been consumed
            stage(s0, 0);
        }
        cp_async_wait();
        __syncthreads();  // this tile is staged, the previous one consumed
        if (STAGES == 2 && s0 + SRC_TILE < S) stage(s0 + SRC_TILE, buf ^ 1);
        if (!active) continue;
        const float2(*sb)[MMA_GROUPS][SLOTS * C] = s_b[buf];

        // NSLICE slices at a time; a source past S has zero B
        for (int h = 0; h < ns; h += 4 * NSLICE) {
            Pair q[NSLICE][2];
            bool far = false, small = true;
#pragma unroll
            for (int u = 0; u < NSLICE; ++u)
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    q[u][j] = s_pair[buf][h + 4 * u + tq][16 * tile + gq + 8 * j];
                    far = far || q[u][j].kind == FAR;
                    small = small && q[u][j].kind == SMALL;
                }
            if (MODE == DIRECT || __any_sync(0xffffffffu, far)) {
                float yr[NSLICE][2], yi[NSLICE][2];
#pragma unroll
                for (int k = 0; k < SLOTS; ++k) {
                    const float2 ck = s_chan[wg][k];
#pragma unroll
                    for (int u = 0; u < NSLICE; ++u)
#pragma unroll
                        for (int j = 0; j < 2; ++j) {
                            float cs, sn;
                            phasor(q[u][j].hi, q[u][j].hh, q[u][j].hl, q[u][j].lo,
                                   s_freq[wg][k], cs, sn);
                            term<ROT_NONE, ENV>(cs, sn, q[u][j].hi, q[u][j].a, ck,
                                                yr[u][j], yi[u][j]);
                        }
                    product(sb, h, k, yr, yi);
                }
            } else if (MODE == EXACT) {
                recur(Rot<ROT_NONE>(), sb, h, q);
            } else if (__all_sync(0xffffffffu, small)) {
                recur(Rot<ROT_SMALL>(), sb, h, q);
            } else {
                recur(Rot<ROT_FULL>(), sb, h, q);
            }
        }
    }

    if (!active) return;
    // D: d0, d1 at (row g, columns 2t, 2t+1), d2, d3 at (row g+8, ...); the
    // lane t ^ 2 holds the other halves of the same correlations
    const int ra = r0 + 16 * tile + gq, rb = ra + 8;
    // GAINS: the gain rows of rows ra and rb, read as the output is stored
    const float2 *g1a = nullptr, *g2a = nullptr, *g1b = nullptr, *g2b = nullptr;
    if constexpr (GAINS) {
        if (tq < 2 && ra < R) gain_rows<C>(gn, ra, F, 0, g1a, g2a);
        if (tq < 2 && rb < R) gain_rows<C>(gn, rb, F, 0, g1b, g2b);
    }
    // correlations 2 tq, 2 tq + 1 of a row and channel f, as (re, im, re, im)
    auto store = [&](size_t r, int f, float4 v, const float2* g1, const float2* g2) {
        if constexpr (GAINS) {
            if (g1 == nullptr) {
                const float2 n = nan2();
                v = make_float4(n.x, n.y, n.x, n.y);
            } else {
                const float4 x1 = __ldg(reinterpret_cast<const float4*>(g1 + f * C + 2 * tq));
                const float4 x2 = __ldg(reinterpret_cast<const float4*>(g2 + f * C + 2 * tq));
                const float2 c0 = sandwich(make_float2(x1.x, x1.y), make_float2(v.x, v.y),
                                           make_float2(x2.x, x2.y));
                const float2 c1 = sandwich(make_float2(x1.z, x1.w), make_float2(v.z, v.w),
                                           make_float2(x2.z, x2.w));
                v = make_float4(c0.x, c0.y, c1.x, c1.y);
            }
        }
        *reinterpret_cast<float4*>(out + (r * F + f) * C + 2 * tq) = v;
    };
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
        const int f = sl.chan(wg, k);
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = __shfl_xor_sync(0xffffffffu, acc[k][i], 2);
        if (f < 0 || tq >= 2) continue;
        if (ra < R) store(ra, f, make_float4(acc[k][0], x[0], acc[k][1], x[1]), g1a, g2a);
        if (rb < R) store(rb, f, make_float4(acc[k][2], x[2], acc[k][3], x[3]), g1b, g2b);
    }
}

template <int C, int MODE, bool ENV, bool GAINS>
void launch(PREDICT_ARGS, Gains gn, cudaStream_t stream) {
    const int ng = C == 4 ? MMA_GROUPS : GPB;
    const int gpb = min(ng, ngroups);
    const dim3 grid((R + LANES - 1) / LANES, (ngroups + gpb - 1) / gpb);
    if constexpr (C == 4)
        predict_kb_mma_kernel<MODE, ENV, GAINS><<<grid, 2 * LANES * gpb, 0, stream>>>(
            hi, lo, u1, v1, sf, b, ftab, rtab, gtab, cg, ngroups, delay_max,
            delay_small, out, S, R, F, gn);
    else
        predict_kb_kernel<C, MODE, ENV, GAINS><<<grid, LANES * gpb, 0, stream>>>(
            hi, lo, u1, v1, sf, b, ftab, rtab, gtab, cg, ngroups, delay_max,
            delay_small, out, S, R, F, gn);
}

template <int C, bool GAINS>
void dispatch_modes(int mode, PREDICT_ARGS, Gains gn, cudaStream_t stream) {
#define LAUNCH(M, E) launch<C, M, E, GAINS>(hi, lo, u1, v1, sf, b, ftab, rtab, gtab, \
                                            cg, ngroups, delay_max, delay_small, out, \
                                            S, R, F, gn, stream)
    const bool env = u1 != nullptr;
    if (mode == DIRECT) { if (env) LAUNCH(DIRECT, true); else LAUNCH(DIRECT, false); }
    else if (mode == EXACT) { if (env) LAUNCH(EXACT, true); else LAUNCH(EXACT, false); }
    else { if (env) LAUNCH(RESIDUAL, true); else LAUNCH(RESIDUAL, false); }
#undef LAUNCH
}

template <int C>
void dispatch(int mode, PREDICT_ARGS, Gains gn, cudaStream_t stream) {
    if (gn.g1 != nullptr)
        dispatch_modes<C, true>(mode, hi, lo, u1, v1, sf, b, ftab, rtab, gtab, cg,
                                ngroups, delay_max, delay_small, out, S, R, F, gn, stream);
    else
        dispatch_modes<C, false>(mode, hi, lo, u1, v1, sf, b, ftab, rtab, gtab, cg,
                                 ngroups, delay_max, delay_small, out, S, R, F, gn, stream);
}

// ------------------------------------------------------------ plain phase

constexpr int CHAN_BLOCK = 128;  // threads per block, one channel each
constexpr int ROWS = 8;          // rows per block, accumulated in registers
constexpr int PLAIN_SRC_TILE = 32;

template <int C, bool ENV>
__global__ void __launch_bounds__(CHAN_BLOCK)
predict_kb_plain_kernel(const float* __restrict__ dot,
                        const float* __restrict__ u1, const float* __restrict__ v1,
                        const float* __restrict__ freq, const float* __restrict__ sf,
                        const float2* __restrict__ b, float2* __restrict__ out,
                        int S, int R, int F) {
    __shared__ float s_dot[PLAIN_SRC_TILE][ROWS];
    __shared__ float2 s_uv[PLAIN_SRC_TILE][ROWS];

    const int r0 = blockIdx.x * ROWS;
    const int f = blockIdx.y * CHAN_BLOCK + threadIdx.x;
    const bool active = f < F;
    const float nu = active ? freq[f] : 0.0f;
    const float snu = (ENV && active) ? sf[f] : 0.0f;

    float acc_re[ROWS][C], acc_im[ROWS][C];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc_re[i][c] = acc_im[i][c] = 0.0f;

    for (int s0 = 0; s0 < S; s0 += PLAIN_SRC_TILE) {
        const int ns = min(PLAIN_SRC_TILE, S - s0);
        __syncthreads();  // the previous tile has been consumed
        for (int i = threadIdx.x; i < PLAIN_SRC_TILE * ROWS; i += CHAN_BLOCK) {
            const int ls = i / ROWS, lr = i % ROWS;
            const int r = r0 + lr;
            float d = 0.0f, u = 0.0f, v = 0.0f;
            if (ls < ns && r < R) {
                const size_t k = (size_t)(s0 + ls) * R + r;
                d = dot[k];
                if (ENV) {
                    u = u1[k];
                    v = v1[k];
                }
            }
            s_dot[ls][lr] = d;
            s_uv[ls][lr] = make_float2(u, v);
        }
        __syncthreads();
        if (!active) continue;

        for (int ls = 0; ls < ns; ++ls) {
            const float2* bp = b + ((size_t)(s0 + ls) * F + f) * C;
            float2 bv[C];
#pragma unroll
            for (int c = 0; c < C; ++c) bv[c] = bp[c];
#pragma unroll
            for (int lr = 0; lr < ROWS; ++lr) {
                float sn, cs;
                sincosf(__fmul_rn(s_dot[ls][lr], nu), &sn, &cs);
                if (ENV) {
                    const float2 uv = s_uv[ls][lr];
                    const float fu = uv.x * snu;
                    const float fv = uv.y * snu;
                    const float env = expf(-(fu * fu + fv * fv));
                    sn *= env;
                    cs *= env;
                }
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    acc_re[lr][c] += cs * bv[c].x - sn * bv[c].y;
                    acc_im[lr][c] += cs * bv[c].y + sn * bv[c].x;
                }
            }
        }
    }

    if (!active) return;
#pragma unroll
    for (int lr = 0; lr < ROWS; ++lr) {
        const int r = r0 + lr;
        if (r >= R) break;
        float2* op = out + ((size_t)r * F + f) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) op[c] = make_float2(acc_re[lr][c], acc_im[lr][c]);
    }
}

template <int C>
void plain(const float* dot, const float* u1, const float* v1, const float* freq,
           const float* sf, const float2* b, float2* out, int S, int R, int F,
           cudaStream_t stream) {
    const dim3 grid((R + ROWS - 1) / ROWS, (F + CHAN_BLOCK - 1) / CHAN_BLOCK);
    if (u1 != nullptr)
        predict_kb_plain_kernel<C, true><<<grid, CHAN_BLOCK, 0, stream>>>(
            dot, u1, v1, freq, sf, b, out, S, R, F);
    else
        predict_kb_plain_kernel<C, false><<<grid, CHAN_BLOCK, 0, stream>>>(
            dot, u1, v1, freq, sf, b, out, S, R, F);
}

}  // namespace

// Compensated phase. hi, lo, u1, v1: (S, R) float32 (u1 == v1 == NULL for
// point sources). sf: (F,) float32. b: (S, F, C) complex64, out: (R, F, C)
// complex64, both interleaved re/im. The plan (ops/cuda_predict.py): ftab
// (F, 4) float32 channel frequencies as two-float [nu, hh, hl, lo]; rtab
// (F,) 2*pi*delta_f (RESIDUAL); gtab (ngroups, 2, 4) each group's base and
// the grid's step as [nu, hh, hl, lo]; cg channels in each of ngroups
// groups (cg <= 16; cg * ngroups == F, or in the DIRECT mode the last
// group ragged); mode 0 direct, 1 exact, 2 residual; delay_max (s) and
// delay_small (s, the bound of the first-order rotation). The DIE gains,
// all NULL for none: time_index, antenna1, antenna2 (R,) int64, the dump
// less the chunk's first; g1, g2 (T, A, F, C) complex64, 16-byte aligned
// at C = 4, possibly one table. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int predict_kb_launch(const float* hi, const float* lo,
                                 const float* u1, const float* v1,
                                 const float* sf, const void* b,
                                 const float* ftab, const float* rtab,
                                 const float* gtab, int cg, int ngroups,
                                 int mode, float delay_max, float delay_small,
                                 void* out, int S, int R, int F, int C,
                                 const long long* time_index,
                                 const long long* antenna1,
                                 const long long* antenna2, const void* g1,
                                 const void* g2, int T, int A, void* stream) {
    if (R <= 0 || F <= 0) return (int)cudaSuccess;
    const bool gains = g1 != nullptr;
    if (mode < DIRECT || mode > RESIDUAL || cg < 1 || cg > SLOTS ||
        (mode == DIRECT ? (cg * ngroups < F || cg * (ngroups - 1) >= F)
                        : cg * ngroups != F) ||
        gains != (g2 != nullptr) || gains != (time_index != nullptr) ||
        gains != (antenna1 != nullptr) || gains != (antenna2 != nullptr) ||
        (gains && (T < 1 || A < 1)))
        return (int)cudaErrorInvalidValue;
    const Gains gn = {time_index, antenna1, antenna2, static_cast<const float2*>(g1),
                      static_cast<const float2*>(g2), T, A};
    const float2* bb = static_cast<const float2*>(b);
    const float4* ft = reinterpret_cast<const float4*>(ftab);
    const float4* gt = reinterpret_cast<const float4*>(gtab);
    float2* oo = static_cast<float2*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: dispatch<1>(mode, hi, lo, u1, v1, sf, bb, ft, rtab, gt, cg, ngroups, delay_max, delay_small, oo, S, R, F, gn, st); break;
        case 2: dispatch<2>(mode, hi, lo, u1, v1, sf, bb, ft, rtab, gt, cg, ngroups, delay_max, delay_small, oo, S, R, F, gn, st); break;
        case 4: dispatch<4>(mode, hi, lo, u1, v1, sf, bb, ft, rtab, gt, cg, ngroups, delay_max, delay_small, oo, S, R, F, gn, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Plain phase: dot (S, R) float32 in radians per Hz; u1, v1, sf, b and out
// as above; freq (F,) float32.
extern "C" int predict_kb_plain_launch(const float* dot, const float* u1,
                                       const float* v1, const float* freq,
                                       const float* sf, const void* b,
                                       void* out, int S, int R, int F, int C,
                                       void* stream) {
    if (R <= 0 || F <= 0) return (int)cudaSuccess;
    const float2* bb = static_cast<const float2*>(b);
    float2* oo = static_cast<float2*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: plain<1>(dot, u1, v1, freq, sf, bb, oo, S, R, F, st); break;
        case 2: plain<2>(dot, u1, v1, freq, sf, bb, oo, S, R, F, st); break;
        case 4: plain<4>(dot, u1, v1, freq, sf, bb, oo, S, R, F, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
