// Direct Fourier transforms between sources/pixels and visibilities, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   forward:  V[r,f,c] = sum_s exp(2*pi*i*delay(s,r)*nu_f) * I[s,f,c]
//   adjoint:  I[p,f,c] = sum_r Re(exp(2*pi*i*delay(p,r)*nu_f) * V[r,f,c])
//
// delay(s,r) = sign*(u*l + v*m + w*(n-1))/c in seconds, a two-float
// (hi, lo) pair computed here, per (source or pixel, row), by the same
// error-free chain as africanus_tpu_torch/rime/phase.py:phase_dot_cycles
// (bitwise: every op is one rounded f32 op in the same order). The phase
// is then 2*pi*frac(delay*nu), reduced mod one cycle at ~48-bit precision.
//
// Replaces the two Pallas TPU kernels of africanus_tpu/ops/pallas_dft.py:
//   dft_forward_pallas / _dft_fwd_kernel (rows on lanes, sources
//     contracted on sublanes), and
//   dft_adjoint_pallas / _dft_adj_kernel (pixels on lanes, rows
//     contracted on sublanes, output revisited over the row grid axis).
// Both are kept as maps, not as schedules: no lane/sublane tiles, no
// 8-row chunks, no padding to 128, and not the JAX package's channel
// groups either (cg*C <= 8 and <= 4 there).
//
// What bounds them on an H100: FP32 instruction issue. The map needs per
// (pixel or source, row, channel) term 4 instructions to advance a phasor
// and 2*C (adjoint) or 4*C (forward) to multiply-accumulate. Around that,
// every (pixel or source, row) pair needs its two-float delay and two
// phasor evaluations (a two-float phase and a sincospif each), for the
// base and the step of the recurrence: ~130 instructions. The host
// (ops/cuda_dft.py, DftPlan) plans the channels in groups of cg <= 16
// (cg*C <= 32: the thread's accumulators, or its complex pairs) in one of
// three modes:
//   DIRECT    one two-float phase and one sincospif per channel;
//   EXACT     the phasor at the group's middle channel, then a unit-phasor
//             recurrence by the grid's step up the group's channels and by
//             its conjugate down them (at most cg/2 steps of drift);
//   RESIDUAL  EXACT plus a rotation by x = 2*pi*delay*delta_f per channel
//             (delta_f: the channel's offset from the fitted even grid,
//             e.g. the rounding of a float32 linspace): 1 + i*x where
//             x^2/2 <= 8e-8 (|delay| <= the plan's delay_small; a warp
//             takes it by vote over its pairs), else the 6th-order
//             small-angle polynomial, which holds to |x| <= 0.35 rad (the
//             plan engages the mode only there).
// The plan's delay bound (delay_max) only chooses the mode: it is measured
// on the uvw the plan was made from, and a call may bring longer
// baselines. A pair beyond it (delay_far: delay_max and a slack for its
// float32 measurement) is exact: in the EXACT and RESIDUAL modes a warp
// votes on its pairs, and if any is that far the whole warp takes the
// pair's DIRECT phase at every slot's channel, from the [nu, hh, hl, lo]
// rows the block stages in every mode (the DIRECT table: no more shared
// memory, and no channel map or table pointer in registers, which
// spilled). In the pair loop the vote cost ~5% where no pair is far, so a
// warp takes the loop with the vote only on a tile of rows (sources) where
// a pair may be far, by a bound on |delay| from the warp's largest |l|,
// |m|, |n-1| (forward: |u|, |v|, |w|) and a row's |u|, |v|, |w| (a
// source's |l|, |m|, |n-1|); in that loop the RESIDUAL mode's near pairs
// take the polynomial (two votes in one loop spilled at C = 4). The second
// loop, even unrun, changes the first's schedule (~3.5% of the adjoint at
// config 5, ~5% of the forward): the adjoint gets it back by taking two
// rows at a time at C = 1, the forward does not (tools/dft_variants.py).
// At the config-5 residual image (4096 pixels x 38612 rows x 16 channels,
// C = 1, one group, every pair on the first-order rotation) the compiled
// loop is ~130 instructions a pair and ~10 a channel, ~18 a term against
// the map's 6; tools/dft_variants.py times what each stage costs.
//
// What the design does about it:
//  - the delay is computed in the kernel from l, m, n-1 and uvw, so the
//    (pixel, row) delay planes (632 MB each at config 5) never exist;
//  - a block is 4 warps, a lane a pixel (adjoint) or a row (forward), a
//    warp one channel group of the block's gpb <= 4 (every thread walks
//    the group's slots; a slot past its channels is zero padding);
//  - a pair's delay and step phasor are computed once for all of the
//    block's groups: with one group, by the thread that uses them; with
//    more (gpb 2 or 4), by the block into shared memory (STAGE), each
//    thread its own lane's share;
//  - the channel tables and the staged visibilities or image are read from
//    shared memory as broadcasts, never held in registers;
//  - adjoint: a block is 128 / gpb pixels, and stages tiles of rows
//    (geometry and V of its groups). The grid is (pixel tile, group
//    block, row chunk), the chunks chosen from the shapes so that the
//    grid holds ~4096 blocks, many waves of the 6 blocks an SM holds at
//    its 80 registers a thread; chunks write partial images and a second
//    kernel sums them in chunk order: deterministic, no atomics;
//  - forward: a block is 32 rows; with gpb < 4 its 4 / gpb warps a group
//    take slices of the sources (source s to slice s mod 4 / gpb; at
//    config 5 the 20 sources in one staged tile, 5 a warp), and at the
//    end the slices are summed in slice order through shared memory, from
//    where the block writes its rows coalesced. Every output is owned by
//    one block: no cross-block reduction, reruns bitwise equal.
//
// Rounding hazards handled here (as in predict_kb.cu): the error-free
// chains are written with __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never
// contracts into FMAs or reorders, and each product's error is taken by
// one explicit __fmaf_rn(a, b, -a*b): exact, so equal to the Dekker
// split-and-multiply of phase_dot_cycles (tests/test_torch_dft_plan.py
// emulates the chain against it bit for bit) at a seventh of its
// operations, and no per-pixel, per-row or per-pair splits; rintf rounds
// half to even like torch.round; no --use_fast_math. The rotation, the
// recurrence and the accumulation are left to the compiler (fmaf), where
// an FMA only helps.

#include <cuda_runtime.h>

namespace {

constexpr int DIRECT = 0, EXACT = 1, RESIDUAL = 2;
constexpr int ROT_NONE = 0, ROT_SMALL = 1, ROT_FULL = 2;
constexpr int LANES = 32;
constexpr int WARPS = 4;                 // warps a block
constexpr int THREADS = LANES * WARPS;
// blocks an SM each kernel asks for: <= 80 registers a thread (adjoint;
// its 32 accumulators at C = 2, 4 spill a few bytes at most) and <= 128
// (forward, 64 at C = 2, 4); tools/dft_variants.py times the others
constexpr int ADJ_MIN_BLOCKS = 6;
constexpr int FWD_MIN_BLOCKS = 4;
constexpr int ADJ_ROWS = 32;             // adjoint: rows staged a pass, one group a block
constexpr int ADJ_ROWS_STAGED = 16;      // ... with the pairs staged (gpb 2, 4)
constexpr int FWD_SRCS = 16;             // forward: sources staged a pass (twice
                                         // as many with one group a block)
constexpr unsigned FULL_MASK = 0xffffffffu;

// channel slots a thread: cg*C <= 32 (ops/cuda_dft.py's _slots)
template <int C>
__host__ __device__ constexpr int slots() { return C == 4 ? 8 : 16; }

// the error of the rounded product p = a*b: exact (TwoProductFMA), so
// equal to Dekker's split-and-multiply of phase_dot_cycles
__device__ __forceinline__ float prod_err(float p, float a, float b) {
    return __fmaf_rn(a, b, -p);
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
    s = __fadd_rn(a, b);
    const float v = __fsub_rn(s, a);
    e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
    s = __fadd_rn(a, b);
    e = __fsub_rn(b, __fsub_rn(s, a));
}

// Per source or pixel: l, m and n-1 as a two-float (nh, nl).
struct Dir {
    float l, m, nh, nl;
};

__device__ __forceinline__ float3 make_row(const float* uvw, int r) {
    return make_float3(uvw[3 * (size_t)r], uvw[3 * (size_t)r + 1],
                       uvw[3 * (size_t)r + 2]);
}

// phase_dot_cycles for one (direction, row), its operations in its order:
//   df_mul(df_add(df_add(l*u, m*v), (n-1)*(w, 0)), (chi, clo))
// ((nh + nl)*(w + 0) drops nh*0, which adds nothing but a zero's sign)
__device__ __forceinline__ void delay(const Dir& d, float3 q, float chi, float clo,
                                      float& hi, float& lo) {
    const float p1 = __fmul_rn(d.l, q.x);
    const float e1 = prod_err(p1, d.l, q.x);
    const float p2 = __fmul_rn(d.m, q.y);
    const float e2 = prod_err(p2, d.m, q.y);
    float s, e, ah, al;
    two_sum(p1, p2, s, e);
    quick_two_sum(s, __fadd_rn(__fadd_rn(e, e1), e2), ah, al);

    const float p3 = __fmul_rn(d.nh, q.z);
    const float e3 = prod_err(p3, d.nh, q.z);
    float bh, bl;
    quick_two_sum(p3, __fadd_rn(e3, __fmul_rn(d.nl, q.z)), bh, bl);

    float mh_, ml_;
    two_sum(ah, bh, s, e);
    quick_two_sum(s, __fadd_rn(__fadd_rn(e, al), bl), mh_, ml_);

    const float p = __fmul_rn(mh_, chi);
    const float ep = prod_err(p, mh_, chi);
    const float x = __fadd_rn(__fmul_rn(mh_, clo), __fmul_rn(ml_, chi));
    quick_two_sum(p, __fadd_rn(ep, x), hi, lo);
}

// (cos, sin) of 2*pi*frac((hi + lo) * (f.x + f.w)), f = [nu, hh, hl, lo]
// a two-float frequency (its Dekker split f.y, f.z is the plain
// version's)
__device__ __forceinline__ float2 phasor(float hi, float lo, float4 f) {
    const float p = __fmul_rn(hi, f.x);
    float e = prod_err(p, hi, f.x);
    e = __fadd_rn(e, __fmul_rn(lo, f.x));
    e = __fadd_rn(e, __fmul_rn(hi, f.w));
    // p - rint(p) is exact (Sterbenz); frac in [-0.5, 0.5] (+ tiny)
    const float frac = __fadd_rn(__fsub_rn(p, rintf(p)), e);
    float2 z;
    sincospif(2.0f * frac, &z.y, &z.x);  // 2*frac is exact
    return z;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * conj(b)
__device__ __forceinline__ float2 cmul_conj(float2 a, float2 b) {
    return make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y);
}

// z rotated by x radians: not at all, to first order, or by the
// 6th-order polynomial (|x| <= 0.35, host-checked)
template <int ROT>
__device__ __forceinline__ float2 turn(float2 z, float x) {
    if (ROT == ROT_SMALL) return make_float2(z.x - z.y * x, z.y + z.x * x);
    if (ROT == ROT_FULL) {
        const float x2 = x * x;
        const float c = 1.0f - x2 * (0.5f - x2 * ((1.0f / 24.0f) - x2 * (1.0f / 720.0f)));
        const float s = x * (1.0f - x2 * ((1.0f / 6.0f) - x2 * (1.0f / 120.0f)));
        return make_float2(z.x * c - z.y * s, z.y * c + z.x * s);
    }
    return z;
}

// Calls body(k, y) for every slot k < CG: y the phasor of slot k, by the
// recurrence from z at slot CG/2 (the group's middle channel) up by the
// step s and down by its conjugate, rotated by x = hi*rot[k].
template <int CG, int ROT, typename Body>
__device__ __forceinline__ void walk(float2 z, float2 s, float hi,
                                     const float* rot, Body body) {
    constexpr int M = CG / 2;
    float2 up = z, down = z;
#pragma unroll
    for (int j = 0; j < CG - M; ++j) {
        if (j > 0) up = cmul(up, s);
        body(M + j, turn<ROT>(up, hi * rot[M + j]));
    }
#pragma unroll
    for (int j = 1; j <= M; ++j) {
        down = cmul_conj(down, s);
        body(M - j, turn<ROT>(down, hi * rot[M - j]));
    }
}

// The channels of a launch's slots. Group g's slot k is channel
// g*cg + k - off, where off = CG/2 - cg/2 puts the group's middle channel
// (the base of the recurrence) at slot CG/2; DIRECT groups start at slot
// 0, the last one ragged. -1: padding.
template <int CG>
struct Slots {
    int cg, ngroups, off, F;

    __device__ __forceinline__ Slots(int mode, int cg_, int ngroups_, int F_)
        : cg(cg_), ngroups(ngroups_), off(mode == DIRECT ? 0 : CG / 2 - cg_ / 2), F(F_) {}

    __device__ __forceinline__ int chan(int g, int k) const {
        const int j = k - off, f = g * cg + j;
        return (g < ngroups && j >= 0 && j < cg && f < F) ? f : -1;
    }
};

// the block's channel tables: [nu, hh, hl, lo] (DIRECT, and the far pairs
// of EXACT and RESIDUAL) and 2*pi*delta_f (RESIDUAL) of each of its gpb
// groups' slots, zero in padding
template <int CG, int MODE>
__device__ __forceinline__ void stage_tables(const Slots<CG>& sl, int g0, int gpb,
                                             const float4* __restrict__ ftab,
                                             const float* __restrict__ rtab,
                                             float4 (*s_freq)[CG], float (*s_rot)[CG]) {
    for (int i = threadIdx.x; i < gpb * CG; i += THREADS) {
        const int s = i / CG, k = i % CG, f = sl.chan(g0 + s, k);
        s_freq[s][k] = f >= 0 ? ftab[f] : make_float4(0, 0, 0, 0);
        if (MODE == RESIDUAL) s_rot[s][k] = f >= 0 ? rtab[f] : 0.0f;
    }
}

// a tile of the loop with (true) or without the far-pair vote
template <bool B>
struct Far {
    static constexpr bool value = B;
};

// the largest |x| over the warp (non-negative floats order as their bits)
__device__ __forceinline__ float warp_max_abs(float x) {
    return __uint_as_float(__reduce_max_sync(FULL_MASK, __float_as_uint(fabsf(x))));
}

// whether a pair of a warp and a row (or source) may lie beyond delay_far:
// a is the warp's largest |l|, |m|, |n-1| (or |u|, |v|, |w|), b the row's
// (source's) other three, c = |sign/c|; the margin covers the float32
// rounding of the bound
__device__ __forceinline__ bool may_be_far(float3 a, float3 b, float c,
                                           float delay_far) {
    const float bound = (a.x * fabsf(b.x) + a.y * fabsf(b.y) + a.z * fabsf(b.z)) * c;
    return bound * 1.00001f > delay_far;
}

// Calls body(k, y) for every slot k of a group, y the phasor of the pair
// with delay (hi, lo) and step phasor st (EXACT, RESIDUAL) at that slot's
// channel: freq and rot are the group's staged tables, base its middle
// channel's frequency. With FAR, a warp with a pair beyond delay_far takes
// the direct phase (a padding slot's frequency is zero, and so are its
// staged values), and the RESIDUAL mode's near pairs the polynomial
// rotation without the first-order vote (the two votes in one loop
// spilled at C = 4).
template <int CG, int MODE, bool FAR, typename Body>
__device__ __forceinline__ void channels(float hi, float lo, float2 st, float4 base,
                                         const float4* freq, const float* rot,
                                         float delay_small, float delay_far, Body body) {
    if (MODE == DIRECT || (FAR && __any_sync(FULL_MASK, fabsf(hi) > delay_far))) {
#pragma unroll
        for (int k = 0; k < CG; ++k) body(k, phasor(hi, lo, freq[k]));
        return;
    }
    const float2 z = phasor(hi, lo, base);
    if (MODE == EXACT)
        walk<CG, ROT_NONE>(z, st, hi, rot, body);
    else if (!FAR && __all_sync(FULL_MASK, fabsf(hi) <= delay_small))
        walk<CG, ROT_SMALL>(z, st, hi, rot, body);
    else
        walk<CG, ROT_FULL>(z, st, hi, rot, body);
}

// ---------------------------------------------------------------- adjoint

template <int C, int MODE, bool STAGE>
__global__ void __launch_bounds__(THREADS, ADJ_MIN_BLOCKS)
dft_adjoint_kernel(const float* __restrict__ l, const float* __restrict__ m,
                   const float* __restrict__ n1h, const float* __restrict__ n1l,
                   const float* __restrict__ uvw, const float2* __restrict__ vis,
                   const float4* __restrict__ ftab, const float* __restrict__ rtab,
                   const float4* __restrict__ gtab, int cg, int ngroups, int gpb,
                   float chi, float clo, float delay_small, float delay_far,
                   float* __restrict__ partial, int P, int R, int F,
                   int rows_per_chunk) {
    constexpr int CG = slots<C>();
    constexpr int ROWS = STAGE ? ADJ_ROWS_STAGED : ADJ_ROWS;
    constexpr int GPB = STAGE ? WARPS : 1;  // the most groups a block
    constexpr int NV = GPB * CG * C;        // V's float2 a staged row
    __shared__ float3 s_row[ROWS];
    __shared__ __align__(16) float2 s_vis[ROWS][NV];
    // STAGE: (hi, lo, step phasor) of each (row, pixel of the block)
    __shared__ float4 s_pair[STAGE ? ROWS : 1][STAGE ? THREADS / 2 : 1];
    __shared__ float4 s_freq[GPB][CG];
    __shared__ float s_rot[GPB][CG];

    const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
    const int gs = w % gpb;                      // the warp's group slot
    const int pb = (w / gpb) * LANES + lane;     // the thread's pixel in the block
    const int p = blockIdx.x * (THREADS / gpb) + pb;
    const int g0 = blockIdx.y * gpb, g = g0 + gs;
    const bool active = g < ngroups;             // per warp; pixels past P are dropped
    const int chunk = blockIdx.z;
    const int r_begin = chunk * rows_per_chunk;
    const int r_end = min(R, r_begin + rows_per_chunk);
    const Slots<CG> sl(MODE, cg, ngroups, F);

    stage_tables<CG, MODE>(sl, g0, gpb, ftab, rtab, s_freq, s_rot);
    const Dir d = p < P ? Dir{l[p], m[p], n1h[p], n1l[p]} : Dir{0.0f, 0.0f, 0.0f, 0.0f};
    const float4 base = MODE != DIRECT && active ? gtab[2 * g] : make_float4(0, 0, 0, 0);
    const float4 step = MODE != DIRECT ? gtab[1] : make_float4(0, 0, 0, 0);

    float acc[CG][C];
#pragma unroll
    for (int k = 0; k < CG; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[k][c] = 0.0f;

    // the pair (this thread's pixel, row lr of the tile)
    auto pair = [&](int lr, float& hi, float& lo, float2& st) {
        delay(d, s_row[lr], chi, clo, hi, lo);
        st = MODE != DIRECT ? phasor(hi, lo, step) : make_float2(1.0f, 0.0f);
    };

    for (int r0 = r_begin; r0 < r_end; r0 += ROWS) {
        const int nr = min(ROWS, r_end - r0);
        __syncthreads();  // the previous tile has been consumed
        if (threadIdx.x < nr) s_row[threadIdx.x] = make_row(uvw, r0 + threadIdx.x);
        for (int i = threadIdx.x; i < nr * gpb * CG * C; i += THREADS) {
            const int lr = i / (gpb * CG * C), j = i % (gpb * CG * C);
            const int f = sl.chan(g0 + j / (CG * C), (j / C) % CG);
            s_vis[lr][j] = f >= 0 ? vis[((size_t)(r0 + lr) * F + f) * C + j % C]
                                  : make_float2(0.0f, 0.0f);
        }
        __syncthreads();
        if (STAGE) {
            // the thread's pixel, rows gs, gs + gpb, ...: each pair once
            for (int lr = gs; lr < nr; lr += gpb) {
                float hi, lo;
                float2 st;
                pair(lr, hi, lo, st);
                s_pair[lr][pb] = make_float4(hi, lo, st.x, st.y);
            }
            __syncthreads();
        }
        if (!active) continue;

        auto rows = [&](auto far) {
            // two rows at a time on the route without the vote at C = 1,
            // where its registers allow it (tools/dft_variants.py)
#pragma unroll ((C == 1 && !decltype(far)::value) ? 2 : 1)
            for (int lr = 0; lr < nr; ++lr) {
                float hi, lo;
                float2 st;
                if (STAGE) {
                    const float4 q = s_pair[lr][pb];
                    hi = q.x;
                    lo = q.y;
                    st = make_float2(q.z, q.w);
                } else {
                    pair(lr, hi, lo, st);
                }
                const float2* v = s_vis[lr] + gs * CG * C;
                channels<CG, MODE, decltype(far)::value>(
                    hi, lo, st, base, s_freq[gs], s_rot[gs], delay_small, delay_far,
                    [&](int k, float2 y) {
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const float2 b = v[k * C + c];
                        acc[k][c] = fmaf(-y.y, b.y, fmaf(y.x, b.x, acc[k][c]));
                    }
                });
            }
        };
        if constexpr (MODE == DIRECT) {
            rows(Far<false>());
        } else {
            // the far-pair vote only where a pair of the warp may need it:
            // the warp's pixels' largest |l|, |m|, |n-1| (made again a tile,
            // so that no register holds them through the loop)
            const float3 dmax = make_float3(warp_max_abs(d.l), warp_max_abs(d.m),
                                            warp_max_abs(d.nh));
            bool far_rows = false;
            for (int i = lane; i < nr; i += LANES)
                far_rows |= may_be_far(dmax, s_row[i], fabsf(chi), delay_far);
            if (__any_sync(FULL_MASK, far_rows))
                rows(Far<true>());
            else
                rows(Far<false>());
        }
    }

    if (!active || p >= P) return;
    // partial: (chunk, F, C, P), pixels fastest
#pragma unroll
    for (int k = 0; k < CG; ++k) {
        const int f = sl.chan(g, k);
        if (f < 0) continue;
#pragma unroll
        for (int c = 0; c < C; ++c)
            partial[(((size_t)chunk * F + f) * C + c) * P + p] = acc[k][c];
    }
}

// out[p, k] = sum over chunks, in chunk order, of partial[chunk, k, p]
// (k = f*C + c): deterministic.
__global__ void dft_adjoint_sum(const float* __restrict__ partial,
                                float* __restrict__ out, int P, int FC,
                                int nchunks) {
    const size_t n = (size_t)FC * P;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.0f;
#pragma unroll 8
    for (int k = 0; k < nchunks; ++k) s += partial[(size_t)k * n + i];
    const size_t fc = i / P, p = i % P;
    out[p * FC + fc] = s;
}

template <int C, int MODE, bool STAGE>
void adjoint(const float* l, const float* m, const float* n1h, const float* n1l,
             const float* uvw, const float2* vis, const float4* ftab,
             const float* rtab, const float4* gtab, int cg, int ngroups, int gpb,
             float chi, float clo, float delay_small, float delay_far,
             float* partial, int P, int R, int F, int rows_per_chunk, int nchunks,
             cudaStream_t stream) {
    const int pix = THREADS / gpb;
    const dim3 grid((P + pix - 1) / pix, (ngroups + gpb - 1) / gpb, nchunks);
    dft_adjoint_kernel<C, MODE, STAGE><<<grid, THREADS, 0, stream>>>(
        l, m, n1h, n1l, uvw, vis, ftab, rtab, gtab, cg, ngroups, gpb, chi, clo,
        delay_small, delay_far, partial, P, R, F, rows_per_chunk);
}

template <int C>
void adjoint_mode(int mode, const float* l, const float* m, const float* n1h,
                  const float* n1l, const float* uvw, const float2* vis,
                  const float4* ftab, const float* rtab, const float4* gtab,
                  int cg, int ngroups, int gpb, float chi, float clo,
                  float delay_small, float delay_far, float* partial, int P,
                  int R, int F, int rows_per_chunk, int nchunks,
                  cudaStream_t stream) {
#define ADJ(M, S) adjoint<C, M, S>(l, m, n1h, n1l, uvw, vis, ftab, rtab, gtab, cg, \
                                   ngroups, gpb, chi, clo, delay_small,           \
                                   delay_far, partial, P, R, F, rows_per_chunk,   \
                                   nchunks, stream)
    const bool staged = gpb > 1;
    if (mode == DIRECT) { if (staged) ADJ(DIRECT, true); else ADJ(DIRECT, false); }
    else if (mode == EXACT) { if (staged) ADJ(EXACT, true); else ADJ(EXACT, false); }
    else { if (staged) ADJ(RESIDUAL, true); else ADJ(RESIDUAL, false); }
#undef ADJ
}

// ---------------------------------------------------------------- forward

template <int C, bool STAGE>
struct FwdShared {
    static constexpr int CG = slots<C>();
    static constexpr int GPB = STAGE ? WARPS : 1;
    static constexpr int SRCS = STAGE ? FWD_SRCS : 2 * FWD_SRCS;
    struct Tile {
        Dir dir[SRCS];
        float2 img[SRCS][GPB * CG * C];
        float4 pair[STAGE ? SRCS : 1][LANES];  // (hi, lo, step phasor)
    };
    // the accumulators of every warp at the end, a lane's padded by one
    static constexpr int RED = WARPS * LANES * (CG * C + 1);
    static constexpr size_t BYTES =
        sizeof(Tile) > RED * sizeof(float2) ? sizeof(Tile) : RED * sizeof(float2);
};

template <int C, int MODE, bool IMAG, bool STAGE>
__global__ void __launch_bounds__(THREADS, FWD_MIN_BLOCKS)
dft_forward_kernel(const float* __restrict__ l, const float* __restrict__ m,
                   const float* __restrict__ n1h, const float* __restrict__ n1l,
                   const float* __restrict__ uvw, const float* __restrict__ image,
                   const float4* __restrict__ ftab, const float* __restrict__ rtab,
                   const float4* __restrict__ gtab, int cg, int ngroups, int gpb,
                   float chi, float clo, float delay_small, float delay_far,
                   float2* __restrict__ out, int S, int R, int F) {
    using Sh = FwdShared<C, STAGE>;
    constexpr int CG = Sh::CG;
    constexpr int GPB = Sh::GPB;
    __shared__ __align__(16) unsigned char smem[Sh::BYTES];
    __shared__ float4 s_freq[GPB][CG];
    __shared__ float s_rot[GPB][CG];
    auto& tile = *reinterpret_cast<typename Sh::Tile*>(smem);

    const int lane = threadIdx.x % LANES, w = threadIdx.x / LANES;
    const int gs = w % gpb, slice = w / gpb, nslice = WARPS / gpb;
    const int r = blockIdx.x * LANES + lane;
    const int g0 = blockIdx.y * gpb, g = g0 + gs;
    const bool active = g < ngroups;  // per warp; rows past R are dropped
    const Slots<CG> sl(MODE, cg, ngroups, F);

    stage_tables<CG, MODE>(sl, g0, gpb, ftab, rtab, s_freq, s_rot);
    const float3 q = make_row(uvw, min(r, R - 1));
    const float4 base = MODE != DIRECT && active ? gtab[2 * g] : make_float4(0, 0, 0, 0);
    const float4 step = MODE != DIRECT ? gtab[1] : make_float4(0, 0, 0, 0);

    float acc_re[CG][C], acc_im[CG][C];
#pragma unroll
    for (int k = 0; k < CG; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c) acc_re[k][c] = acc_im[k][c] = 0.0f;

    // the pair (source ls of the tile, this thread's row)
    auto pair = [&](int ls, float& hi, float& lo, float2& st) {
        delay(tile.dir[ls], q, chi, clo, hi, lo);
        st = MODE != DIRECT ? phasor(hi, lo, step) : make_float2(1.0f, 0.0f);
    };

    const int nk = gpb * CG * C;
    for (int s0 = 0; s0 < S; s0 += Sh::SRCS) {
        const int ns = min(Sh::SRCS, S - s0);
        __syncthreads();  // the previous tile has been consumed
        if (threadIdx.x < ns) {
            const int s = s0 + threadIdx.x;
            tile.dir[threadIdx.x] = Dir{l[s], m[s], n1h[s], n1l[s]};
        }
        for (int i = threadIdx.x; i < ns * nk; i += THREADS) {
            const int ls = i / nk, j = i % nk;
            const int f = sl.chan(g0 + j / (CG * C), (j / C) % CG);
            const size_t at = ((size_t)(s0 + ls) * F + f) * C + j % C;
            tile.img[ls][j] = f < 0 ? make_float2(0.0f, 0.0f)
                            : IMAG ? reinterpret_cast<const float2*>(image)[at]
                                   : make_float2(image[at], 0.0f);
        }
        __syncthreads();
        if (STAGE) {
            // the thread's row, sources w, w + WARPS, ...: each pair once
            for (int ls = w; ls < ns; ls += WARPS) {
                float hi, lo;
                float2 st;
                pair(ls, hi, lo, st);
                tile.pair[ls][lane] = make_float4(hi, lo, st.x, st.y);
            }
            __syncthreads();
        }
        if (!active) continue;

        auto sources = [&](auto far) {
            for (int ls = slice; ls < ns; ls += nslice) {
                float hi, lo;
                float2 st;
                if (STAGE) {
                    const float4 pq = tile.pair[ls][lane];
                    hi = pq.x;
                    lo = pq.y;
                    st = make_float2(pq.z, pq.w);
                } else {
                    pair(ls, hi, lo, st);
                }
                const float2* v = tile.img[ls] + gs * CG * C;
                channels<CG, MODE, decltype(far)::value>(
                    hi, lo, st, base, s_freq[gs], s_rot[gs], delay_small, delay_far,
                    [&](int k, float2 y) {
#pragma unroll
                    for (int c = 0; c < C; ++c) {
                        const float2 b = v[k * C + c];
                        acc_re[k][c] = fmaf(y.x, b.x, acc_re[k][c]);
                        acc_im[k][c] = fmaf(y.y, b.x, acc_im[k][c]);
                        if (IMAG) {
                            acc_re[k][c] = fmaf(-y.y, b.y, acc_re[k][c]);
                            acc_im[k][c] = fmaf(y.x, b.y, acc_im[k][c]);
                        }
                    }
                });
            }
        };
        if constexpr (MODE == DIRECT) {
            sources(Far<false>());
        } else {
            // the far-pair vote only where a pair of the warp may need it:
            // the warp's rows' largest |u|, |v|, |w| (made again a tile)
            const float3 qmax = make_float3(warp_max_abs(q.x), warp_max_abs(q.y),
                                            warp_max_abs(q.z));
            bool far_sources = false;
            for (int i = lane; i < ns; i += LANES)
                far_sources |= may_be_far(qmax, make_float3(tile.dir[i].l, tile.dir[i].m,
                                                            tile.dir[i].nh),
                                          fabsf(chi), delay_far);
            if (__any_sync(FULL_MASK, far_sources))
                sources(Far<true>());
            else
                sources(Far<false>());
        }
    }

    // each warp's sums to shared memory; then out[r, f, c] = the sum of
    // its group's slices in slice order, written coalesced
    constexpr int KC = CG * C;
    float2* red = reinterpret_cast<float2*>(smem);  // [warp][lane][KC + 1]
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CG; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c)
            red[(w * LANES + lane) * (KC + 1) + k * C + c] =
                make_float2(acc_re[k][c], acc_im[k][c]);
    __syncthreads();
    for (int i = threadIdx.x; i < LANES * nk; i += THREADS) {
        const int lr = i / nk, j = i % nk, s = j / KC, kc = j % KC;
        const int rr = blockIdx.x * LANES + lr, f = sl.chan(g0 + s, kc / C);
        if (rr >= R || f < 0) continue;
        float2 sum = red[(s * LANES + lr) * (KC + 1) + kc];
        for (int t = 1; t < nslice; ++t) {
            const float2 x = red[((t * gpb + s) * LANES + lr) * (KC + 1) + kc];
            sum.x += x.x;
            sum.y += x.y;
        }
        out[((size_t)rr * F + f) * C + kc % C] = sum;
    }
}

template <int C, int MODE, bool STAGE>
void forward(bool imag, const float* l, const float* m, const float* n1h,
             const float* n1l, const float* uvw, const float* image,
             const float4* ftab, const float* rtab, const float4* gtab, int cg,
             int ngroups, int gpb, float chi, float clo, float delay_small,
             float delay_far, float2* out, int S, int R, int F,
             cudaStream_t stream) {
    const dim3 grid((R + LANES - 1) / LANES, (ngroups + gpb - 1) / gpb);
#define FWD(I) dft_forward_kernel<C, MODE, I, STAGE><<<grid, THREADS, 0, stream>>>( \
        l, m, n1h, n1l, uvw, image, ftab, rtab, gtab, cg, ngroups, gpb, chi, clo,  \
        delay_small, delay_far, out, S, R, F)
    if (imag) FWD(true);
    else FWD(false);
#undef FWD
}

template <int C>
void forward_mode(int mode, bool imag, const float* l, const float* m,
                  const float* n1h, const float* n1l, const float* uvw,
                  const float* image, const float4* ftab, const float* rtab,
                  const float4* gtab, int cg, int ngroups, int gpb, float chi,
                  float clo, float delay_small, float delay_far, float2* out,
                  int S, int R, int F, cudaStream_t stream) {
#define FWD(M, ST) forward<C, M, ST>(imag, l, m, n1h, n1l, uvw, image, ftab, rtab, \
                                     gtab, cg, ngroups, gpb, chi, clo,            \
                                     delay_small, delay_far, out, S, R, F, stream)
    const bool staged = gpb > 1;
    if (mode == DIRECT) { if (staged) FWD(DIRECT, true); else FWD(DIRECT, false); }
    else if (mode == EXACT) { if (staged) FWD(EXACT, true); else FWD(EXACT, false); }
    else { if (staged) FWD(RESIDUAL, true); else FWD(RESIDUAL, false); }
#undef FWD
}

// the launch's channel groups are what the kernels take: cg <= slots,
// groups covering F with the last one possibly ragged, gpb 1, 2 or 4
bool valid_groups(int mode, int cg, int ngroups, int gpb, int F, int C) {
    const int cap = C == 4 ? slots<4>() : slots<2>();
    return mode >= DIRECT && mode <= RESIDUAL && cg >= 1 && cg <= cap &&
           (long long)cg * ngroups >= F && (long long)cg * (ngroups - 1) < F &&
           (gpb == 1 || gpb == 2 || gpb == 4) && (gpb > 1) == (ngroups > 1);
}

}  // namespace

// l, m, n1h, n1l: (P,) float32 pixel directions, n-1 as a two-float pair.
// uvw: (R, 3) float32. vis: (R, F, C) complex64, flag-masked. The host's
// channel tables: ftab (F, 4) [nu, hh, hl, lo], rtab (F,) 2*pi*delta_f,
// gtab (ngroups, 2, 4) [the group's middle channel, the step], two-float;
// (cg, ngroups): channels a group and groups, gpb groups a block; mode 0
// direct, 1 exact, 2 residual; delay_small: the |delay| of a first-order
// rotation; delay_far: the |delay| beyond which a pair takes the direct
// phase (ftab's rows). (chi, clo): sign/c as a two-float pair. partial: (nchunks, F,
// C, P) float32 scratch; out: (P, F, C) float32. Launches both passes on
// `stream`; returns cudaGetLastError().
extern "C" int dft_adjoint_launch(const float* l, const float* m,
                                  const float* n1h, const float* n1l,
                                  const float* uvw, const void* vis,
                                  const void* ftab, const float* rtab,
                                  const void* gtab, int cg, int ngroups,
                                  int gpb, int mode, float chi, float clo,
                                  float delay_small, float delay_far,
                                  float* partial,
                                  float* out, int P, int R, int F, int C,
                                  int rows_per_chunk, int nchunks,
                                  void* stream) {
    if (P <= 0 || R <= 0 || F <= 0) return (int)cudaSuccess;
    if (!valid_groups(mode, cg, ngroups, gpb, F, C) || rows_per_chunk <= 0 ||
        (long long)rows_per_chunk * nchunks < R)
        return (int)cudaErrorInvalidValue;
    const float2* v = static_cast<const float2*>(vis);
    const float4* ft = static_cast<const float4*>(ftab);
    const float4* gt = static_cast<const float4*>(gtab);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: adjoint_mode<1>(mode, l, m, n1h, n1l, uvw, v, ft, rtab, gt, cg, ngroups, gpb, chi, clo, delay_small, delay_far, partial, P, R, F, rows_per_chunk, nchunks, st); break;
        case 2: adjoint_mode<2>(mode, l, m, n1h, n1l, uvw, v, ft, rtab, gt, cg, ngroups, gpb, chi, clo, delay_small, delay_far, partial, P, R, F, rows_per_chunk, nchunks, st); break;
        case 4: adjoint_mode<4>(mode, l, m, n1h, n1l, uvw, v, ft, rtab, gt, cg, ngroups, gpb, chi, clo, delay_small, delay_far, partial, P, R, F, rows_per_chunk, nchunks, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    const int err = (int)cudaGetLastError();
    if (err != (int)cudaSuccess) return err;
    const size_t n = (size_t)F * C * P;
    const int threads = 256;
    dft_adjoint_sum<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
        partial, out, P, F * C, nchunks);
    return (int)cudaGetLastError();
}

// l, m, n1h, n1l: (S,) float32 source directions; uvw: (R, 3) float32.
// image: (S, F, C) complex64 when imag != 0, else (S, F, C) float32 (a
// real sky: the imaginary half of the product is skipped). Tables, groups,
// delay bounds and (chi, clo) as for the adjoint. out: (R, F, C) complex64.
extern "C" int dft_forward_launch(const float* l, const float* m,
                                  const float* n1h, const float* n1l,
                                  const float* uvw, const void* image, int imag,
                                  const void* ftab, const float* rtab,
                                  const void* gtab, int cg, int ngroups,
                                  int gpb, int mode, float chi, float clo,
                                  float delay_small, float delay_far, void* out,
                                  int S, int R, int F, int C, void* stream) {
    if (R <= 0 || F <= 0) return (int)cudaSuccess;
    if (!valid_groups(mode, cg, ngroups, gpb, F, C)) return (int)cudaErrorInvalidValue;
    const float* im = static_cast<const float*>(image);
    const float4* ft = static_cast<const float4*>(ftab);
    const float4* gt = static_cast<const float4*>(gtab);
    float2* o = static_cast<float2*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: forward_mode<1>(mode, imag != 0, l, m, n1h, n1l, uvw, im, ft, rtab, gt, cg, ngroups, gpb, chi, clo, delay_small, delay_far, o, S, R, F, st); break;
        case 2: forward_mode<2>(mode, imag != 0, l, m, n1h, n1l, uvw, im, ft, rtab, gt, cg, ngroups, gpb, chi, clo, delay_small, delay_far, o, S, R, F, st); break;
        case 4: forward_mode<4>(mode, imag != 0, l, m, n1h, n1l, uvw, im, ft, rtab, gt, cg, ngroups, gpb, chi, clo, delay_small, delay_far, o, S, R, F, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
