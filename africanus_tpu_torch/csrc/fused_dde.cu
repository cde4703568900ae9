// The fused RIME's direction-dependent chain and source sum as one kernel,
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   V[r,f] = sum_s A_p(s,t,f) . (K G)(s,r,f) B(s,f) . A_q(s,t,f)^H
//
//   A = E L (or L E): the beam's 2x2 Jones E(s,t,ant,f), sampled once a
//   call for every source by beam_interp and beam_blend (csrc/beam.cu),
//   and the feed rotation L(t,feed,ant); p, q the row's station (feed,
//   antenna) on each side, t its dump. K = exp(2*pi*i*frac((hi+lo)[s,r] *
//   nu[f])), the two-float delay of phase_dot_cycles; G = exp(-((u1*sf)^2
//   + (v1*sf)^2)), the gaussian envelope; B the brightness of the spectral
//   model. A second, small kernel (fused_pairs_kernel, below) makes the
//   (source, row) pairs (hi, lo, u1, v1).
//
// It replaces no TPU kernel: the JAX package's fused RIME is jnp code
// (africanus_tpu/rime/fused/), which XLA fuses. The port's eager chain
// (rime/fused/core.py) samples every term over (block, row, channel)
// grids and folds the 2x2 products with torch ops: ~180 complex64 grids
// of (row, channel) read or written a source, ~2 s of HBM traffic a
// MeerKAT-64 full-band chunk. Here no (source, row, channel) grid exists
// anywhere: the chain and the sum over sources run in registers.
//
// What bounds it on an H100: FP32 issue. A term (source, row, channel)
// costs ~140 instructions: the two-float phase (8) and sincospif (~25),
// the envelope (3, one ex2 on the SFU), K*G*B (16), the two 2x2 complex
// products (64, the first summand of the compensation folded into their
// FMAs), the compensated update of 8 reals (24) and 5 shared-memory loads;
// a source's staging adds ~2 stations' E*L (32 each) a thread. At the
// MeerKAT-64 chunk (100 sources x 8064 rows x 4096 channels, 3.3e9 terms)
// that is ~14 ms at 3.35e13 instructions a second; the compiled loop
// issues ~1,290 instructions a source and thread (the staging's
// addressing and register moves beside the arithmetic), and the kernel
// took 32.5 ms there on an H100 80GB HBM3 at 700 W. The bytes are far
// below it: the E table (sources x dumps x antennas x channels x 2x2
// complex64, 3.4 GB at that chunk, 1.0 ms of HBM) is read from HBM about
// once a call (below), the output (1 GB) written once.
//
// The layout. A block is one tile of up to ROWS = 128 rows, all of one dump
// and touching at most MAX_STATIONS = 96 stations (feed, antenna), by CHANS
// = 8 channels: the host sorts rows by dump and cuts a tile in halves until
// its stations fit (ops/cuda_fused.py, row_plan), and gives each tile its
// stations and each row its two as indices into them. So any array fits:
// a tile of MeerKAT-64's 2016 baselines a dump touches ~64 stations, one of
// SKA-Mid's 197 dishes ~130 and is cut in two of 64 rows. A thread owns one
// channel of ROWS_PER_THREAD = 4 rows and their four complex accumulators
// and compensations in registers. The block walks every source in order,
// with three stages in flight and one barrier a source:
//  - source s + 2 is copied by cp.async into a raw buffer: E at the tile's
//    stations and the block's 8 channels (each station's offset in the
//    table worked out once a block), the tile's pairs and B at the 8
//    channels;
//  - source s + 1, whose copies have had a source's sum to land, is
//    converted by the threads that copied it (no barrier between): A = E L
//    with L staged once a block, u1^2 + v1^2, into a buffer the sum reads;
//  - source s is summed from the other buffer, each A serving every row of
//    the tile that has its station on either side, so E is never gathered
//    to rows.
// Each of a dump's tiles reads its stations' E for its channels: 16 tiles
// a dump at the MeerKAT chunk, ~64 stations each, 54 GB from L2. Shared
// memory is sized by the widest tile, 77 KB at MeerKAT-64 and at most
// 111 KB, so two blocks share an SM. The grid runs the
// tiles fastest (blockIdx.x), so the blocks that share a slice run
// together and walk the sources at about the same pace: the slice comes
// from HBM about once (3.4 GB) and from L2 for the other tiles.
//
// The sum over sources stays compensated as the reference's fused kernel
// (Kahan, experimental/rime/fused/core.py:97-118): per accumulator
// y = term - c, t = s + y, c = (t - s) - y, s = t, the first subtraction
// folded into the sandwich's FMAs and the rest written with __fadd_rn /
// __fsub_rn so that nothing contracts or reassociates them. Each output
// is owned by one thread, which sums the sources in order: no atomics,
// reruns are bitwise equal. Source blocks carry the sum and its
// compensation from one launch to the next through device memory, so any
// split of the sources into blocks gives the same bits.
//
// The phase is the compensated DIRECT route of csrc/predict_kb.cu: p =
// hi * nu rounded, its exact error by an FMA (the value Dekker's product
// in ops/dfloat.py's frac_cycles gives), plus lo * nu, p - rintf(p) exact,
// and the accurate sincospif (never --use_fast_math). The envelope is
// ex2.approx of (u1^2 + v1^2) * (-log2(e) * sf^2).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHANS = 8;                        // channels of a block, one a lane
constexpr int SLOTS = THREADS / CHANS;          // row slots of a block
constexpr int ROWS_PER_THREAD = 4;
constexpr int ROWS = SLOTS * ROWS_PER_THREAD;   // rows of a tile
constexpr int SMEM_LIMIT = 232448;              // shared memory a block may hold
constexpr int MAX_STATIONS = 96;                // stations a tile stages
// a buffer's float4s beside its stations': the pairs and B's two halves
constexpr int BUFFER_EXTRA = ROWS + 2 * CHANS;
// a raw buffer's float4s beside E's: the pairs and B
constexpr int RAW_EXTRA = ROWS + 2 * CHANS;

struct Jones {
    float2 a, b, c, d;  // [[a, b], [c, d]]
};

__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
    return make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
}

__device__ __forceinline__ float2 cmad(float2 x, float2 y, float2 z) {
    return make_float2(x.x * y.x - x.y * y.y + z.x, x.x * y.y + x.y * y.x + z.y);
}

__device__ __forceinline__ Jones jmul(const Jones& x, const Jones& y) {
    return {cmad(x.a, y.a, cmul(x.b, y.c)), cmad(x.a, y.b, cmul(x.b, y.d)),
            cmad(x.c, y.a, cmul(x.d, y.c)), cmad(x.c, y.b, cmul(x.d, y.d))};
}

__device__ __forceinline__ float ex2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// x * conj(y) summed with x2 * conj(y2), minus c: the real and imaginary
// parts of one sandwich element, the compensation's first step folded in
__device__ __forceinline__ float2 dot_h(float2 x, float2 y, float2 x2, float2 y2,
                                        float cre, float cim) {
    return make_float2(-cre + x.x * y.x + x.y * y.y + x2.x * y2.x + x2.y * y2.y,
                       -cim + x.y * y.x - x.x * y.y + x2.y * y2.x - x2.x * y2.y);
}

// s + y with its compensation c, where y already holds term - c
__device__ __forceinline__ void kahan(float& s, float& c, float y) {
    const float t = __fadd_rn(s, y);
    c = __fsub_rn(__fsub_rn(t, s), y);
    s = t;
}

struct Args {
    const float4* pairs;   // (S, R) of (hi, lo, u1, v1)
    const float4* bright;  // (S, F, 2) halves of B
    const float4* beam;    // (S, T, A, F, 2) halves of E, or null
    const float4* feed;    // (T, NS, 2) halves of L, or null
    const int* stations;   // (ntiles, MS) each tile's stations
    const int* local;      // (R,) a position's p | q << 16 in its tile's stations
    const int* order;      // (R,) rows sorted by dump
    const int* tiles;      // (ntiles, 4) first position, count, dump, stations
    const float* freq;     // (F,)
    const float* gscale;   // (F,) -log2(e) * sf^2, or null
    float4* out;           // (R, F, 2) the sum's halves
    float4* comp;          // (R, F, 2) its compensation, or null
    int S, R, F, T, A, NS, MS;
    int l_first, first, last;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    // a source size of 0 fills the 16 bytes with zeros and reads nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;");
}

// every commit group of this thread's but the newest complete
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Copy source s's E (where there is a beam), the tile's pairs and B into
// a raw buffer, asynchronously: one commit group a source. Each thread
// copies the items it converts itself, so no barrier stands between the
// copy and the conversion.
__device__ __forceinline__ void fetch(const Args& g, int s, float4* raw, const int* sOff,
                                      int nst, size_t sstride, int f0, int count, int row) {
    const int tid = threadIdx.x;
    if (g.beam != nullptr) {
        const int cc = tid % CHANS;
        const bool ok = f0 + cc < g.F;
        const float4* base = g.beam + s * sstride + 2 * (f0 + cc);
        for (int st = tid / CHANS; st < nst; st += SLOTS) {
            const int i = st * CHANS + cc;
            const float4* src = ok ? base + sOff[st] : g.beam;
            cp_async16(raw + 2 * i, src, ok);
            cp_async16(raw + 2 * i + 1, src + (ok ? 1 : 0), ok);
        }
    }
    float4* rP = raw + 2 * g.MS * CHANS;
    if (tid < ROWS)
        cp_async16(rP + tid, g.pairs + (tid < count ? (size_t)s * g.R + row : 0), tid < count);
    if (tid < 2 * CHANS) {
        const int h = tid / CHANS, ff = f0 + tid % CHANS;
        cp_async16(rP + ROWS + tid,
                   g.bright + (ff < g.F ? ((size_t)s * g.F + ff) * 2 + h : 0), ff < g.F);
    }
    cp_async_commit();
}

// Turn this thread's items of a raw buffer into the buffer the sum reads:
// A = E L (or L E), the delay and u1^2 + v1^2, B.
__device__ __forceinline__ void convert(const Args& g, const float4* raw, float4* buf,
                                        const float4* sL, int nst) {
    const int tid = threadIdx.x;
    if (g.beam != nullptr) {
        const int cc = tid % CHANS;
        for (int st = tid / CHANS; st < nst; st += SLOTS) {
            const int i = st * CHANS + cc;
            const float4 e0 = raw[2 * i], e1 = raw[2 * i + 1];
            Jones a = {make_float2(e0.x, e0.y), make_float2(e0.z, e0.w),
                       make_float2(e1.x, e1.y), make_float2(e1.z, e1.w)};
            if (g.feed != nullptr) {
                const float4 l0 = sL[2 * st], l1 = sL[2 * st + 1];
                const Jones l = {make_float2(l0.x, l0.y), make_float2(l0.z, l0.w),
                                 make_float2(l1.x, l1.y), make_float2(l1.z, l1.w)};
                a = g.l_first ? jmul(l, a) : jmul(a, l);
            }
            buf[(2 * st) * CHANS + cc] = make_float4(a.a.x, a.a.y, a.b.x, a.b.y);
            buf[(2 * st + 1) * CHANS + cc] = make_float4(a.c.x, a.c.y, a.d.x, a.d.y);
        }
    }
    const float4* rP = raw + 2 * g.MS * CHANS;
    float4* sP = buf + 2 * g.MS * CHANS;
    if (tid < ROWS) {
        const float4 v = rP[tid];
        sP[tid] = make_float4(v.x, v.y, v.z * v.z + v.w * v.w, 0.f);
    }
    if (tid < 2 * CHANS) sP[ROWS + tid] = rP[ROWS + tid];
}

template <bool ENV, bool JONES>
__global__ void __launch_bounds__(THREADS, 2) fused_dde_kernel(const Args g) {
    extern __shared__ float4 smem[];
    const int tid = threadIdx.x, c = tid % CHANS, slot = tid / CHANS;
    const int* tile = g.tiles + 4 * blockIdx.x;
    const int start = tile[0], count = tile[1], t = tile[2], nst = tile[3];
    const int* tileSt = g.stations + (size_t)blockIdx.x * g.MS;
    const int f0 = blockIdx.y * CHANS, f = f0 + c;
    const bool fin = f < g.F;

    // shared memory, in float4s, for up to MS stations a tile: L at the
    // tile's stations; two buffers the sum reads (A at the stations and
    // channels, the pairs, their envelope terms, B); two raw buffers a
    // later source's copies land in (E at the stations and channels, the
    // pairs, B)
    const int bufsize = 2 * g.MS * CHANS + BUFFER_EXTRA;
    const int rawsize = 2 * g.MS * CHANS + RAW_EXTRA;
    float4* sL = smem;
    int* sOff = reinterpret_cast<int*>(sL + (g.feed != nullptr ? 2 * g.MS : 0));
    float4* bufs = reinterpret_cast<float4*>(sOff) + (g.MS + 3) / 4;
    float4* raws = bufs + 2 * bufsize;
    // each station's E at (t, its antenna, channel 0), from a source's
    const size_t sstride = (size_t)g.T * g.A * g.F * 2;
    for (int i = tid; i < nst; i += THREADS) {
        const int st = tileSt[i];
        sOff[i] = (t * g.A + (g.feed != nullptr ? st % g.A : st)) * g.F * 2;
    }
    __syncthreads();

    // the rows' stations' first float4 in a buffer of A, p in the low and
    // q in the high 16 bits
    int pq[ROWS_PER_THREAD];
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int pos = slot + SLOTS * k;
        pq[k] = 0;
        if (JONES && pos < count) {
            const int lpq = g.local[start + pos];
            pq[k] = (2 * CHANS * (lpq & 0xffff)) | ((2 * CHANS * (lpq >> 16)) << 16);
        }
    }
    // the channel's frequency and the envelope's scale
    const float fx = fin ? g.freq[f] : 0.f;
    const float gs = ENV && fin ? g.gscale[f] : 0.f;

    float sum[ROWS_PER_THREAD][8], cmp[ROWS_PER_THREAD][8];
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int pos = slot + SLOTS * k;
        float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0, c0 = s0, c1 = s0;
        if (!g.first && fin && pos < count) {
            const size_t idx = ((size_t)g.order[start + pos] * g.F + f) * 2;
            s0 = g.out[idx];
            s1 = g.out[idx + 1];
            c0 = g.comp[idx];
            c1 = g.comp[idx + 1];
        }
        sum[k][0] = s0.x; sum[k][1] = s0.y; sum[k][2] = s0.z; sum[k][3] = s0.w;
        sum[k][4] = s1.x; sum[k][5] = s1.y; sum[k][6] = s1.z; sum[k][7] = s1.w;
        cmp[k][0] = c0.x; cmp[k][1] = c0.y; cmp[k][2] = c0.z; cmp[k][3] = c0.w;
        cmp[k][4] = c1.x; cmp[k][5] = c1.y; cmp[k][6] = c1.z; cmp[k][7] = c1.w;
    }

    // the row whose pair this thread copies
    const int row = tid < ROWS && tid < count ? g.order[start + tid] : 0;
    // sources 0 and 1 in flight while L is staged
    if (g.S > 0) fetch(g, 0, raws, sOff, nst, sstride, f0, count, row);
    if (g.S > 1) fetch(g, 1, raws + rawsize, sOff, nst, sstride, f0, count, row);
    else cp_async_commit();
    if (g.feed != nullptr) {
        for (int i = tid; i < 2 * nst; i += THREADS)
            sL[i] = __ldg(g.feed + ((size_t)t * g.NS + tileSt[i >> 1]) * 2 + (i & 1));
        __syncthreads();
        if (g.beam == nullptr) {
            // A = L alone, the same for every source: staged once
            for (int i = tid; i < nst * CHANS; i += THREADS) {
                const int st = i / CHANS, cc = i - st * CHANS;
                bufs[(2 * st) * CHANS + cc] = sL[2 * st];
                bufs[(2 * st + 1) * CHANS + cc] = sL[2 * st + 1];
            }
        }
    }
    cp_async_wait_one();
    if (g.S > 0) convert(g, raws, bufs, sL, nst);
    __syncthreads();

    // Source s is summed from buffer s % 2 while source s + 1 is converted
    // into the other, its copies having been in flight for a source, and
    // source s + 2's copies are issued into the raw buffer s + 1's left:
    // one barrier a source.
    for (int s = 0; s < g.S; ++s) {
        float4* buf = bufs + (s & 1) * bufsize;
        if (s + 2 < g.S)
            fetch(g, s + 2, raws + (s & 1) * rawsize, sOff, nst, sstride, f0, count, row);
        else cp_async_commit();
        cp_async_wait_one();
        if (s + 1 < g.S)
            convert(g, raws + ((s + 1) & 1) * rawsize, bufs + ((s + 1) & 1) * bufsize, sL, nst);
        const float4* sA = g.beam != nullptr ? buf : bufs;
        const float4* sP = buf + 2 * g.MS * CHANS;
        const float4* sB = sP + ROWS;
        const float4* sAc = sA + c;
        const float4 b0 = sB[c], b1 = sB[CHANS + c];
        // rows past the tile's count sum zeros into accumulators never stored
#pragma unroll
        for (int k = 0; k < ROWS_PER_THREAD; ++k) {
            const float4 pr = sP[slot + SLOTS * k];
            // frac((hi + lo) * nu): the product's exact error by an FMA
            const float p = __fmul_rn(pr.x, fx);
            const float e = __fadd_rn(__fmaf_rn(pr.x, fx, -p), __fmul_rn(pr.y, fx));
            const float frac = __fadd_rn(__fsub_rn(p, rintf(p)), e);
            float sn, cs;
            sincospif(2.0f * frac, &sn, &cs);
            if (ENV) {
                const float env = ex2_approx(pr.z * gs);
                cs *= env;
                sn *= env;
            }
            const float2 kg = make_float2(cs, sn);
            const Jones m = {cmul(kg, make_float2(b0.x, b0.y)), cmul(kg, make_float2(b0.z, b0.w)),
                             cmul(kg, make_float2(b1.x, b1.y)), cmul(kg, make_float2(b1.z, b1.w))};
            float* sk = sum[k];
            float* ck = cmp[k];
            if (JONES) {
                const int op = pq[k] & 0xffff, oq = pq[k] >> 16;
                const float4 p0 = sAc[op], p1 = sAc[op + CHANS];
                const float4 q0 = sAc[oq], q1 = sAc[oq + CHANS];
                const Jones ap = {make_float2(p0.x, p0.y), make_float2(p0.z, p0.w),
                                  make_float2(p1.x, p1.y), make_float2(p1.z, p1.w)};
                const Jones x = jmul(ap, m);
                const float2 qa = make_float2(q0.x, q0.y), qb = make_float2(q0.z, q0.w);
                const float2 qc = make_float2(q1.x, q1.y), qd = make_float2(q1.z, q1.w);
                // x . A_q^H: element (i, k) = x_i0 conj(q_k0) + x_i1 conj(q_k1)
                const float2 y00 = dot_h(x.a, qa, x.b, qb, ck[0], ck[1]);
                const float2 y01 = dot_h(x.a, qc, x.b, qd, ck[2], ck[3]);
                const float2 y10 = dot_h(x.c, qa, x.d, qb, ck[4], ck[5]);
                const float2 y11 = dot_h(x.c, qc, x.d, qd, ck[6], ck[7]);
                kahan(sk[0], ck[0], y00.x); kahan(sk[1], ck[1], y00.y);
                kahan(sk[2], ck[2], y01.x); kahan(sk[3], ck[3], y01.y);
                kahan(sk[4], ck[4], y10.x); kahan(sk[5], ck[5], y10.y);
                kahan(sk[6], ck[6], y11.x); kahan(sk[7], ck[7], y11.y);
            } else {
                kahan(sk[0], ck[0], m.a.x - ck[0]); kahan(sk[1], ck[1], m.a.y - ck[1]);
                kahan(sk[2], ck[2], m.b.x - ck[2]); kahan(sk[3], ck[3], m.b.y - ck[3]);
                kahan(sk[4], ck[4], m.c.x - ck[4]); kahan(sk[5], ck[5], m.c.y - ck[5]);
                kahan(sk[6], ck[6], m.d.x - ck[6]); kahan(sk[7], ck[7], m.d.y - ck[7]);
            }
        }
        __syncthreads();
    }

    if (!fin) return;
#pragma unroll
    for (int k = 0; k < ROWS_PER_THREAD; ++k) {
        const int pos = slot + SLOTS * k;
        if (pos >= count) continue;
        const size_t idx = ((size_t)g.order[start + pos] * g.F + f) * 2;
        const float* sk = sum[k];
        const float* ck = cmp[k];
        if (g.last) {
            g.out[idx] = make_float4(__fsub_rn(sk[0], ck[0]), __fsub_rn(sk[1], ck[1]),
                                     __fsub_rn(sk[2], ck[2]), __fsub_rn(sk[3], ck[3]));
            g.out[idx + 1] = make_float4(__fsub_rn(sk[4], ck[4]), __fsub_rn(sk[5], ck[5]),
                                         __fsub_rn(sk[6], ck[6]), __fsub_rn(sk[7], ck[7]));
        } else {
            g.out[idx] = make_float4(sk[0], sk[1], sk[2], sk[3]);
            g.out[idx + 1] = make_float4(sk[4], sk[5], sk[6], sk[7]);
            g.comp[idx] = make_float4(ck[0], ck[1], ck[2], ck[3]);
            g.comp[idx + 1] = make_float4(ck[4], ck[5], ck[6], ck[7]);
        }
    }
}

// The pairs: per (source, row) the two-float delay of phase_dot_cycles
// (rime/phase.py) and the envelope coordinates of envelope_coordinates
// (model/shape/gaussian_shape.py), value for value: each of their torch
// operations is one rounded float32 operation here, in the same order
// (ops/dfloat.py's error-free transformations; __fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn are never contracted), so ~230 small kernels of
// the eager prologue become one launch. A thread a pair; the source's n - 1
// is worked out again for every row, a few hundred instructions a pair
// against the sum's thousands.

struct DF {
    float hi, lo;
};

__device__ __forceinline__ DF two_sum(float a, float b) {
    const float s = __fadd_rn(a, b);
    const float v = __fsub_rn(s, a);
    return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v))};
}

__device__ __forceinline__ DF quick_two_sum(float a, float b) {
    const float s = __fadd_rn(a, b);
    return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
    const float c = __fmul_rn(a, 4097.0f);
    hi = __fsub_rn(c, __fsub_rn(c, a));
    lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ DF two_prod(float a, float b) {
    const float p = __fmul_rn(a, b);
    float ah, al, bh, bl;
    split(a, ah, al);
    split(b, bh, bl);
    float e = __fsub_rn(__fmul_rn(ah, bh), p);
    e = __fadd_rn(e, __fmul_rn(ah, bl));
    e = __fadd_rn(e, __fmul_rn(al, bh));
    return {p, __fadd_rn(e, __fmul_rn(al, bl))};
}

__device__ __forceinline__ DF df_add(DF x, DF y) {
    const DF s = two_sum(x.hi, y.hi);
    return quick_two_sum(s.hi, __fadd_rn(__fadd_rn(s.lo, x.lo), y.lo));
}

__device__ __forceinline__ DF df_mul(DF x, DF y) {
    const DF p = two_prod(x.hi, y.hi);
    return quick_two_sum(
        p.hi, __fadd_rn(p.lo, __fadd_rn(__fmul_rn(x.hi, y.lo), __fmul_rn(x.lo, y.hi))));
}

__device__ __forceinline__ DF df_div(DF x, DF y) {
    const float q = __fdiv_rn(x.hi, y.hi);
    const DF p = two_prod(q, y.hi);
    const float r = __fsub_rn(
        __fadd_rn(__fsub_rn(__fsub_rn(x.hi, p.hi), p.lo), x.lo), __fmul_rn(q, y.lo));
    return quick_two_sum(q, __fdiv_rn(r, y.hi));
}

__device__ __forceinline__ DF df_sqrt(DF x) {
    // the correctly rounded float32 sqrt, as the float64 sqrt rounded once
    const float h = __double2float_rn(__dsqrt_rn((double)x.hi));
    const DF p = two_prod(h, h);
    const float r = __fadd_rn(__fsub_rn(__fsub_rn(x.hi, p.hi), p.lo), x.lo);
    const float safe = h == 0.0f ? 1.0f : __fmul_rn(2.0f, h);
    return quick_two_sum(h, __fdiv_rn(r, safe));
}

// n - 1 = -(l^2 + m^2) / (1 + sqrt(1 - l^2 - m^2)), beyond the horizon -1
__device__ __forceinline__ DF n_minus_one(float l, float m) {
    const DF s = df_add(two_prod(l, l), two_prod(m, m));
    const DF one = {1.0f, 0.0f};
    DF d = df_add(one, {-s.hi, -s.lo});
    const bool clip = d.hi < 0.0f;
    if (clip) d = {0.0f, 0.0f};
    const DF n1 = df_div(s, df_add(one, df_sqrt(d)));
    return clip ? DF{-1.0f, 0.0f} : DF{-n1.hi, -n1.lo};
}

// pairs (S, R) of (hi, lo, u1, v1): lm (S, 2), uvw (R, 3), axes (S, 3) of
// (em, el, er) or null (u1 = v1 = 0), (chi, clo) the two-float +-1/c
__global__ void __launch_bounds__(THREADS) fused_pairs_kernel(
    const float* lm, const float* uvw, const float* axes, float4* pairs, int S, int R,
    float chi, float clo) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= (long long)S * R) return;
    const int s = (int)(i / R), r = (int)(i - (long long)s * R);
    const float l = lm[2 * s], m = lm[2 * s + 1];
    const float u = uvw[3 * r], v = uvw[3 * r + 1], w = uvw[3 * r + 2];
    const DF n1 = n_minus_one(l, m);
    const DF metres = df_add(df_add(two_prod(l, u), two_prod(m, v)), df_mul(n1, {w, 0.0f}));
    const DF delay = df_mul(metres, {chi, clo});
    float u1 = 0.0f, v1 = 0.0f;
    if (axes != nullptr) {
        const float em = axes[3 * s], el = axes[3 * s + 1], er = axes[3 * s + 2];
        u1 = __fmul_rn(__fsub_rn(__fmul_rn(u, em), __fmul_rn(v, el)), er);
        v1 = __fadd_rn(__fmul_rn(u, el), __fmul_rn(v, em));
    }
    pairs[i] = make_float4(delay.hi, delay.lo, u1, v1);
}

template <bool ENV, bool JONES>
int allow() {
    return (int)cudaFuncSetAttribute(fused_dde_kernel<ENV, JONES>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     SMEM_LIMIT);
}

template <bool ENV, bool JONES>
int launch(const Args& g, int ntiles, int smem, cudaStream_t stream) {
    const dim3 grid(ntiles, (g.F + CHANS - 1) / CHANS);
    fused_dde_kernel<ENV, JONES><<<grid, THREADS, smem, stream>>>(g);
    return (int)cudaGetLastError();
}

}  // namespace

// Lets the kernels take up to SMEM_LIMIT bytes of dynamic shared memory on
// the current device. Called once per device before the first launch,
// outside any CUDA-graph capture.
extern "C" int fused_dde_init() {
    int err = allow<true, true>();
    err = err ? err : allow<true, false>();
    err = err ? err : allow<false, true>();
    return err ? err : allow<false, false>();
}

// One source block: see Args for the operands (float32 and int32, on one
// device). NS stations (feed x antenna where there is a feed rotation, else
// antennas), ntiles tiles of at most ROWS rows of one dump and MS stations;
// `smem` the wrapper's shared_bytes(MS, feed), checked here only against
// the card's limit. first: the sum starts from zero, else from out and
// comp; last: out receives sum - compensation, else both are written back.
extern "C" int fused_dde_launch(const void* pairs, const void* bright, const void* beam,
                                const void* feed, const void* stations, const void* local,
                                const void* order, const void* tiles, const void* freq,
                                const void* gscale, void* out, void* comp, int S, int R,
                                int F, int T, int A, int NS, int MS, int ntiles, int l_first,
                                int first, int last, int smem, void* stream) {
    const bool jones = beam != nullptr || feed != nullptr;
    if (S < 0 || R < 0 || F < 0 || ntiles < 0 ||
        (jones && (NS < 1 || MS < 1 || MS > MAX_STATIONS)) ||
        (!last && comp == nullptr) || (!first && comp == nullptr) ||
        (F + CHANS - 1) / CHANS > 65535 || smem < 0 || smem > SMEM_LIMIT ||
        (long long)T * A * F * 2 > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    if (ntiles == 0 || F == 0) return 0;
    Args g{static_cast<const float4*>(pairs), static_cast<const float4*>(bright),
           static_cast<const float4*>(beam), static_cast<const float4*>(feed),
           static_cast<const int*>(stations), static_cast<const int*>(local),
           static_cast<const int*>(order), static_cast<const int*>(tiles),
           static_cast<const float*>(freq), static_cast<const float*>(gscale),
           static_cast<float4*>(out), static_cast<float4*>(comp),
           S, R, F, T, A, jones ? NS : 0, jones ? MS : 0, l_first, first, last};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool env = gscale != nullptr;
    if (env) return jones ? launch<true, true>(g, ntiles, smem, st)
                          : launch<true, false>(g, ntiles, smem, st);
    return jones ? launch<false, true>(g, ntiles, smem, st)
                 : launch<false, false>(g, ntiles, smem, st);
}

// pairs (S, R, 4) float32 for the kernel above's operands; see
// fused_pairs_kernel.
extern "C" int fused_pairs_launch(const void* lm, const void* uvw, const void* axes,
                                  void* pairs, int S, int R, float chi, float clo,
                                  void* stream) {
    if (S < 0 || R < 0) return (int)cudaErrorInvalidValue;
    const long long n = (long long)S * R;
    if (n == 0) return 0;
    fused_pairs_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(lm), static_cast<const float*>(uvw),
        static_cast<const float*>(axes), static_cast<float4*>(pairs), S, R, chi, clo);
    return (int)cudaGetLastError();
}
