// Beam-cube interpolation (the E Jones of a direction-dependent predict),
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// The cube arrives as slabs (ops/cuda_beam.beam_slabs): (nud, lw, mh, 3C)
// values of T, each (l, m) cell of a frequency slab holding C real parts,
// C imaginary parts and C amplitudes |v|. Three kernels:
//
//  beam_interp (replaces beam_interp_pallas / _beam_kernel,
//    africanus_tpu/ops/pallas_beam.py:153/78, pallas_call l.228). Per
//    (sample s, row k): slabs gc0[k] and gc1[k] blended by wlo[k] and
//    bilinear in l and m at the sample's coordinates (vl, vm), computed as
//    one trilinear sum: 8 weights (slab x l x m), then the 8 corners added
//    in a fixed order. Row k reads coordinate column k / (nrows / ncol), so
//    one launch serves the general route (a column per channel), the
//    channel-invariant route (one column, a row per slab) and the cell
//    corners (four columns, a row per slab). Writes the 3C raw sums, or the
//    C amplitude-normalised complex values, at (s, k): no layout pass
//    follows.
//  beam_blend (replaces beam_blend_fr_pallas / _blend_fr_kernel,
//    pallas_beam.py:473/250, pallas_call l.538). Per (sample, channel): the
//    two-hot frequency blend of the sample's per-slab raw sums (slabs gc0,
//    gc0 + 1, weights wlo, 1 - wlo), the amplitude-preserving normalisation
//    (div == 0 -> amp, l.286-288) and, optionally, E.F with the sample's
//    2x2 feed rotation F, read per (time, antenna) from the sample index
//    (antenna fastest), c = 2i + j row-major (l.298-311).
//  beam_blend_cell (replaces beam_blend_cell_fr_pallas /
//    _blend_cell_fr_kernel, pallas_beam.py:383/314, pallas_call l.450): as
//    beam_blend on the four bilinear cell coefficients of each slab, each
//    channel rebuilt as b0 + lda.b1 + mda.b2 + lda.mda.b3 from its in-cell
//    offsets (l.347-361) before the normalisation. One template serves both.
//
// The maps carry over, not the TPU schedules: no one-hot MXU row gather, no
// lane -> (m, k) tables, no scalar prefetch, no 8 x 128 padding.
//
// What bounds them on an H100: bytes, in principle. At config 3 (8 sources
// x 64 antennas x 4096 channels = 2,097,152 samples x 4 correlations, a
// 129 x 129 x 8 x 4 cube of 6.4 MB as slabs) each kernel's compulsory
// traffic is its output, 67.1 MB of complex64, plus its inputs: 16.8 MB of
// vl, vm and the cells they need on the general route (~0.0255 ms at 3.35
// TB/s), 16.8 MB of lda, mda for beam_blend_cell (~0.025 ms), next to
// nothing for beam_blend (~0.020 ms). beam_interp's two small launches
// (512 samples x 8 and x 32 rows of raw sums) move under 2 MB: they are
// bound by the launch and one thread's chain of dependent loads.
// beam_interp's general route does not reach its byte bound. Measured on
// an H100 80GB HBM3 at 700 W (tools/beam_interp_variants.py: this file with
// a stage switched off): the issue of ~300 instructions per (sample, row),
// half of them the four correctly rounded sqrt and divides, takes ~0.030
// ms; the corner loads, which deliver 8 x 3C = 96 values to every (sample,
// row) through L1 (805 MB), add ~0.014 ms and the stores ~0.007, one after
// the other. Corners read from shared memory at the same addresses would
// take an eighth off, but a block or a warp that stages its samples' boxes
// of cells (warp reductions for the box, a copy, a barrier) loses more
// than that, and one box for a block's samples would hold most of the
// cube (a source's antennas lie far apart in it).
// What the design does about it:
//  - beam_interp: the (sample, row) rectangle of a block comes from
//    blockIdx and blockDim, with no division in a thread; the block reads
//    its rows' slabs, weight and coordinate column once into shared
//    memory. A thread then takes spt samples of its row, k fastest in a
//    warp, so coordinates are read and outputs written contiguously, both
//    as streaming (evict-first) accesses. Each corner is 3C contiguous
//    values (16-byte loads where they align) from the cube, which so stays
//    in the 50 MB L2, weighted once and added into one accumulator: one
//    corner in flight, 3C registers of sums, 64 registers a thread. The
//    raw sums of the small launches take three threads a (sample, row), a
//    part of C values each, and blocks small enough that the launch covers
//    the 132 SMs. The host chooses the layout
//    (ops/cuda_beam.interp_layout); the launch checks it.
//  - beam_blend(_cell): one block per (sample, 128 channels); the block
//    stages the sample's nud x 3C raw sums (x 4 terms for the cell route) in
//    shared memory, each thread blends, normalises, applies F from registers
//    and writes its C complex values as vector stores, so a warp writes one
//    contiguous run of (s, t, a, f, C) output.
// No atomics and a fixed order of operations: two launches give
// bitwise-equal outputs. No --use_fast_math: sqrt and the division are
// correctly rounded. The interpolation, the blends and the normalisation
// are separately rounded multiplies and adds (mul_rn, add_rn) in the plain
// versions' order, never contracted into FMAs, so kernel and plain version
// give the same bits there (near a zero interpolant the normalisation
// magnifies any other rounding past the 1e-5 bound); only E.F may be
// contracted.

#include <cuda_runtime.h>

namespace {

// an interp block: threads and rows (its row table) at most, and the blocks
// an SM should hold (the register budget: 64 a thread)
constexpr int INTERP_THREADS = 256;
constexpr int INTERP_ROWS = 256;
constexpr int INTERP_MIN_BLOCKS = 4;
constexpr int BLEND_THREADS = 128;
// dynamic shared memory of a blend block, at most (the default limit): a
// sample's 4 x nud x 3C coefficients, refused at launch beyond it
constexpr int BLEND_SMEM = 48 * 1024;

// N consecutive values to or from registers, as 16- or 8-byte accesses where
// N * sizeof(T) allows (the callers' addresses are multiples of it).
template <int N>
__device__ __forceinline__ void load(const float* __restrict__ src, float (&v)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
            const float4 q = __ldg(reinterpret_cast<const float4*>(src) + i);
            v[4 * i] = q.x; v[4 * i + 1] = q.y; v[4 * i + 2] = q.z; v[4 * i + 3] = q.w;
        }
    } else if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            const float2 q = __ldg(reinterpret_cast<const float2*>(src) + i);
            v[2 * i] = q.x; v[2 * i + 1] = q.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = __ldg(src + i);
    }
}

template <int N>
__device__ __forceinline__ void load(const double* __restrict__ src, double (&v)[N]) {
    if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            const double2 q = __ldg(reinterpret_cast<const double2*>(src) + i);
            v[2 * i] = q.x; v[2 * i + 1] = q.y;
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = __ldg(src + i);
    }
}

// one value or vector to device memory; with CS as a streaming store
// (evict first), for outputs that no later read of the kernel wants in L2
template <bool CS, typename V>
__device__ __forceinline__ void put(V* dst, V v) {
    if constexpr (CS)
        __stcs(dst, v);
    else
        *dst = v;
}

template <int N, bool CS = false>
__device__ __forceinline__ void store(float* __restrict__ dst, const float (&v)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
            put<CS>(reinterpret_cast<float4*>(dst) + i,
                    make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
    } else if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            put<CS>(reinterpret_cast<float2*>(dst) + i, make_float2(v[2 * i], v[2 * i + 1]));
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) put<CS>(dst + i, v[i]);
    }
}

template <int N, bool CS = false>
__device__ __forceinline__ void store(double* __restrict__ dst, const double (&v)[N]) {
    if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            put<CS>(reinterpret_cast<double2*>(dst) + i, make_double2(v[2 * i], v[2 * i + 1]));
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) put<CS>(dst + i, v[i]);
    }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// a * b and a + b, each rounded once: never contracted into an FMA, so the
// plain versions' separate torch multiplies and adds give the same bits
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// w0 * a + w1 * b, as the plain versions compute the blends
template <typename T>
__device__ __forceinline__ T blend2(T w0, T a, T w1, T b) {
    return add_rn(mul_rn(w0, a), mul_rn(w1, b));
}

// The reference's amplitude-preserving normalisation of C raw sums
// (sums = [re.C | im.C | amp.C]) into C complex values e = [re, im] x C.
template <typename T, int C>
__device__ __forceinline__ void normalise(const T (&sums)[3 * C], T (&e)[2 * C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const T re = sums[c], im = sums[C + c], amp = sums[2 * C + c];
        const T div = sqrt(add_rn(mul_rn(re, re), mul_rn(im, im)));
        const T norm = div == T(0) ? amp : amp / div;
        e[2 * c] = re * norm;
        e[2 * c + 1] = im * norm;
    }
}

// A corner's weighted values added to the accumulator: acc += w * corner
// (the first corner sets acc = w * corner), a multiply and an add a value.
template <typename T, int N, bool FIRST = false>
__device__ __forceinline__ void corner(const T* __restrict__ src, T w, T (&acc)[N]) {
    T v[N];
    load<N>(src, v);
#pragma unroll
    for (int q = 0; q < N; ++q) acc[q] = FIRST ? mul_rn(w, v[q]) : add_rn(acc[q], mul_rn(w, v[q]));
}

// The trilinear interpolant of a (sample, row): a and b point at the (l0, m0)
// cell of its two slabs, dl and dm step to l0 + 1 and m0 + 1 (0 on the cube's
// last row or column). The 8 weights are slab x (1 - ld or ld) x (1 - md or
// md): exactly 1 and 0s at integer coordinates with one slab per row.
template <typename T, int N>
__device__ __forceinline__ void trilinear(const T* a, const T* b, int dl, int dm, T wa,
                                          T ld, T md, T (&acc)[N]) {
    const T wb = T(1) - wa, wl0 = T(1) - ld, wm0 = T(1) - md;
    const T q00 = wl0 * wm0, q01 = wl0 * md, q10 = ld * wm0, q11 = ld * md;
    corner<T, N, true>(a, wa * q00, acc);
    corner<T, N>(a + dm, wa * q01, acc);
    corner<T, N>(a + dl, wa * q10, acc);
    corner<T, N>(a + dl + dm, wa * q11, acc);
    corner<T, N>(b, wb * q00, acc);
    corner<T, N>(b + dm, wb * q01, acc);
    corner<T, N>(b + dl, wb * q10, acc);
    corner<T, N>(b + dl + dm, wb * q11, acc);
}

// A block of blockDim = (P, rows, lanes) threads owns rows k0 .. k0 + rows - 1
// (k0 = blockIdx.y * rows) of samples s0 .. s0 + lanes * spt - 1 (s0 =
// blockIdx.x * lanes * spt): thread (x, y, z) takes row k0 + y and samples
// s0 + z, s0 + z + lanes, ... (spt of them), and part x of the values. P = 1
// when NORM (all 3C values, then the normalisation), else 3: part x is the
// C raw sums [x.C, x.C + C) (re, im or |v|). The layout is chosen on the
// host (ops/cuda_beam.interp_layout) and checked by beam_interp_launch.
// vl, vm: (nsamp, ncol), already clamped to [0, lw - 1] and [0, mh - 1] (the
// corner indices are clamped too, so no input reads outside the cube); row
// k reads column k / per. gc0, gc1, wlo: (nrows,). out: (nsamp, nrows, 3C)
// raw sums, or (nsamp, nrows, C) complex T when NORM.
template <typename T, int C, bool NORM>
__global__ void __launch_bounds__(INTERP_THREADS, INTERP_MIN_BLOCKS)
beam_interp_kernel(const T* __restrict__ slabs, const T* __restrict__ vl,
                   const T* __restrict__ vm, const int* __restrict__ gc0,
                   const int* __restrict__ gc1, const T* __restrict__ wlo,
                   T* __restrict__ out, int nsamp, int nrows, int ncol, int per,
                   int nud, int lw, int mh, int spt) {
    constexpr int K3 = 3 * C;
    constexpr int KP = NORM ? K3 : C;  // the values a thread interpolates
    __shared__ int s_ga[INTERP_ROWS], s_gb[INTERP_ROWS], s_col[INTERP_ROWS];
    __shared__ T s_w[INTERP_ROWS];

    // the block's row table, once: both slabs, the weight of the lower one
    // and the coordinate column (the only division)
    const int rows = blockDim.y, lanes = blockDim.z;
    const int k0 = blockIdx.y * rows;
    const int t = threadIdx.x + blockDim.x * (threadIdx.y + rows * threadIdx.z);
    if (t < rows && k0 + t < nrows) {
        s_ga[t] = clampi(gc0[k0 + t], 0, nud - 1);
        s_gb[t] = clampi(gc1[k0 + t], 0, nud - 1);
        s_w[t] = wlo[k0 + t];
        s_col[t] = (k0 + t) / per;
    }
    __syncthreads();
    const int y = threadIdx.y, k = k0 + y;
    if (k >= nrows) return;
    const int part = threadIdx.x * KP;
    const long long slab = (long long)lw * mh * K3;
    const T* a = slabs + s_ga[y] * slab + part;
    const T* b = slabs + s_gb[y] * slab + part;
    const T wa = s_w[y];
    const int col = s_col[y];

    long long s = (long long)blockIdx.x * lanes * spt + threadIdx.z;
    for (int g = 0; g < spt && s < nsamp; ++g, s += lanes) {
        const T l = __ldcs(vl + s * ncol + col), m = __ldcs(vm + s * ncol + col);
        const T lf = floor(l), mf = floor(m);
        const int l0 = clampi((int)lf, 0, lw - 1), m0 = clampi((int)mf, 0, mh - 1);
        const int c00 = (l0 * mh + m0) * K3;
        T acc[KP];
        trilinear<T, KP>(a + c00, b + c00, l0 + 1 < lw ? mh * K3 : 0, m0 + 1 < mh ? K3 : 0,
                         wa, l - lf, m - mf, acc);
        const long long o = s * nrows + k;
        if constexpr (NORM) {
            T e[2 * C];
            normalise<T, C>(acc, e);
            store<2 * C, true>(out + o * (2 * C), e);
        } else {
            store<C, true>(out + o * K3 + part, acc);
        }
    }
}

// One block per (sample s, tile of BLEND_THREADS channels), one thread per
// channel f. coef: (nsamp, NT, nud, 3C) with NT = 4 cell terms when CELL,
// else 1; lda, mda: (nsamp, nchan) when CELL; gc0, wlo: (nchan,); feed:
// (nta, 2, 2) complex T when FEED, sample s taking row s % nta; out:
// (nsamp, nchan, C) complex T.
template <typename T, int C, bool CELL, bool FEED>
__global__ void __launch_bounds__(BLEND_THREADS)
beam_blend_kernel(const T* __restrict__ coef, const T* __restrict__ lda,
                  const T* __restrict__ mda, const int* __restrict__ gc0,
                  const T* __restrict__ wlo, const T* __restrict__ feed,
                  T* __restrict__ out, int nud, int nchan, int nctile, int nta) {
    constexpr int K3 = 3 * C;
    constexpr int NT = CELL ? 4 : 1;
    extern __shared__ __align__(16) unsigned char smem[];
    T* s_coef = reinterpret_cast<T*>(smem);

    const long long s = blockIdx.x / nctile;
    const int f = (int)(blockIdx.x - s * nctile) * BLEND_THREADS + threadIdx.x;
    const int n = NT * nud * K3;
    const T* src = coef + s * n;
    for (int q = threadIdx.x; q < n; q += BLEND_THREADS) s_coef[q] = src[q];
    __syncthreads();
    if (f >= nchan) return;

    const int g = clampi(gc0[f], 0, nud - 2);
    const T w0 = wlo[f], w1 = T(1) - w0;
    const size_t o = (size_t)s * nchan + f;
    T val[K3];
    if constexpr (CELL) {
        const T la = lda[o], ma = mda[o], lm = la * ma;
        const int stride = nud * K3;  // from one term to the next
#pragma unroll
        for (int q = 0; q < K3; ++q) {
            const T* c = s_coef + g * K3 + q;
            const T b0 = blend2(w0, c[0], w1, c[K3]);
            const T b1 = blend2(w0, c[stride], w1, c[stride + K3]);
            const T b2 = blend2(w0, c[2 * stride], w1, c[2 * stride + K3]);
            const T b3 = blend2(w0, c[3 * stride], w1, c[3 * stride + K3]);
            // ((b0 + la.b1) + ma.b2) + lm.b3, each product rounded
            val[q] = add_rn(add_rn(add_rn(b0, mul_rn(la, b1)), mul_rn(ma, b2)), mul_rn(lm, b3));
        }
    } else {
#pragma unroll
        for (int q = 0; q < K3; ++q)
            val[q] = blend2(w0, s_coef[g * K3 + q], w1, s_coef[(g + 1) * K3 + q]);
    }
    T e[2 * C];
    normalise<T, C>(val, e);

    if constexpr (FEED) {
        // E.F: out[2i+k] = sum_j e[2i+j] F[2j+k], complex, j = 0 then 1
        T fr[8];
        load<8>(feed + (size_t)(s % nta) * 8, fr);
        T o8[8];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
                T re = T(0), im = T(0);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const T er = e[2 * (2 * i + j)], ei = e[2 * (2 * i + j) + 1];
                    const T xr = fr[2 * (2 * j + kk)], xi = fr[2 * (2 * j + kk) + 1];
                    re += er * xr - ei * xi;
                    im += er * xi + ei * xr;
                }
                o8[2 * (2 * i + kk)] = re;
                o8[2 * (2 * i + kk) + 1] = im;
            }
        }
        store<8>(out + o * 8, o8);
    } else {
        store<2 * C>(out + o * (2 * C), e);
    }
}

template <typename T, int C, bool NORM>
int interp(const void* slabs, const void* vl, const void* vm, const int* gc0,
           const int* gc1, const void* wlo, void* out, int nsamp, int nrows, int ncol,
           int nud, int lw, int mh, int rows, int lanes, int spt, cudaStream_t stream) {
    const long long xblocks = ((long long)nsamp + (long long)lanes * spt - 1) /
                              ((long long)lanes * spt);
    const int yblocks = (nrows + rows - 1) / rows;
    if (xblocks > 0x7fffffffLL || yblocks > 65535) return (int)cudaErrorInvalidValue;
    const dim3 block(NORM ? 1 : 3, rows, lanes);
    beam_interp_kernel<T, C, NORM><<<dim3((unsigned)xblocks, yblocks), block, 0, stream>>>(
        static_cast<const T*>(slabs), static_cast<const T*>(vl), static_cast<const T*>(vm),
        gc0, gc1, static_cast<const T*>(wlo), static_cast<T*>(out), nsamp, nrows, ncol,
        nrows / ncol, nud, lw, mh, spt);
    return (int)cudaGetLastError();
}

template <typename T, int C, bool CELL, bool FEED>
int blend(const void* coef, const void* lda, const void* mda, const int* gc0,
          const void* wlo, const void* feed, void* out, int nsamp, int nud, int nchan,
          int nta, cudaStream_t stream) {
    const size_t smem = (size_t)(CELL ? 4 : 1) * nud * 3 * C * sizeof(T);
    const int nctile = (nchan + BLEND_THREADS - 1) / BLEND_THREADS;
    const long long blocks = (long long)nsamp * nctile;
    if (smem > (size_t)BLEND_SMEM || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    beam_blend_kernel<T, C, CELL, FEED><<<(unsigned)blocks, BLEND_THREADS, smem, stream>>>(
        static_cast<const T*>(coef), static_cast<const T*>(lda), static_cast<const T*>(mda),
        gc0, static_cast<const T*>(wlo), static_cast<const T*>(feed), static_cast<T*>(out),
        nud, nchan, nctile, nta);
    return (int)cudaGetLastError();
}

template <typename T, bool CELL>
int blend_any(const void* coef, const void* lda, const void* mda, const int* gc0,
              const void* wlo, const void* feed, void* out, int nsamp, int nud, int nchan,
              int ncorr, int nta, cudaStream_t stream) {
    if (feed != nullptr) {
        if (ncorr != 4 || nta <= 0 || nsamp % nta != 0) return (int)cudaErrorInvalidValue;
        return blend<T, 4, CELL, true>(coef, lda, mda, gc0, wlo, feed, out, nsamp, nud,
                                       nchan, nta, stream);
    }
#define CALL(C) blend<T, C, CELL, false>(coef, lda, mda, gc0, wlo, feed, out, nsamp, nud, \
                                         nchan, 1, stream)
    switch (ncorr) {
        case 1: return CALL(1);
        case 2: return CALL(2);
        case 4: return CALL(4);
        default: return (int)cudaErrorInvalidValue;
    }
#undef CALL
}

}  // namespace

// slabs: (nud, lw, mh, 3 * ncorr) T, 16-byte aligned; vl, vm: (nsamp, ncol)
// T; gc0, gc1: (nrows,) int32 slab indices; wlo: (nrows,) T weight of slab
// gc0; out: (nsamp, nrows, 3 * ncorr) T raw sums, or (nsamp, nrows, ncorr)
// complex T when normalize. nrows must be a multiple of ncol. The layout
// (rows, lanes, spt) is ops/cuda_beam.interp_layout's: blocks of
// (normalize ? 1 : 3) x rows x lanes threads, each taking spt samples. T is
// double when is_double, else float. Returns cudaGetLastError() after the
// launch.
extern "C" int beam_interp_launch(const void* slabs, const void* vl, const void* vm,
                                  const int* gc0, const int* gc1, const void* wlo,
                                  void* out, int nsamp, int nrows, int ncol, int nud,
                                  int lw, int mh, int ncorr, int normalize, int is_double,
                                  int rows, int lanes, int spt, void* stream) {
    if (nsamp == 0 || nrows == 0) return (int)cudaSuccess;
    if (nsamp < 0 || ncol <= 0 || nrows % ncol != 0 || nud < 1 || lw < 1 || mh < 1)
        return (int)cudaErrorInvalidValue;
    // the layout: a row table of at most INTERP_ROWS, at most INTERP_THREADS
    // threads, and a cell offset (l * mh + m) * 3C that fits an int
    if (rows < 1 || rows > INTERP_ROWS || lanes < 1 || spt < 1 ||
        (normalize ? 1 : 3) * rows * lanes > INTERP_THREADS ||
        (long long)lw * mh * 3 * ncorr > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, C, N) interp<T, C, N>(slabs, vl, vm, gc0, gc1, wlo, out, nsamp, nrows, \
                                      ncol, nud, lw, mh, rows, lanes, spt, st)
#define CORRS(T, N)                           \
    switch (ncorr) {                          \
        case 1: return CALL(T, 1, N);         \
        case 2: return CALL(T, 2, N);         \
        case 4: return CALL(T, 4, N);         \
        default: return (int)cudaErrorInvalidValue; \
    }
    if (is_double) {
        if (normalize) { CORRS(double, true) }
        CORRS(double, false)
    }
    if (normalize) { CORRS(float, true) }
    CORRS(float, false)
#undef CORRS
#undef CALL
}

// raw: (nsamp, nud, 3 * ncorr) T per-slab raw sums; gc0: (nchan,) int32
// lower slab (clamped to [0, nud - 2]); wlo: (nchan,) T its weight; feed:
// null, or (nta, 2, 2) complex T with nsamp a multiple of nta and ncorr 4;
// out: (nsamp, nchan, ncorr) complex T.
extern "C" int beam_blend_launch(const void* raw, const int* gc0, const void* wlo,
                                 const void* feed, void* out, int nsamp, int nud,
                                 int nchan, int ncorr, int nta, int is_double,
                                 void* stream) {
    if (nsamp == 0 || nchan == 0) return (int)cudaSuccess;
    if (nsamp < 0 || nchan < 0 || nud < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return blend_any<double, false>(raw, nullptr, nullptr, gc0, wlo, feed, out, nsamp,
                                        nud, nchan, ncorr, nta, st);
    return blend_any<float, false>(raw, nullptr, nullptr, gc0, wlo, feed, out, nsamp, nud,
                                   nchan, ncorr, nta, st);
}

// bterms: (nsamp, 4, nud, 3 * ncorr) T bilinear cell coefficients per slab
// ([c00 | c10 - c00 | c01 - c00 | c11 - c10 - c01 + c00]); lda, mda:
// (nsamp, nchan) T in-cell offsets; the rest as beam_blend_launch.
extern "C" int beam_blend_cell_launch(const void* bterms, const void* lda,
                                      const void* mda, const int* gc0, const void* wlo,
                                      const void* feed, void* out, int nsamp, int nud,
                                      int nchan, int ncorr, int nta, int is_double,
                                      void* stream) {
    if (nsamp == 0 || nchan == 0) return (int)cudaSuccess;
    if (nsamp < 0 || nchan < 0 || nud < 2) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return blend_any<double, true>(bterms, lda, mda, gc0, wlo, feed, out, nsamp, nud,
                                       nchan, ncorr, nta, st);
    return blend_any<float, true>(bterms, lda, mda, gc0, wlo, feed, out, nsamp, nud, nchan,
                                  ncorr, nta, st);
}
