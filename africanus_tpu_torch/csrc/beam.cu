// Beam-cube interpolation (the E Jones of a direction-dependent predict),
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
// The cube arrives as slabs (ops/cuda_beam.beam_slabs): (nud, lw, mh, 3C)
// values of T, each (l, m) cell of a frequency slab holding C real parts,
// C imaginary parts and C amplitudes |v|. Three kernels:
//
//  beam_interp (replaces beam_interp_pallas / _beam_kernel,
//    africanus_tpu/ops/pallas_beam.py:153/78, pallas_call l.228). Per
//    (sample s, row k): blend slabs gc0[k] and gc1[k] by wlo[k], then
//    bilinear in l and m at the sample's coordinates (vl, vm), in the order
//    of _beam_kernel (blend, then the l rows, then the m columns). Row k
//    reads coordinate column k / (nrows / ncol), so one launch serves the
//    general route (a column per channel), the channel-invariant route (one
//    column, a row per slab) and the cell corners (four columns, a row per
//    slab). Writes the 3C raw sums, or the C amplitude-normalised complex
//    values, at (s, k): no layout pass follows.
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
// What bounds them on an H100: bytes. At config 3 (8 sources x 64
// antennas x 4096 channels = 2,097,152 samples x 4 correlations, a
// 129 x 129 x 8 x 4 cube of 6.4 MB as slabs) each kernel's compulsory
// traffic is its output, 67.1 MB of complex64, plus its inputs: 16.8 MB of
// vl, vm on the general route (~0.027 ms at 3.35 TB/s), 16.8 MB of lda, mda
// for beam_blend_cell (~0.025 ms), the cube for beam_interp on the
// channel-invariant route (~0.002 ms), next to nothing for beam_blend
// (~0.020 ms). A sample takes ~100-300 flops, far below the byte bound.
// What the design does about it:
//  - beam_interp: one thread per (s, k), k fastest, so the coordinates are
//    read and the outputs written contiguously by a warp; each thread reads
//    its 8 corners as 3C contiguous values (16-byte loads where they align)
//    from the cube, which stays in the 50 MB L2. Output as vector stores.
//  - beam_blend(_cell): one block per (sample, 128 channels); the block
//    stages the sample's nud x 3C raw sums (x 4 terms for the cell route) in
//    shared memory, each thread blends, normalises, applies F from registers
//    and writes its C complex values as vector stores, so a warp writes one
//    contiguous run of (s, t, a, f, C) output.
// No atomics and a fixed order of operations: two launches give
// bitwise-equal outputs. No --use_fast_math: sqrt and the division are
// correctly rounded; nvcc may contract a*b + c into FMAs (no error-free
// chains here), which the tolerances against the plain versions allow.

#include <cuda_runtime.h>

namespace {

constexpr int INTERP_THREADS = 256;
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

template <int N>
__device__ __forceinline__ void store(float* __restrict__ dst, const float (&v)[N]) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
            reinterpret_cast<float4*>(dst)[i] =
                make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    } else if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            reinterpret_cast<float2*>(dst)[i] = make_float2(v[2 * i], v[2 * i + 1]);
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) dst[i] = v[i];
    }
}

template <int N>
__device__ __forceinline__ void store(double* __restrict__ dst, const double (&v)[N]) {
    if constexpr (N % 2 == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
            reinterpret_cast<double2*>(dst)[i] = make_double2(v[2 * i], v[2 * i + 1]);
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) dst[i] = v[i];
    }
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// The reference's amplitude-preserving normalisation of C raw sums
// (sums = [re.C | im.C | amp.C]) into C complex values e = [re, im] x C.
template <typename T, int C>
__device__ __forceinline__ void normalise(const T (&sums)[3 * C], T (&e)[2 * C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const T re = sums[c], im = sums[C + c], amp = sums[2 * C + c];
        const T div = sqrt(re * re + im * im);
        const T norm = div == T(0) ? amp : amp / div;
        e[2 * c] = re * norm;
        e[2 * c + 1] = im * norm;
    }
}

// One thread per (sample s, row k) of total = nsamp * nrows, k fastest.
// vl, vm: (nsamp, ncol), already clamped to [0, lw - 1] and [0, mh - 1] (the
// corner indices are clamped too, so no input reads outside the cube); row
// k reads column k / per. gc0, gc1, wlo: (nrows,). out: (nsamp, nrows, 3C)
// raw sums, or (nsamp, nrows, C) complex T when NORM.
template <typename T, int C, bool NORM>
__global__ void __launch_bounds__(INTERP_THREADS)
beam_interp_kernel(const T* __restrict__ slabs, const T* __restrict__ vl,
                   const T* __restrict__ vm, const int* __restrict__ gc0,
                   const int* __restrict__ gc1, const T* __restrict__ wlo,
                   T* __restrict__ out, long long total, int nrows, int ncol, int per,
                   int nud, int lw, int mh) {
    constexpr int K3 = 3 * C;
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const long long s = i / nrows;
    const int k = (int)(i - s * nrows);
    const long long ci = s * ncol + k / per;
    const T l = vl[ci], m = vm[ci];
    const T lf = floor(l), mf = floor(m);
    const T ld = l - lf, md = m - mf;
    const int l0 = clampi((int)lf, 0, lw - 1), m0 = clampi((int)mf, 0, mh - 1);
    const int l1 = min(l0 + 1, lw - 1), m1 = min(m0 + 1, mh - 1);
    const T w0 = wlo[k], w1 = T(1) - w0;
    const size_t slab = (size_t)lw * mh * K3;
    const T* a = slabs + (size_t)clampi(gc0[k], 0, nud - 1) * slab;
    const T* b = slabs + (size_t)clampi(gc1[k], 0, nud - 1) * slab;
    const size_t r0 = (size_t)l0 * mh, r1 = (size_t)l1 * mh;

    // blend the two slabs at a corner, then the l rows at m0 and at m1
    T x[K3], y[K3], t0[K3], t1[K3];
    load<K3>(a + (r0 + m0) * K3, x);
    load<K3>(b + (r0 + m0) * K3, y);
#pragma unroll
    for (int q = 0; q < K3; ++q) t0[q] = w0 * x[q] + w1 * y[q];
    load<K3>(a + (r1 + m0) * K3, x);
    load<K3>(b + (r1 + m0) * K3, y);
#pragma unroll
    for (int q = 0; q < K3; ++q) t0[q] = (T(1) - ld) * t0[q] + ld * (w0 * x[q] + w1 * y[q]);
    load<K3>(a + (r0 + m1) * K3, x);
    load<K3>(b + (r0 + m1) * K3, y);
#pragma unroll
    for (int q = 0; q < K3; ++q) t1[q] = w0 * x[q] + w1 * y[q];
    load<K3>(a + (r1 + m1) * K3, x);
    load<K3>(b + (r1 + m1) * K3, y);
#pragma unroll
    for (int q = 0; q < K3; ++q) t1[q] = (T(1) - ld) * t1[q] + ld * (w0 * x[q] + w1 * y[q]);
    // then the m columns
#pragma unroll
    for (int q = 0; q < K3; ++q) t0[q] = (T(1) - md) * t0[q] + md * t1[q];

    if constexpr (NORM) {
        T e[2 * C];
        normalise<T, C>(t0, e);
        store<2 * C>(out + (size_t)i * (2 * C), e);
    } else {
        store<K3>(out + (size_t)i * K3, t0);
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
            const T b0 = w0 * c[0] + w1 * c[K3];
            const T b1 = w0 * c[stride] + w1 * c[stride + K3];
            const T b2 = w0 * c[2 * stride] + w1 * c[2 * stride + K3];
            const T b3 = w0 * c[3 * stride] + w1 * c[3 * stride + K3];
            val[q] = b0 + la * b1 + ma * b2 + lm * b3;
        }
    } else {
#pragma unroll
        for (int q = 0; q < K3; ++q) val[q] = w0 * s_coef[g * K3 + q] + w1 * s_coef[(g + 1) * K3 + q];
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
           int nud, int lw, int mh, cudaStream_t stream) {
    const long long total = (long long)nsamp * nrows;
    const long long blocks = (total + INTERP_THREADS - 1) / INTERP_THREADS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    beam_interp_kernel<T, C, NORM><<<(unsigned)blocks, INTERP_THREADS, 0, stream>>>(
        static_cast<const T*>(slabs), static_cast<const T*>(vl), static_cast<const T*>(vm),
        gc0, gc1, static_cast<const T*>(wlo), static_cast<T*>(out), total, nrows, ncol,
        nrows / ncol, nud, lw, mh);
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
// complex T when normalize. nrows must be a multiple of ncol. T is double
// when is_double, else float. Returns cudaGetLastError() after the launch.
extern "C" int beam_interp_launch(const void* slabs, const void* vl, const void* vm,
                                  const int* gc0, const int* gc1, const void* wlo,
                                  void* out, int nsamp, int nrows, int ncol, int nud,
                                  int lw, int mh, int ncorr, int normalize, int is_double,
                                  void* stream) {
    if (nsamp == 0 || nrows == 0) return (int)cudaSuccess;
    if (nsamp < 0 || ncol <= 0 || nrows % ncol != 0 || nud < 1 || lw < 1 || mh < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, C, N) interp<T, C, N>(slabs, vl, vm, gc0, gc1, wlo, out, nsamp, nrows, \
                                      ncol, nud, lw, mh, st)
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
