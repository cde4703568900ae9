// Multi-correlation 2D convolutional gridding and degridding (no w-stack),
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   grid:    G[c, iu0+a, iv0+b] += es((uf-a)/(W/2)) * es((vf-b)/(W/2)) * V[c]
//   degrid:  V[c] = sum_a es((uf-a)/(W/2)) sum_b es((vf-b)/(W/2)) * G[c, iu0+a, iv0+b]
//
// over a, b = 0..W-1 and the correlations c < NC (1, 2 or 4), with the uv
// indices wrapping mod (nu, nv). es is the exponential of semicircle, zero
// outside |z| < 1, as in africanus_tpu_torch/ops/es.py and wgrid.cu. The ES
// window of a sample is computed once and applied to every correlation.
// The per-sample geometry (window starts iu0, iv0, offsets uf, vf, and the
// samples' order sorted by owning uv tile) is the one-plane
// ops/cuda_wgrid.WGridPlan, planned in float64 on the host; T, the
// accumulator type, is float or double.
//
// Replaces the four Pallas TPU kernels of africanus_tpu/ops/pallas_grid.py
// that compute these two maps for the nifty-API gridder:
//   grid_tiles_pallas / _grid_kernel (per-sample read-modify-write of the
//     ES block into ncorr padded tiles) and grid_tiles_mxu /
//     _grid_mxu_kernel (the same deposit as (tpad_r, S) @ (S, tpad_c)
//     dots per correlation), plus the XLA halo fold assemble_tiles; and
//   degrid_tiles_pallas / _degrid_kernel and degrid_tiles_mxu /
//     _degrid_mxu_kernel (the gather mirror), plus extract_tiles and the
//     _degrid_unpack gather-sum.
// The maps carry over, not the schedules: no 8-aligned row blocks, no
// 128-lane column padding, no groups, no MXU dots.
//
// What bounds them on an H100: bytes. At the nifty cell of chip_smoke.py
// (800,000 samples x 4 correlations, W = 8, a 4 x 2048^2 complex64 grid)
// the map moves ~172 MB (geometry 12.8 MB, visibilities 25.6 MB, the grid
// 134 MB): 0.051 ms at 3.35 TB/s, against ~0.45 GFP32 instructions (64
// taps x (1 + 2 x 4) per sample, 16 ES taps of ~20): 0.014 ms at
// 3.35e13/s. What the design does about it, and what it leaves for later:
//  - grid: one block per uv tile of the plan (32 x 32 cells: the padded
//    tiles of all NC correlations, 4 x 39^2 x 8 B = 49 KB at W = 8, stay in
//    shared memory), NC warps, warp c owning correlation c's tile. The
//    block stages CHUNK samples at a time (the ES taps once per sample,
//    the NC values, the window offset); each warp takes them in plan order,
//    its lanes splitting the W^2 taps (distinct cells), a __syncwarp
//    between samples. No two warps touch one cell: no atomics, one fixed
//    sum order per cell, bitwise-equal launches. The halos are folded by
//    wgrid.cu's fold kernel (wgrid_fold_launch, correlations as planes)
//    from the plan's tables, wrapping mod nu, nv: any grid size, ragged
//    edge tiles. The tiles are written once and read once by the fold
//    (~1.5x the grid at W = 8): that, the shared-memory read-modify-writes
//    and idle lanes at W^2 < 64 are this design's cost over the byte bound.
//  - degrid: one thread per sample in tile order (a warp's windows meet in
//    L1/L2), the ES window once, every correlation summed over its W^2
//    wrapped cells in a fixed order, written to the sample's own row of the
//    (n, NC) output: no permutation, no scatter.
//
// No --use_fast_math: expf/exp and sqrtf/sqrt are the accurate library
// versions, and the strict |z| < 1 cutoff is decided on the same
// (u - a) / (W/2) as the plain versions.

#include <cuda_runtime.h>

namespace {

constexpr int BUDGET = 128 * 1024;  // grid kernel: shared memory per block, at most
constexpr int CHUNK = 64;           // grid kernel: samples staged per pass
constexpr int DEGRID_THREADS = 128;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ float2 vec2(float x, float y) { return make_float2(x, y); }
__device__ __forceinline__ double2 vec2(double x, double y) { return make_double2(x, y); }

__device__ __forceinline__ float es_tap(float z, float beta) {
    return fabsf(z) < 1.0f ? expf(beta * (sqrtf(1.0f - z * z) - 1.0f)) : 0.0f;
}

__device__ __forceinline__ double es_tap(double z, double beta) {
    return fabs(z) < 1.0 ? exp(beta * (sqrt(1.0 - z * z) - 1.0)) : 0.0;
}

__device__ __forceinline__ int pmod(int x, int n) {
    const int r = x % n;
    return r < 0 ? r + n : r;
}

template <typename T, int W, int NC>
constexpr size_t spread_smem(size_t ru, size_t rv) {
    using V2 = typename Vec2<T>::type;
    return NC * ru * rv * sizeof(V2)
           + CHUNK * (2 * W * sizeof(T) + NC * sizeof(V2) + sizeof(int));
}

// One block per uv tile, warp c owning correlation c. tiles: (ntiles, NC,
// ru, rv) with ru = tile_u + W - 1, rv = tile_v + W - 1, every cell
// written. vis element (c, s) at vis[c * cs + s * ss].
template <typename T, int W, int NC>
__global__ void __launch_bounds__(NC * 32)
grid2d_spread_kernel(const int* __restrict__ order, const int* __restrict__ tile_start,
                     const int* __restrict__ iu0, const int* __restrict__ iv0,
                     const T* __restrict__ uf, const T* __restrict__ vf,
                     const typename Vec2<T>::type* __restrict__ vis, long long cs,
                     long long ss, typename Vec2<T>::type* __restrict__ tiles,
                     int nu, int nv, int tile_u, int tile_v, int ntv, T beta) {
    using V2 = typename Vec2<T>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    const int ru = tile_u + W - 1, rv = tile_v + W - 1;
    const int tile = blockIdx.x;
    const int cells = NC * ru * rv;

    V2* acc = reinterpret_cast<V2*>(smem);                 // (NC, ru, rv)
    V2* s_val = acc + (size_t)cells;                       // (CHUNK, NC)
    T* s_ku = reinterpret_cast<T*>(s_val + CHUNK * NC);   // (CHUNK, W) each
    T* s_kv = s_ku + CHUNK * W;
    int* s_off = reinterpret_cast<int*>(s_kv + CHUNK * W); // local row * rv + col

    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = vec2(T(0), T(0));

    const int c = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int tu = tile / ntv, tv = tile - tu * ntv;
    const int lo = tile_start[tile], hi = tile_start[tile + 1];
    const T half = T(W) / T(2);
    V2* plane = acc + (size_t)c * ru * rv;
    for (int c0 = lo; c0 < hi; c0 += CHUNK) {
        const int cn = min(CHUNK, hi - c0);
        for (int q = threadIdx.x; q < cn; q += blockDim.x) {  // stage sample c0 + q
            const int s = order[c0 + q];
            s_off[q] = (pmod(iu0[s], nu) - tu * tile_u) * rv + pmod(iv0[s], nv) - tv * tile_v;
            const T u = uf[s], v = vf[s];
#pragma unroll
            for (int a = 0; a < W; ++a) {
                s_ku[q * W + a] = es_tap((u - T(a)) / half, beta);
                s_kv[q * W + a] = es_tap((v - T(a)) / half, beta);
            }
#pragma unroll
            for (int k = 0; k < NC; ++k) s_val[q * NC + k] = vis[k * cs + s * ss];
        }
        __syncthreads();  // staged, and (first pass) the tile zeroed
        for (int j = 0; j < cn; ++j) {
            const V2 x = s_val[j * NC + c];
            const T* ku = s_ku + j * W;
            const T* kv = s_kv + j * W;
            V2* win = plane + s_off[j];
            for (int k = lane; k < W * W; k += 32) {
                const int a = k / W, b = k - a * W;
                const T tap = ku[a] * kv[b];
                V2& cell = win[a * rv + b];
                cell.x += tap * x.x;
                cell.y += tap * x.y;
            }
            __syncwarp();  // sample j lands before sample j + 1 reads
        }
        __syncthreads();  // every warp is done with the staged chunk
    }
    V2* dst = tiles + (size_t)tile * cells;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = acc[i];
}

// One thread per sample, samples in the plan's tile-sorted order; out: (n,
// NC), sample s's correlations at out[s * NC + c].
template <typename T, int W, int NC>
__global__ void __launch_bounds__(DEGRID_THREADS)
grid2d_degrid_kernel(const int* __restrict__ order, const int* __restrict__ iu0,
                     const int* __restrict__ iv0, const T* __restrict__ uf,
                     const T* __restrict__ vf,
                     const typename Vec2<T>::type* __restrict__ grid,
                     typename Vec2<T>::type* __restrict__ out, int n, int nu, int nv,
                     T beta) {
    using V2 = typename Vec2<T>::type;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int s = order[i];
    const T half = T(W) / T(2);
    const T u = uf[s], v = vf[s];
    const int u0 = pmod(iu0[s], nu), v0 = pmod(iv0[s], nv);
    T ku[W], kv[W];
    size_t row[W];
    int col[W];
#pragma unroll
    for (int a = 0; a < W; ++a) {
        ku[a] = es_tap((u - T(a)) / half, beta);
        kv[a] = es_tap((v - T(a)) / half, beta);
        row[a] = (size_t)((u0 + a) % nu) * nv;
        col[a] = (v0 + a) % nv;
    }
    const size_t plane = (size_t)nu * nv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const V2* g = grid + (size_t)c * plane;
        T ar = T(0), ai = T(0);
#pragma unroll
        for (int a = 0; a < W; ++a) {
            T br = T(0), bi = T(0);
#pragma unroll
            for (int b = 0; b < W; ++b) {
                const V2 x = g[row[a] + col[b]];
                br += kv[b] * x.x;
                bi += kv[b] * x.y;
            }
            ar += ku[a] * br;
            ai += ku[a] * bi;
        }
        out[(size_t)s * NC + c] = vec2(ar, ai);
    }
}

template <typename T, int W, int NC>
int spread(const int* order, const int* tile_start, const int* iu0, const int* iv0,
           const void* uf, const void* vf, const void* vis, long long cs,
           long long ss, void* tiles, int nu, int nv, int tile_u, int tile_v,
           int ntiles, int ntv, double beta, cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const size_t smem = spread_smem<T, W, NC>(tile_u + W - 1, tile_v + W - 1);
    if (smem > (size_t)BUDGET) return (int)cudaErrorInvalidValue;
    grid2d_spread_kernel<T, W, NC><<<ntiles, NC * 32, smem, stream>>>(
        order, tile_start, iu0, iv0, static_cast<const T*>(uf),
        static_cast<const T*>(vf), static_cast<const V2*>(vis), cs, ss,
        static_cast<V2*>(tiles), nu, nv, tile_u, tile_v, ntv, (T)beta);
    return (int)cudaGetLastError();
}

template <typename T, int W, int NC>
int degrid(const int* order, const int* iu0, const int* iv0, const void* uf,
           const void* vf, const void* grid, void* out, int n, int nu, int nv,
           double beta, cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const int blocks = (n + DEGRID_THREADS - 1) / DEGRID_THREADS;
    grid2d_degrid_kernel<T, W, NC><<<blocks, DEGRID_THREADS, 0, stream>>>(
        order, iu0, iv0, static_cast<const T*>(uf), static_cast<const T*>(vf),
        static_cast<const V2*>(grid), static_cast<V2*>(out), n, nu, nv, (T)beta);
    return (int)cudaGetLastError();
}

template <typename T, int W, int NC>
int allow_budget() {
    return (int)cudaFuncSetAttribute(grid2d_spread_kernel<T, W, NC>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     BUDGET);
}

template <typename T, int W>
int allow_budget_all() {
    int err = allow_budget<T, W, 1>();
    err = err ? err : allow_budget<T, W, 2>();
    return err ? err : allow_budget<T, W, 4>();
}

}  // namespace

// Lets every grid kernel instance take BUDGET bytes of dynamic shared
// memory on the current device (above the default 48 KB). Called once per
// device before the first launch, outside any CUDA-graph capture.
extern "C" int grid2d_init() {
    int err = 0;
    err = err ? err : allow_budget_all<float, 4>();
    err = err ? err : allow_budget_all<float, 6>();
    err = err ? err : allow_budget_all<float, 8>();
    err = err ? err : allow_budget_all<float, 10>();
    err = err ? err : allow_budget_all<double, 4>();
    err = err ? err : allow_budget_all<double, 6>();
    err = err ? err : allow_budget_all<double, 8>();
    err = err ? err : allow_budget_all<double, 10>();
    return err;
}

#define GRID2D_CORRS(CALL, T, W)          \
    switch (ncorr) {                      \
        case 1: return CALL(T, W, 1);     \
        case 2: return CALL(T, W, 2);     \
        case 4: return CALL(T, W, 4);     \
        default: return (int)cudaErrorInvalidValue; \
    }

#define GRID2D_SUPPORTS(CALL, T)                       \
    switch (support) {                                 \
        case 4: GRID2D_CORRS(CALL, T, 4)               \
        case 6: GRID2D_CORRS(CALL, T, 6)               \
        case 8: GRID2D_CORRS(CALL, T, 8)               \
        case 10: GRID2D_CORRS(CALL, T, 10)             \
        default: return (int)cudaErrorInvalidValue;    \
    }

// order: (n,) int32 samples sorted stably by owning tile; tile_start:
// (ntiles + 1,) int32 offsets into it. iu0, iv0: (n,) int32 window starts;
// uf, vf: (n,) T offsets; vis: complex T, element (c, s) at c * cs + s * ss
// (elements, not bytes). tiles: (ntiles, ncorr, tile_u + W - 1, tile_v + W
// - 1) complex T, every cell written; fold them with wgrid_fold_launch
// (nplanes = ncorr). Refused (invalid value) if a block would take more
// than BUDGET bytes. T is double when is_double, else float. Returns
// cudaGetLastError() after the launch.
extern "C" int grid2d_spread_launch(const int* order, const int* tile_start,
                                    const int* iu0, const int* iv0, const void* uf,
                                    const void* vf, const void* vis, long long cs,
                                    long long ss, void* tiles, int nu, int nv,
                                    int support, int ncorr, int tile_u, int tile_v,
                                    int ntiles, int ntv, double beta, int is_double,
                                    void* stream) {
    if (ntiles <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W, NC) spread<T, W, NC>(order, tile_start, iu0, iv0, uf, vf, vis, cs, ss, \
                                        tiles, nu, nv, tile_u, tile_v, ntiles, ntv,      \
                                        beta, st)
    if (is_double) { GRID2D_SUPPORTS(CALL, double) }
    GRID2D_SUPPORTS(CALL, float)
#undef CALL
}

// order, iu0, iv0, uf, vf as for the spread; grid: (ncorr, nu, nv) complex
// T; out: (n, ncorr) complex T, every element written.
extern "C" int grid2d_degrid_launch(const int* order, const int* iu0, const int* iv0,
                                    const void* uf, const void* vf, const void* grid,
                                    void* out, int n, int nu, int nv, int support,
                                    int ncorr, double beta, int is_double,
                                    void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W, NC) degrid<T, W, NC>(order, iu0, iv0, uf, vf, grid, out, n, nu, nv, \
                                        beta, st)
    if (is_double) { GRID2D_SUPPORTS(CALL, double) }
    GRID2D_SUPPORTS(CALL, float)
#undef CALL
}
