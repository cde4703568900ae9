// w-stacked convolutional gridding and degridding, for Hopper (sm_90a),
// with a plain C interface loaded through ctypes.
//
//   grid:    G[p0+t, iu0+a, iv0+b] += wsc[t] * es((uf-a)/(W/2)) * es((vf-b)/(W/2)) * V
//   degrid:  V = sum_t wsc[t] sum_a es((uf-a)/(W/2)) sum_b es((vf-b)/(W/2)) * G[p0+t, iu0+a, iv0+b]
//
// over a = 0..W-1, b = 0..W-1 and the sample's w-taps t = 0..wsup-1
// (wsup = W on a w-stack, 1 without one), with the uv indices wrapping mod
// (nu, nv) and the planes never wrapping (the host plan raises on a window
// outside the stack). es is the exponential of semicircle, zero outside
// |z| < 1, as in africanus_tpu_torch/ops/es.py. Everything per sample (the
// window start iu0, iv0, p0, the fractional offsets uf, vf and the w-taps
// wsc) is planned once on the host in float64 (ops/cuda_wgrid.WGridPlan)
// and carried here in T, the accumulator type: float, or double for the
// wgridder's double_accum.
//
// Replaces the four Pallas TPU kernels of africanus_tpu/ops/pallas_grid.py
// that compute these two maps:
//   grid_tiles_wstack_mxu / _grid_wstack_mxu_kernel (per-plane outer-product
//     dots on the MXU) and grid_tiles_wstack_pallas / _grid_wstack_kernel
//     (per-sample scatter read-modify-write), plus the XLA halo fold
//     assemble_wstack_tiles; and
//   degrid_tiles_wstack_mxu / _degrid_wstack_mxu_kernel and
//     degrid_tiles_wstack_pallas / _degrid_wstack_kernel (per-sample
//     gather), plus extract_wstack_tiles and the vis_slot permutation.
// The maps carry over, not the schedules: no lane-aligned windows, no
// row buckets or supergroups, no bf16x3 dots.
//
// What bounds them on an H100: bytes. Per sample the kernels read 44-56
// bytes of plan and visibility and do W^2*wsup taps of ~5 flops (216 at
// W = 6: ~1e3 flops); at bench config 4 (800k samples, a 9 x 1024^2
// complex64 grid of 75 MB) that is ~120 MB of compulsory traffic (~36 us
// at 3.35 TB/s) against ~1e9 flops (~15 us at 67 TFLOP/s). What the
// design does about it, and what it leaves for later:
//  - grid: the host sorts the samples stably by the uv tile that holds
//    their window start and decides the whole launch layout
//    (ops/cuda_wgrid.py): the tile edge (so that a tile's whole stack fits
//    32 KB: 16 at W = 6 and 9 planes, 10 at 17 planes), the planes of a
//    tile one block holds (all of them unless the stack is deep) and the
//    samples staged per pass; here the launch only checks that a block
//    fits TILE_BUDGET and that the count is CHUNK. One block owns one
//    tile (or one block of its planes) and keeps the tile plus its W-1
//    halo, for its planes, in shared memory. It stages CHUNK samples at a
//    time (ES taps computed once per sample, W * V per w-tap), then each
//    warp owns whole planes: it takes the staged samples in plan order
//    and, for each one whose window meets its plane, its lanes split the
//    W^2 taps (distinct cells) and a __syncwarp separates consecutive
//    samples. No two warps touch one cell, so there is no barrier per
//    sample, no atomics, every cell sums its contributions in one fixed
//    order, and two launches give bitwise-equal grids. The grid is written once; a second kernel folds
//    each cell's halo copies (at most a few padded tiles cover a cell) in a
//    fixed order from host-built tables, wrapping mod nu, nv, so any grid
//    size and ragged edge tiles need no special case. The halo re-reads
//    (~1.7x the grid at a 16-cell tile), the shared-memory read-modify-
//    writes and idle lanes (36 taps on 64 lane slots at W = 6) are this
//    design's cost over the byte bound.
//  - degrid: one thread per sample, in the same tile-sorted order (so a
//    warp's windows overlap in L1/L2), reads its W^2*wsup wrapped cells and
//    sums them in a fixed order; the value goes to the sample's own index,
//    so there is no permutation and no scatter.
//
// No --use_fast_math: expf/exp and sqrtf/sqrt are the accurate library
// versions, and the strict |z| < 1 cutoff is decided on the same
// (u - a) / (W/2) as the plain versions.

#include <cuda_runtime.h>

namespace {

constexpr int GRID_WARPS = 32;           // grid kernel: warps per block, at most
constexpr int TILE_BUDGET = 112 * 1024;  // grid kernel: shared memory per block, at most
// grid kernel: samples staged per pass. A compile-time constant (a count
// passed at launch made the spread kernel slower at config 4); the host
// lays a block out for the count it passes, and the launch refuses any
// other.
constexpr int CHUNK = 128;
constexpr int FOLD_THREADS = 256;
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

// One block per (uv tile, plane block), one warp per plane (a warp loops
// over several planes when the block has more than GRID_WARPS). tiles:
// (ntiles, nplanes, ru, rv) with ru = tile_u + W - 1, rv = tile_v + W - 1;
// the block writes its planes [pb0, pb0 + npb) of its tile whole, zeros
// included. It stages CHUNK samples per pass.
template <typename T, int W>
__global__ void __launch_bounds__(GRID_WARPS * 32)
wgrid_spread_kernel(const int* __restrict__ order, const int* __restrict__ tile_start,
                    const int* __restrict__ iu0, const int* __restrict__ iv0,
                    const int* __restrict__ p0, const T* __restrict__ uf,
                    const T* __restrict__ vf, const T* __restrict__ wsc,
                    const typename Vec2<T>::type* __restrict__ vis,
                    typename Vec2<T>::type* __restrict__ tiles, int n, int nu,
                    int nv, int nplanes, int wsup, int tile_u, int tile_v,
                    int ntv, int plane_block, int nblk, T beta) {
    using V2 = typename Vec2<T>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    const int ru = tile_u + W - 1, rv = tile_v + W - 1;
    const int tile = blockIdx.x / nblk;
    const int pb0 = (blockIdx.x % nblk) * plane_block;
    const int npb = min(plane_block, nplanes - pb0);
    const int cells = npb * ru * rv;

    V2* acc = reinterpret_cast<V2*>(smem);  // (plane_block, ru, rv)
    T* s_ku = reinterpret_cast<T*>(acc + (size_t)plane_block * ru * rv);
    T* s_kv = s_ku + CHUNK * W;                            // (CHUNK, W) each
    V2* s_wv = reinterpret_cast<V2*>(s_kv + CHUNK * W);    // (CHUNK, W): wsc * V
    int* s_off = reinterpret_cast<int*>(s_wv + CHUNK * W); // local row * rv + col
    int* s_p = s_off + CHUNK;                              // p0 - pb0

    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = vec2(T(0), T(0));

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nwarps = blockDim.x / 32;
    const int tu = tile / ntv, tv = tile - tu * ntv;
    const int lo = tile_start[tile], hi = tile_start[tile + 1];
    const T half = T(W) / T(2);
    for (int c0 = lo; c0 < hi; c0 += CHUNK) {
        const int cn = min(CHUNK, hi - c0);
        for (int q = threadIdx.x; q < cn; q += blockDim.x) {  // stage sample c0 + q
            const int s = order[c0 + q];
            s_off[q] = (pmod(iu0[s], nu) - tu * tile_u) * rv + pmod(iv0[s], nv) - tv * tile_v;
            s_p[q] = p0[s] - pb0;
            const T u = uf[s], v = vf[s];
#pragma unroll
            for (int a = 0; a < W; ++a) {
                s_ku[q * W + a] = es_tap((u - T(a)) / half, beta);
                s_kv[q * W + a] = es_tap((v - T(a)) / half, beta);
            }
            const V2 x = vis[s];
            for (int t = 0; t < wsup; ++t) {
                const T w = wsc[(size_t)t * n + s];
                s_wv[q * W + t] = vec2(w * x.x, w * x.y);
            }
        }
        __syncthreads();  // staged, and (first pass) the tile zeroed
        for (int pl = warp; pl < npb; pl += nwarps) {
            V2* plane = acc + (size_t)pl * ru * rv;
            for (int j = 0; j < cn; ++j) {
                const int t = pl - s_p[j];  // the same for every lane
                if (t < 0 || t >= wsup) continue;
                const V2 wv = s_wv[j * W + t];
                const T* ku = s_ku + j * W;
                const T* kv = s_kv + j * W;
                V2* win = plane + s_off[j];
                for (int k = lane; k < W * W; k += 32) {
                    const int a = k / W, b = k - a * W;
                    const T tap = ku[a] * kv[b];
                    V2& cell = win[a * rv + b];
                    cell.x += tap * wv.x;
                    cell.y += tap * wv.y;
                }
                __syncwarp();  // sample j lands before sample j + 1 reads
            }
        }
        __syncthreads();  // every warp is done with the staged chunk
    }
    V2* dst = tiles + ((size_t)tile * nplanes + pb0) * ru * rv;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = acc[i];
}

// grid[p, gu, gv] = sum of the padded-tile cells that cover (gu, gv), in
// the fixed order of the host tables src_u (nu, ku) and src_v (nv, kv):
// entries tile_row * ru + local_row (resp. tile_col * rv + local_col),
// -1 past the end.
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
wgrid_fold_kernel(const typename Vec2<T>::type* __restrict__ tiles,
                  const int* __restrict__ src_u, const int* __restrict__ src_v,
                  typename Vec2<T>::type* __restrict__ grid, int nplanes, int nu,
                  int nv, int ku, int kv, int ntv, int ru, int rv) {
    using V2 = typename Vec2<T>::type;
    const size_t total = (size_t)nplanes * nu * nv;
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int gv = (int)(idx % nv);
    const size_t rest = idx / nv;
    const int gu = (int)(rest % nu);
    const int p = (int)(rest / nu);
    T sr = T(0), si = T(0);
    for (int i = 0; i < ku; ++i) {
        const int eu = src_u[(size_t)gu * ku + i];
        if (eu < 0) break;
        const int tu = eu / ru, r = eu - tu * ru;
        for (int j = 0; j < kv; ++j) {
            const int ev = src_v[(size_t)gv * kv + j];
            if (ev < 0) break;
            const int tv = ev / rv, c = ev - tv * rv;
            const V2 x = tiles[(((size_t)(tu * ntv + tv) * nplanes + p) * ru + r) * rv + c];
            sr += x.x;
            si += x.y;
        }
    }
    grid[idx] = vec2(sr, si);
}

// One thread per sample, samples in the plan's tile-sorted order.
template <typename T, int W>
__global__ void __launch_bounds__(DEGRID_THREADS)
wgrid_degrid_kernel(const int* __restrict__ order, const int* __restrict__ iu0,
                    const int* __restrict__ iv0, const int* __restrict__ p0,
                    const T* __restrict__ uf, const T* __restrict__ vf,
                    const T* __restrict__ wsc,
                    const typename Vec2<T>::type* __restrict__ grid,
                    typename Vec2<T>::type* __restrict__ out, int n, int nu,
                    int nv, int wsup, T beta) {
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
    const int pbase = p0[s];
    T sr = T(0), si = T(0);
    for (int t = 0; t < wsup; ++t) {
        const V2* g = grid + (size_t)(pbase + t) * plane;
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
        const T w = wsc[(size_t)t * n + s];
        sr += w * ar;
        si += w * ai;
    }
    out[s] = vec2(sr, si);
}

template <typename T, int W>
int spread(const int* order, const int* tile_start, const int* iu0,
           const int* iv0, const int* p0, const void* uf, const void* vf,
           const void* wsc, const void* vis, void* tiles, int n, int nu, int nv,
           int nplanes, int wsup, int tile_u, int tile_v, int ntiles, int ntv,
           int plane_block, int chunk, double beta, cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const size_t ru = tile_u + W - 1, rv = tile_v + W - 1;
    const size_t stage = (size_t)CHUNK * (2 * W * sizeof(T) + W * sizeof(V2) + 2 * sizeof(int));
    const size_t smem = (size_t)plane_block * ru * rv * sizeof(V2) + stage;
    if (plane_block <= 0 || chunk != CHUNK || smem > (size_t)TILE_BUDGET)
        return (int)cudaErrorInvalidValue;
    const int nblk = (nplanes + plane_block - 1) / plane_block;
    const int threads = 32 * (plane_block < GRID_WARPS ? plane_block : GRID_WARPS);
    wgrid_spread_kernel<T, W><<<ntiles * nblk, threads, smem, stream>>>(
        order, tile_start, iu0, iv0, p0, static_cast<const T*>(uf),
        static_cast<const T*>(vf), static_cast<const T*>(wsc),
        static_cast<const V2*>(vis), static_cast<V2*>(tiles), n, nu, nv, nplanes,
        wsup, tile_u, tile_v, ntv, plane_block, nblk, (T)beta);
    return (int)cudaGetLastError();
}

template <typename T, int W>
int degrid(const int* order, const int* iu0, const int* iv0, const int* p0,
           const void* uf, const void* vf, const void* wsc, const void* grid,
           void* out, int n, int nu, int nv, int wsup, double beta,
           cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const int blocks = (n + DEGRID_THREADS - 1) / DEGRID_THREADS;
    wgrid_degrid_kernel<T, W><<<blocks, DEGRID_THREADS, 0, stream>>>(
        order, iu0, iv0, p0, static_cast<const T*>(uf), static_cast<const T*>(vf),
        static_cast<const T*>(wsc), static_cast<const V2*>(grid),
        static_cast<V2*>(out), n, nu, nv, wsup, (T)beta);
    return (int)cudaGetLastError();
}

template <typename T, int W>
int allow_tile_budget() {
    return (int)cudaFuncSetAttribute(wgrid_spread_kernel<T, W>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     TILE_BUDGET);
}

}  // namespace

// Lets every grid kernel instance take TILE_BUDGET bytes of dynamic shared
// memory on the current device (above the default 48 KB). Called once per
// device before the first launch, outside any CUDA-graph capture.
extern "C" int wgrid_init() {
    int err = 0;
    err = err ? err : allow_tile_budget<float, 4>();
    err = err ? err : allow_tile_budget<float, 6>();
    err = err ? err : allow_tile_budget<float, 8>();
    err = err ? err : allow_tile_budget<float, 10>();
    err = err ? err : allow_tile_budget<double, 4>();
    err = err ? err : allow_tile_budget<double, 6>();
    err = err ? err : allow_tile_budget<double, 8>();
    err = err ? err : allow_tile_budget<double, 10>();
    return err;
}

#define WGRID_SUPPORTS(CALL, T)        \
    switch (support) {                 \
        case 4: return CALL(T, 4);     \
        case 6: return CALL(T, 6);     \
        case 8: return CALL(T, 8);     \
        case 10: return CALL(T, 10);   \
        default: return (int)cudaErrorInvalidValue; \
    }

// order: (n,) int32 samples sorted stably by owning tile; tile_start:
// (ntiles + 1,) int32 offsets into it. iu0, iv0, p0: (n,) int32 window
// starts; uf, vf: (n,) T offsets; wsc: (wsup, n) T w-taps; vis: (n,)
// complex T. tiles: (ntiles, nplanes, tile_u + W - 1, tile_v + W - 1)
// complex T, every cell written. plane_block planes of a tile per block,
// chunk samples staged per pass: the host's layout, refused (invalid
// value) if chunk is not CHUNK or a block would take more than
// TILE_BUDGET bytes. T is double
// when is_double, else float. Returns cudaGetLastError() after the launch.
extern "C" int wgrid_spread_launch(const int* order, const int* tile_start,
                                   const int* iu0, const int* iv0, const int* p0,
                                   const void* uf, const void* vf, const void* wsc,
                                   const void* vis, void* tiles, int n, int nu,
                                   int nv, int nplanes, int support, int wsup,
                                   int tile_u, int tile_v, int ntiles, int ntv,
                                   int plane_block, int chunk, double beta,
                                   int is_double, void* stream) {
    if (nplanes <= 0 || ntiles <= 0 || (wsup != 1 && wsup != support))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) spread<T, W>(order, tile_start, iu0, iv0, p0, uf, vf, wsc, vis, \
                                tiles, n, nu, nv, nplanes, wsup, tile_u, tile_v,   \
                                ntiles, ntv, plane_block, chunk, beta, st)
    if (is_double) { WGRID_SUPPORTS(CALL, double) }
    WGRID_SUPPORTS(CALL, float)
#undef CALL
}

// tiles as written by wgrid_spread_launch; src_u (nu, ku), src_v (nv, kv)
// int32 fold tables; grid: (nplanes, nu, nv) complex T.
extern "C" int wgrid_fold_launch(const void* tiles, const int* src_u,
                                 const int* src_v, void* grid, int nplanes,
                                 int nu, int nv, int ku, int kv, int ntv, int ru,
                                 int rv, int is_double, void* stream) {
    const size_t total = (size_t)nplanes * nu * nv;
    if (total == 0) return (int)cudaSuccess;
    const unsigned blocks = (unsigned)((total + FOLD_THREADS - 1) / FOLD_THREADS);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        wgrid_fold_kernel<double><<<blocks, FOLD_THREADS, 0, st>>>(
            static_cast<const double2*>(tiles), src_u, src_v,
            static_cast<double2*>(grid), nplanes, nu, nv, ku, kv, ntv, ru, rv);
    else
        wgrid_fold_kernel<float><<<blocks, FOLD_THREADS, 0, st>>>(
            static_cast<const float2*>(tiles), src_u, src_v,
            static_cast<float2*>(grid), nplanes, nu, nv, ku, kv, ntv, ru, rv);
    return (int)cudaGetLastError();
}

// order, iu0, iv0, p0, uf, vf, wsc as for the spread; grid: (nplanes, nu,
// nv) complex T; out: (n,) complex T, every sample written.
extern "C" int wgrid_degrid_launch(const int* order, const int* iu0,
                                   const int* iv0, const int* p0, const void* uf,
                                   const void* vf, const void* wsc,
                                   const void* grid, void* out, int n, int nu,
                                   int nv, int support, int wsup, double beta,
                                   int is_double, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (wsup != 1 && wsup != support) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) degrid<T, W>(order, iu0, iv0, p0, uf, vf, wsc, grid, out, n, \
                                nu, nv, wsup, beta, st)
    if (is_double) { WGRID_SUPPORTS(CALL, double) }
    WGRID_SUPPORTS(CALL, float)
#undef CALL
}
