// Table-mode convolutional gridding and degridding (the Perley-polyhedron
// facet gridder's quantised taps), for Hopper (sm_90a), with a plain C
// interface loaded through ctypes.
//
//   grid:    G[band, ir0+a, ic0+b] += K[(a+1)*os + fr] * K[(b+1)*os + fc] * S
//   degrid:  S = sum_a K[(a+1)*os + fr] sum_b K[(b+1)*os + fc] * G[band, ir0+a, ic0+b]
//
// over a, b = 0..W-1 (W odd, 3..31) and only the cells inside [0, npix)^2:
// windows that hang off the grid are cut, never wrapped. Rows are v, cols
// u: ir0 = round(v) - W/2, ic0 = round(u) - W/2. K is the oversampled 1D
// kernel table, os * (W + 2) values. Every integer (window starts, table
// fractions fr, fc, bands) is planned on the host in float64
// (ops/cuda_gridtab.TableGridPlan, from pp_tile_plan): the kernels never
// round. T, the accumulator type, is float or double.
//
// Replaces the two Pallas TPU kernels of africanus_tpu/ops/pallas_grid.py:
//   grid_tiles_table_pallas / _grid_kernel_table (per-sample where-chain
//     placement of the table taps into padded tiles) plus the
//     non-wrapping fold of assemble_tiles (wrap=False); and
//   degrid_tiles_table_pallas / _degrid_kernel_table (the gather mirror)
//     plus extract_tiles and the host-planned gather-sum onto samples.
//
// What bounds them on an H100: bytes. At the facet cell of chip_smoke.py
// (800,000 samples, W = 7, 2 bands of 2048^2 complex64) the map moves
// ~90 MB (20 B of geometry and 8 B of value per sample, the 67 MB grid):
// 0.027 ms at 3.35 TB/s, against ~0.12 G FP32 instructions (49 taps x 3):
// 0.0035 ms. What the design does about it, and what it leaves for later:
//  - grid: the host sorts the kept samples stably by (uv tile, band) of
//    their window start on the grid shifted by W - 1 (so that a window
//    starting up to W - 1 cells before the grid still starts in a tile).
//    One block per (tile, band), one warp: the padded tile (32 + W - 1
//    cells square, 11.5 KB at W = 7 in complex64) and the kernel table sit
//    in shared memory; the block stages CHUNK samples at a time (the W row
//    and W column taps read from the table once per sample, the value, the
//    window offset), then the lanes split each sample's W^2 taps (distinct
//    cells) in plan order, a __syncwarp between samples. One writer per
//    cell, a fixed order: no atomics, bitwise-equal launches. wgrid.cu's
//    fold kernel (bands as planes) then sums each grid cell's covering
//    tile cells from host tables that drop every cell off the grid. One
//    warp per block, idle lanes at W^2 = 49 on 64 lane slots, and the
//    tiles' round trip through device memory are this design's cost.
//  - degrid: one thread per kept sample in tile order, the table in
//    shared memory, the in-grid taps summed in a fixed order, written to
//    the sample's own index (the wrapper zeroes the dropped samples).
//  - A table too large for shared memory beside the kernel's other
//    buffers (complex128 at W = 15, oversampling 1023: 139 KB) is read
//    from device memory through the read-only path instead of staged
//    (tab_smem = 0, the host's choice): a table read is 2W per sample
//    against W^2 taps, so it costs little either way.
//
// No --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int BUDGET = 96 * 1024;  // both kernels: shared memory per block, at most
constexpr int CHUNK = 64;          // grid kernel: samples staged per pass
constexpr int DEGRID_THREADS = 128;

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

__device__ __forceinline__ float2 vec2(float x, float y) { return make_float2(x, y); }
__device__ __forceinline__ double2 vec2(double x, double y) { return make_double2(x, y); }

template <typename T, int W>
constexpr size_t spread_smem(size_t ru, size_t rv, size_t ntab) {
    using V2 = typename Vec2<T>::type;
    return ru * rv * sizeof(V2) + CHUNK * sizeof(V2)
           + (ntab + 2 * CHUNK * W) * sizeof(T) + CHUNK * sizeof(int);
}

// Table value i: from the staged copy in shared memory, or (a table too
// large to stage) from device memory through the read-only path.
template <typename T>
__device__ __forceinline__ T tab_at(const T* s_tab, const T* __restrict__ table,
                                    bool staged, int i) {
    return staged ? s_tab[i] : __ldg(table + i);
}

// One block (one warp) per (uv tile, band): tiles (ntiles * nband, ru, rv)
// with ru = tile_r + W - 1, rv = tile_c + W - 1, tile index (tr * ntc +
// tc) * nband + band, every cell written. Samples are placed on the grid
// shifted by W - 1.
template <typename T, int W>
__global__ void __launch_bounds__(32)
gridtab_spread_kernel(const int* __restrict__ order, const int* __restrict__ tile_start,
                      const int* __restrict__ ir0, const int* __restrict__ ic0,
                      const int* __restrict__ fr, const int* __restrict__ fc,
                      const T* __restrict__ table, int ntab, int os, int tab_smem,
                      const typename Vec2<T>::type* __restrict__ vals,
                      typename Vec2<T>::type* __restrict__ tiles, int tile_r,
                      int tile_c, int ntc, int nband) {
    using V2 = typename Vec2<T>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    const int ru = tile_r + W - 1, rv = tile_c + W - 1;
    const int cells = ru * rv;

    V2* acc = reinterpret_cast<V2*>(smem);                   // (ru, rv)
    V2* s_val = acc + (size_t)cells;                         // (CHUNK,)
    T* s_tab = reinterpret_cast<T*>(s_val + CHUNK);         // (ntab,) if staged
    T* s_kr = s_tab + (tab_smem ? ntab : 0);                 // (CHUNK, W) each
    T* s_kc = s_kr + CHUNK * W;
    int* s_off = reinterpret_cast<int*>(s_kc + CHUNK * W);  // local row * rv + col

    if (tab_smem)
        for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = table[i];
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = vec2(T(0), T(0));

    const int uv = blockIdx.x / nband;
    const int tr = uv / ntc, tc = uv - tr * ntc;
    const int lo = tile_start[blockIdx.x], hi = tile_start[blockIdx.x + 1];
    const int lane = threadIdx.x;
    __syncthreads();  // the table is in
    for (int c0 = lo; c0 < hi; c0 += CHUNK) {
        const int cn = min(CHUNK, hi - c0);
        for (int q = lane; q < cn; q += blockDim.x) {  // stage sample c0 + q
            const int s = order[c0 + q];
            s_off[q] = (ir0[s] + W - 1 - tr * tile_r) * rv + ic0[s] + W - 1 - tc * tile_c;
            const int f_r = fr[s], f_c = fc[s];
#pragma unroll
            for (int a = 0; a < W; ++a) {
                s_kr[q * W + a] = tab_at(s_tab, table, tab_smem, (a + 1) * os + f_r);
                s_kc[q * W + a] = tab_at(s_tab, table, tab_smem, (a + 1) * os + f_c);
            }
            s_val[q] = vals[s];
        }
        __syncthreads();  // staged, and (first pass) the tile zeroed
        for (int j = 0; j < cn; ++j) {
            const V2 x = s_val[j];
            const T* kr = s_kr + j * W;
            const T* kc = s_kc + j * W;
            V2* win = acc + s_off[j];
            for (int k = lane; k < W * W; k += 32) {
                const int a = k / W, b = k - a * W;
                const T tap = kr[a] * kc[b];
                V2& cell = win[a * rv + b];
                cell.x += tap * x.x;
                cell.y += tap * x.y;
            }
            __syncwarp();  // sample j lands before sample j + 1 reads
        }
        __syncthreads();  // done with the staged chunk
    }
    V2* dst = tiles + (size_t)blockIdx.x * cells;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = acc[i];
}

// One thread per kept sample, in the plan's tile order; grid (nband, npix,
// npix); out[s] written for the kept samples only.
template <typename T, int W>
__global__ void __launch_bounds__(DEGRID_THREADS)
gridtab_degrid_kernel(const int* __restrict__ order, const int* __restrict__ ir0,
                      const int* __restrict__ ic0, const int* __restrict__ fr,
                      const int* __restrict__ fc, const int* __restrict__ band,
                      const T* __restrict__ table, int ntab, int os, int tab_smem,
                      const typename Vec2<T>::type* __restrict__ grid,
                      typename Vec2<T>::type* __restrict__ out, int nkeep, int npix) {
    using V2 = typename Vec2<T>::type;
    extern __shared__ __align__(16) unsigned char smem[];
    T* s_tab = reinterpret_cast<T*>(smem);
    if (tab_smem) {
        for (int i = threadIdx.x; i < ntab; i += blockDim.x) s_tab[i] = table[i];
        __syncthreads();
    }
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nkeep) return;
    const int s = order[i];
    const int r0 = ir0[s], q0 = ic0[s], f_r = fr[s], f_c = fc[s];
    const V2* g = grid + (size_t)band[s] * npix * npix;
    T kc[W];
    int col[W];
#pragma unroll
    for (int b = 0; b < W; ++b) {
        const int c = q0 + b;
        const bool in = c >= 0 && c < npix;
        kc[b] = in ? tab_at(s_tab, table, tab_smem, (b + 1) * os + f_c) : T(0);
        col[b] = in ? c : 0;
    }
    T ar = T(0), ai = T(0);
#pragma unroll
    for (int a = 0; a < W; ++a) {
        const int r = r0 + a;
        if (r < 0 || r >= npix) continue;
        const V2* row = g + (size_t)r * npix;
        T br = T(0), bi = T(0);
#pragma unroll
        for (int b = 0; b < W; ++b) {
            const V2 x = row[col[b]];
            br += kc[b] * x.x;
            bi += kc[b] * x.y;
        }
        const T kr = tab_at(s_tab, table, tab_smem, (a + 1) * os + f_r);
        ar += kr * br;
        ai += kr * bi;
    }
    out[s] = vec2(ar, ai);
}

template <typename T, int W>
int spread(const int* order, const int* tile_start, const int* ir0, const int* ic0,
           const int* fr, const int* fc, const void* table, int ntab, int os,
           int tab_smem, const void* vals, void* tiles, int tile_r, int tile_c,
           int ntiles, int ntc, int nband, cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const size_t smem = spread_smem<T, W>(tile_r + W - 1, tile_c + W - 1,
                                          tab_smem ? ntab : 0);
    if (smem > (size_t)BUDGET || ntab < os * (W + 2)) return (int)cudaErrorInvalidValue;
    gridtab_spread_kernel<T, W><<<ntiles * nband, 32, smem, stream>>>(
        order, tile_start, ir0, ic0, fr, fc, static_cast<const T*>(table), ntab, os,
        tab_smem, static_cast<const V2*>(vals), static_cast<V2*>(tiles), tile_r,
        tile_c, ntc, nband);
    return (int)cudaGetLastError();
}

template <typename T, int W>
int degrid(const int* order, const int* ir0, const int* ic0, const int* fr,
           const int* fc, const int* band, const void* table, int ntab, int os,
           int tab_smem, const void* grid, void* out, int nkeep, int npix,
           cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const size_t smem = tab_smem ? ntab * sizeof(T) : 0;
    if (smem > (size_t)BUDGET || ntab < os * (W + 2)) return (int)cudaErrorInvalidValue;
    const int blocks = (nkeep + DEGRID_THREADS - 1) / DEGRID_THREADS;
    gridtab_degrid_kernel<T, W><<<blocks, DEGRID_THREADS, smem, stream>>>(
        order, ir0, ic0, fr, fc, band, static_cast<const T*>(table), ntab, os,
        tab_smem, static_cast<const V2*>(grid), static_cast<V2*>(out), nkeep, npix);
    return (int)cudaGetLastError();
}

template <typename T, int W>
int allow_budget() {
    int err = (int)cudaFuncSetAttribute(gridtab_spread_kernel<T, W>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        BUDGET);
    return err ? err : (int)cudaFuncSetAttribute(
        gridtab_degrid_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BUDGET);
}

template <typename T>
int allow_budget_all() {
    int err = allow_budget<T, 3>();
    err = err ? err : allow_budget<T, 5>();
    err = err ? err : allow_budget<T, 7>();
    err = err ? err : allow_budget<T, 9>();
    err = err ? err : allow_budget<T, 11>();
    err = err ? err : allow_budget<T, 13>();
    err = err ? err : allow_budget<T, 15>();
    err = err ? err : allow_budget<T, 17>();
    err = err ? err : allow_budget<T, 19>();
    err = err ? err : allow_budget<T, 21>();
    err = err ? err : allow_budget<T, 23>();
    err = err ? err : allow_budget<T, 25>();
    err = err ? err : allow_budget<T, 27>();
    err = err ? err : allow_budget<T, 29>();
    return err ? err : allow_budget<T, 31>();
}

}  // namespace

// Lets every kernel instance take BUDGET bytes of dynamic shared memory on
// the current device (above the default 48 KB). Called once per device
// before the first launch, outside any CUDA-graph capture.
extern "C" int gridtab_init() {
    const int err = allow_budget_all<float>();
    return err ? err : allow_budget_all<double>();
}

#define GRIDTAB_SUPPORTS(CALL, T)      \
    switch (support) {                 \
        case 3: return CALL(T, 3);     \
        case 5: return CALL(T, 5);     \
        case 7: return CALL(T, 7);     \
        case 9: return CALL(T, 9);     \
        case 11: return CALL(T, 11);   \
        case 13: return CALL(T, 13);   \
        case 15: return CALL(T, 15);   \
        case 17: return CALL(T, 17);   \
        case 19: return CALL(T, 19);   \
        case 21: return CALL(T, 21);   \
        case 23: return CALL(T, 23);   \
        case 25: return CALL(T, 25);   \
        case 27: return CALL(T, 27);   \
        case 29: return CALL(T, 29);   \
        case 31: return CALL(T, 31);   \
        default: return (int)cudaErrorInvalidValue; \
    }

// order: (nkeep,) int32 kept samples sorted stably by block (uv tile,
// band); tile_start: (ntiles * nband + 1,) int32 offsets into it. ir0, ic0,
// fr, fc: (n,) int32 window starts (rows v, cols u) and table fractions;
// table: (ntab,) T, ntab >= os * (W + 2), staged in shared memory when
// tab_smem, else read from device memory; vals: (n,) complex T. tiles:
// (ntiles * nband, tile_r + W - 1, tile_c + W - 1) complex T, every cell
// written; fold them with wgrid_fold_launch (nplanes = nband) and the
// plan's clipping tables. Refused (invalid value) if a block would take
// more than BUDGET bytes. T is double when is_double, else float. Returns
// cudaGetLastError() after the launch.
extern "C" int gridtab_spread_launch(const int* order, const int* tile_start,
                                     const int* ir0, const int* ic0, const int* fr,
                                     const int* fc, const void* table, const void* vals,
                                     void* tiles, int support, int ntab, int os,
                                     int tab_smem, int tile_r, int tile_c, int ntiles,
                                     int ntc, int nband, int is_double, void* stream) {
    if (ntiles <= 0 || nband <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) spread<T, W>(order, tile_start, ir0, ic0, fr, fc, table, ntab, os, \
                                tab_smem, vals, tiles, tile_r, tile_c, ntiles, ntc,  \
                                nband, st)
    if (is_double) { GRIDTAB_SUPPORTS(CALL, double) }
    GRIDTAB_SUPPORTS(CALL, float)
#undef CALL
}

// order (nkeep,), ir0, ic0, fr, fc, band (n,) and table as for the spread;
// grid: (nband, npix, npix) complex T; out: (n,) complex T, written at the
// kept samples only.
extern "C" int gridtab_degrid_launch(const int* order, const int* ir0, const int* ic0,
                                     const int* fr, const int* fc, const int* band,
                                     const void* table, const void* grid, void* out,
                                     int support, int ntab, int os, int tab_smem,
                                     int nkeep, int npix, int is_double, void* stream) {
    if (nkeep <= 0) return (int)cudaSuccess;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) degrid<T, W>(order, ir0, ic0, fr, fc, band, table, ntab, os,        \
                                tab_smem, grid, out, nkeep, npix, st)
    if (is_double) { GRIDTAB_SUPPORTS(CALL, double) }
    GRIDTAB_SUPPORTS(CALL, float)
#undef CALL
}
