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
// at 3.35 TB/s) against ~1e9 flops (~15 us at 67 TFLOP/s). Above that,
// what costs is the deposit itself: 216 shared-memory read-modify-writes
// per sample if every tap went to memory.
//  - grid: gridding.cuh's tile spread kernel (its header has the design).
//    One block owns a uv tile of a block of planes outright and writes each
//    grid cell once: no halo, no padded tiles in device memory, no fold
//    kernel. Consumer thread (g, ra, rb) owns one cell of every window (the
//    one = (ra, rb) mod W in tile coordinates) in its group's consecutive
//    planes, so all W^2 threads of a group work on every sample whose
//    w-window meets their planes, with no barrier or __syncwarp between
//    samples, and keep their sums in registers until their cell moves. Two
//    producer warps stage the next chunk (geometry read in plan order, the
//    visibilities gathered, per consumer residue the cell offset and ES
//    tap, per plane the w-tap times V) while the consumers spread the
//    current one. The host (ops/cuda_wgrid.py) decides the tile edge, the
//    planes per block and the consumer groups, and lists per tile, in a
//    fixed order, the samples whose windows meet it (its own and the
//    spill-ins from its neighbours); every cell is summed by one thread in
//    a fixed order, so two launches give bitwise-equal grids. What bounds
//    it now (chip probes, PERF.md §6): the consumers' dependent chain per
//    sample (two shared loads, the cell compare, a flush of the running
//    sums to shared memory on ~25% of the samples, which the warp pays
//    whenever any lane flushes), not bytes.
//  - degrid: one thread per sample in plan order (samples sorted by tile
//    and window start, so a warp's windows overlap in L1/L2), reading its
//    geometry contiguously in that order; it sums its W^2*wsup wrapped
//    cells in a fixed order and writes the value to the sample's own
//    index, so there is no permutation and no scatter.
//
// No --use_fast_math: expf/exp and sqrtf/sqrt are the accurate library
// versions, and the strict |z| < 1 cutoff is decided on the same
// (u - a) / (W/2) as the plain versions.

#include "gridding.cuh"

namespace {

constexpr int DEGRID_THREADS = 128;

// One thread per sample, in plan order: geometry at plan position i,
// the value to sample order[i].
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
    const T u = uf[i], v = vf[i];
    const int u0 = pmod(iu0[i], nu), v0 = pmod(iv0[i], nv);
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
    const int pbase = p0[i];
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
        const T w = wsc[(size_t)t * n + i];
        sr += w * ar;
        si += w * ai;
    }
    out[s] = vec2(sr, si);
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

}  // namespace

// Lets every grid kernel instance take SPREAD_BUDGET bytes of dynamic
// shared memory on the current device (above the default 48 KB). Called
// once per device before the first launch, outside any CUDA-graph capture.
extern "C" int wgrid_init() {
    const int err = allow_es_spread_budget_all<float>();
    return err ? err : allow_es_spread_budget_all<double>();
}

// ent_pos, ent_off: (nent,) int32 entries, tile by tile (ent_start:
// (ntiles + 1,) int32 offsets), as gridding.cuh's tile_spread_kernel reads
// them; order: (n,) int32 sample of each plan position. p0: (n,) int32
// first w-plane, uf, vf: (n,) T offsets, wsc: (wsup, n) T w-taps, all in
// plan order; vis: (n,) complex T by sample. grid: (nplanes, nu, nv)
// complex T, every cell written. plane_block planes per block, groups
// consumer groups, chunk entries staged per pass: the host's layout,
// refused (invalid value) where it breaks a limit of tile_spread. T is
// double when is_double, else float. Returns cudaGetLastError() after the
// launch.
extern "C" int wgrid_spread_launch(const int* ent_pos, const int* ent_off,
                                   const int* ent_start, const int* order,
                                   const int* p0, const void* uf, const void* vf,
                                   const void* wsc, const void* vis, void* grid,
                                   int n, int nu, int nv, int nplanes, int support,
                                   int wsup, int tile_u, int tile_v, int ntiles,
                                   int ntv, int plane_block, int groups, int chunk,
                                   double beta, int is_double, void* stream) {
    if (wsup != 1 && wsup != support) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) tile_spread<T, W>(ent_pos, ent_off, ent_start, order, p0, uf, vf, wsc, \
                                     vis, 0, 1, grid, n, nu, nv, nplanes, wsup, tile_u,  \
                                     tile_v, ntiles, ntv, plane_block, groups, chunk,    \
                                     beta, st)
    if (is_double) { GRIDDING_SUPPORTS(CALL, double) }
    GRIDDING_SUPPORTS(CALL, float)
#undef CALL
}

// order, and iu0, iv0, p0, uf, vf, wsc in plan order as for the spread;
// grid: (nplanes, nu, nv) complex T; out: (n,) complex T by sample, every
// sample written.
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
    if (is_double) { GRIDDING_SUPPORTS(CALL, double) }
    GRIDDING_SUPPORTS(CALL, float)
#undef CALL
}
