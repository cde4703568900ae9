// Multi-correlation 2D convolutional gridding and degridding (no w-stack),
// for Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   grid:    G[c, iu0+a, iv0+b] += es((uf-a)/(W/2)) * es((vf-b)/(W/2)) * V[c]
//   degrid:  V[c] = sum_a es((uf-a)/(W/2)) sum_b es((vf-b)/(W/2)) * G[c, iu0+a, iv0+b]
//
// over a, b = 0..W-1 and the correlations c < NC, with the uv
// indices wrapping mod (nu, nv). es is the exponential of semicircle, zero
// outside |z| < 1, as in africanus_tpu_torch/ops/es.py and wgrid.cu. The ES
// window of a sample is computed once and applied to every correlation.
// The per-sample geometry (window starts iu0, iv0, offsets uf, vf, and the
// samples' plan order, sorted by uv tile and window start, and the grid
// kernel's per-tile entries) is the one-plane ops/cuda_wgrid.WGridPlan,
// planned in float64 on the host; T, the
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
// 3.35e13/s. Above that, what costs is the deposit: 256 shared-memory
// read-modify-writes per sample if every tap went to memory.
//  - grid: gridding.cuh's tile spread kernel, the correlations as planes
//    and one "tap" per correlation (its header has the design). One block
//    owns a uv tile of every correlation outright and writes each grid cell
//    once: no padded tiles, no fold. Consumer thread (ra, rb) owns one cell
//    of every window (= (ra, rb) mod W in tile coordinates) for all NC
//    correlations at once, so the tap's position and ES product are formed
//    once for NC deposits, and all W^2 threads work on every sample with no
//    barrier between samples; it keeps NC sums in registers until its cell
//    moves. Two producer warps stage the next chunk (geometry in plan
//    order, the NC values gathered by stride, per consumer residue the cell
//    offset and ES tap). The host (ops/cuda_wgrid.py, ops/cuda_grid2d.py)
//    decides the tile edge and lists each tile's entries in a fixed order:
//    one thread sums each cell in a fixed order, two launches give
//    bitwise-equal grids. Up to 4 correlations in one launch. What bounds it
//    now: the consumers' dependent chain per sample and the flushes of
//    their sums (PERF.md §6), not bytes.
//  - degrid: gridding.cuh's tile gather, the mirror of the spread. One block
//    per uv tile that has samples stages the tile and its W - 1 halo of the
//    launch's NC correlations into shared memory (cp.async, whole rows, the
//    wrap resolved once per cell), then gathers the tile's own samples
//    (the plan-order run whose window start lies in it) a half-warp each:
//    the 2W ES taps once, the W^2 taps 16 at a time with no bank conflict,
//    and the 2 NC partial sums reduced over the 16 lanes by shuffles in a
//    fixed pattern (bitwise-equal launches), written to the sample's own
//    row of the (n, NC) output: no permutation, no scatter. NC in {1, 2, 4}
//    (the wrapper splits others). A warp's shared loads read 16 consecutive
//    taps of each of two windows, where one thread a sample would make each
//    8-byte load of a warp touch 32 different windows.
//
// No --use_fast_math: expf/exp and sqrtf/sqrt are the accurate library
// versions, and the strict |z| < 1 cutoff is decided on the same
// (u - a) / (W/2) as the plain versions.

#include "gridding.cuh"

// Lets every spread and gather instance take SPREAD_BUDGET bytes of
// dynamic shared memory on the current device (above the default 48 KB).
// Called once per device before the first launch, outside any CUDA-graph
// capture.
extern "C" int grid2d_init() {
    int err = allow_es_spread_budget_all<float>();
    err = err ? err : allow_es_spread_budget_all<double>();
    err = err ? err : allow_gather_budget<float, 4>();
    err = err ? err : allow_gather_budget<float, 6>();
    err = err ? err : allow_gather_budget<float, 8>();
    err = err ? err : allow_gather_budget<float, 10>();
    err = err ? err : allow_gather_budget<double, 4>();
    err = err ? err : allow_gather_budget<double, 6>();
    err = err ? err : allow_gather_budget<double, 8>();
    return err ? err : allow_gather_budget<double, 10>();
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

// ent_pos, ent_off, ent_start, order: the plan's per-tile entries and
// sample order, as gridding.cuh's tile_spread_kernel reads them; uf, vf:
// (n,) T offsets in plan order; vis: complex T, element (c, s) at
// vis[c * cs + s * ss] (elements, not bytes), ncorr in 1..4. grid: (ncorr,
// nu, nv) complex T, every cell written. groups consumer groups (each
// thread then holds ncorr / groups correlations), chunk entries staged per
// pass: the host's layout, refused (invalid value) where it breaks a limit
// of tile_spread. T is double when is_double, else float. Returns
// cudaGetLastError() after the launch.
extern "C" int grid2d_spread_launch(const int* ent_pos, const int* ent_off,
                                    const int* ent_start, const int* order,
                                    const void* uf, const void* vf, const void* vis,
                                    long long cs, long long ss, void* grid, int n,
                                    int nu, int nv, int support, int ncorr,
                                    int tile_u, int tile_v, int ntiles, int ntv,
                                    int groups, int chunk, double beta, int is_double,
                                    void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) tile_spread<T, W>(ent_pos, ent_off, ent_start, order, nullptr, uf, vf, \
                                     nullptr, vis, cs, ss, grid, n, nu, nv, ncorr, ncorr,  \
                                     tile_u, tile_v, ntiles, ntv, ncorr, groups, chunk,    \
                                     beta, st)
    if (is_double) { GRIDDING_SUPPORTS(CALL, double) }
    GRIDDING_SUPPORTS(CALL, float)
#undef CALL
}

// tiles: (ntiles,) int32 the uv tiles that have samples (tile index tu *
// ntv + tv); home_start: (all tiles + 1,) int32 offsets into plan order of
// each tile's samples; order, and iu0, iv0, uf, vf in plan order; grid:
// (ncorr, nu, nv) complex T, ncorr in {1, 2, 4}; out: (n, ncorr) complex
// T by sample, every element written. tile_u x tile_v tiles: refused
// (invalid value) where the staged tile passes SPREAD_BUDGET bytes of
// shared memory. T is double when is_double, else float. Returns
// cudaGetLastError() after the launch.
extern "C" int grid2d_degrid_launch(const int* tiles, const int* home_start,
                                    const int* order, const int* iu0, const int* iv0,
                                    const void* uf, const void* vf, const void* grid,
                                    void* out, int ntiles, int nu, int nv, int tile_u,
                                    int tile_v, int ntv, int support, int ncorr,
                                    double beta, int is_double, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W, NC) tile_gather<T, W, NC>(tiles, home_start, order, iu0, iv0, uf, vf, \
                                             grid, out, ntiles, nu, nv, tile_u, tile_v, \
                                             ntv, beta, st)
    if (is_double) { GRID2D_SUPPORTS(CALL, double) }
    GRID2D_SUPPORTS(CALL, float)
#undef CALL
}
