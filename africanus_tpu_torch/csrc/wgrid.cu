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
//  - degrid: gridding.cuh's tile gather, its w-stack form (stack_gather_kernel;
//    the header has the design). One block per uv tile that has samples
//    and block of planes stages the tile, its W - 1 halo and the block's
//    planes in shared memory (cp.async, the wrap resolved once per cell);
//    four lanes take a sample (sixteen at W = 10), form its 2W ES taps and
//    wsup w-taps once, and take the W * wsup window rows (w-tap t, row a),
//    a lane a row of W cells times the column taps it holds in registers;
//    a sample's rows of a step lie in different bank pairs (an odd row
//    pitch and a plane stride = W * pitch mod 16). The two partial sums
//    are reduced over the lanes in a fixed order (bitwise-equal launches)
//    and written to the sample's own index: no permutation, no scatter.
//    The host (ops/cuda_wgrid.WGridPlan) stages every plane in one block
//    where they fit its gather budget, else blocks of planes that overlap
//    by wsup - 1, each sample in the block that holds its whole w-window
//    (a separate gather order; the spread's plan order is untouched), and
//    lists the blocks by rows of tiles, the heaviest rows first.
//
// No --use_fast_math: expf/exp and sqrtf/sqrt are the accurate library
// versions, and the strict |z| < 1 cutoff is decided on the same
// (u - a) / (W/2) as the plain versions.

#include "gridding.cuh"

// Lets every spread and gather instance take SPREAD_BUDGET bytes of dynamic
// shared memory on the current device (above the default 48 KB). Called
// once per device before the first launch, outside any CUDA-graph capture.
extern "C" int wgrid_init() {
    int err = allow_es_spread_budget_all<float>();
    err = err ? err : allow_es_spread_budget_all<double>();
    err = err ? err : allow_stack_gather_budget<float, 4>();
    err = err ? err : allow_stack_gather_budget<float, 6>();
    err = err ? err : allow_stack_gather_budget<float, 8>();
    err = err ? err : allow_stack_gather_budget<float, 10>();
    err = err ? err : allow_stack_gather_budget<double, 4>();
    err = err ? err : allow_stack_gather_budget<double, 6>();
    err = err ? err : allow_stack_gather_budget<double, 8>();
    return err ? err : allow_stack_gather_budget<double, 10>();
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

// blocks: (nblocks, 4) int32 the gather's blocks: a uv tile (index tu *
// ntv + tv), the first of its plane_block staged planes, and its run lo ..
// hi - 1 of gather positions (in any order of blocks: the host lists the
// heaviest first); gpos: (n,) int32 the plan position of each gather position,
// or null where the gather order is the plan order (one block of planes a
// tile). order, and iu0, iv0, p0, uf, vf, wsc in plan order as for the
// spread; grid: (nplanes, nu, nv) complex T; out: (n,) complex T by
// sample, every sample written. Refused (invalid value) where a block's
// planes pass SPREAD_BUDGET bytes of shared memory or hold fewer than wsup
// planes. T is double when is_double, else float. Returns
// cudaGetLastError() after the launch.
extern "C" int wgrid_degrid_launch(const int* blocks, const int* gpos,
                                   const int* order, const int* iu0, const int* iv0,
                                   const int* p0, const void* uf, const void* vf,
                                   const void* wsc, const void* grid, void* out,
                                   int nblocks, int n, int nu, int nv, int nplanes,
                                   int tile_u, int tile_v, int ntv, int plane_block,
                                   int support, int wsup, double beta, int is_double,
                                   void* stream) {
    if (wsup != 1 && wsup != support) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GATHER(T, W, WS)                                                                 \
    stack_gather<T, W, WS>(blocks, gpos, order, iu0, iv0, p0, uf,                         \
                           vf, wsc, grid, out, nblocks, n, nu, nv, nplanes, tile_u,      \
                           tile_v, ntv, plane_block, beta, st)
#define CALL(T, W) (wsup == 1 ? GATHER(T, W, 1) : GATHER(T, W, W))
    if (is_double) { GRIDDING_SUPPORTS(CALL, double) }
    GRIDDING_SUPPORTS(CALL, float)
#undef CALL
#undef GATHER
}
