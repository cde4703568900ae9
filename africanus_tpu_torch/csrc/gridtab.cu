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
//  - grid: gridding.cuh's tile spread kernel (its header has the design),
//    with the table's taps (TableTaps) and one block per (uv tile, band):
//    the host (ops/cuda_gridtab.TableGridPlan) lists per (tile, band) the
//    kept samples whose clipped window meets the tile, sorted by window
//    start, and the block owns its tile of the grid itself, writing each
//    cell once; windows never wrap, so cells off the grid have no owner and
//    are dropped. Every W^2 taps of an entry go to W^2 consumer residues
//    (2 or 3 residues a consumer above W = 21), which keep their sums in
//    registers while their cell stays put and flush without a branch (a
//    facet's blocks are sparse: nearly every entry moves every residue's
//    cell). No padded tiles, no fold, no atomics: bitwise-equal launches.
//    One band per block because every sample has one band: a block of two
//    bands' planes would spread every entry twice, once into a plane it
//    misses. What bounds it: the consumers' chain per entry (its loads,
//    the compare and the flush), a few block-entries at a time per SM.
//  - degrid: gridding.cuh's tile gather, its table form
//    (table_gather_kernel; the header has the design). One block per (uv
//    tile, band) that has kept samples stages the tile and its halo cut to
//    the grid (zeros off it, W - 1 lead rows and columns on the first tile
//    row and column, where windows start before the grid), and the table
//    where it fits; its samples are one run of plan positions, their
//    window starts and fractions read in plan order; the host lists the
//    blocks by rows of tiles, the heaviest rows first. Four lanes take a
//    sample (sixteen above W = 8), a lane a window row: the row's W cells
//    times the column taps, held in registers, times the row tap; the
//    partial sums are reduced over the lanes in a fixed order and written
//    to the sample's own index (the wrapper zeroes the dropped samples).
//  - A table too large for shared memory beside the kernel's other
//    buffers (complex128 at W = 15, oversampling 1023: 139 KB) is read
//    from device memory through the read-only path instead of staged
//    (tab_smem = 0, the host's choice, for each kernel): a table read is 2W
//    per entry or sample against W^2 taps, so it costs little either way.
//
// No --use_fast_math.

#include "gridding.cuh"

namespace {

// The table map's tile spread: one block per (tile, band), the entries
// listed per block, the table staged (tab_smem) or read from device memory.
template <typename T, int W>
int spread(const int* ent_pos, const int* ent_off, const int* ent_start,
           const int* order, const int* fr, const int* fc, const void* table, int ntab,
           int os, int tab_smem, const void* vals, void* grid, int npix, int nband,
           int tile, int ntiles, int ntc, int chunk, cudaStream_t stream) {
    if (ntab < os * (W + 2) || nband <= 0) return (int)cudaErrorInvalidValue;
    const TableTaps<T, W> taps{static_cast<const T*>(table), fr, fc, os, ntab, tab_smem,
                               nullptr};
    return spread_launch<T, W, 1, TableTaps<T, W>>(
        ent_pos, ent_off, ent_start, order, nullptr, taps, nullptr, vals, 0, 1, grid, 0,
        npix, npix, nband, 1, tile, tile, ntiles, ntc, 1, 1, 1, chunk,
        tab_smem ? ntab : 0, stream);
}

template <typename T, int W>
int allow_budget() {
    const int err = allow_spread_budget<T, W, 1, TableTaps<T, W>>();
    return err ? err : allow_table_gather_budget<T, W>();
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

// Lets every spread and gather instance take SPREAD_BUDGET bytes of
// dynamic shared memory on the current device (above the default 48 KB).
// Called once per device before the first launch, outside any CUDA-graph
// capture.
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

// ent_pos, ent_off: (nent,) int32 entries, block by block (ent_start:
// (ntiles * nband + 1,) int32 offsets; block (tile, band) = tile * nband +
// band), as gridding.cuh's tile_spread_kernel reads them; ent_pos indexes
// order, the kept samples in plan order. fr, fc: (n,) int32 table
// fractions by sample; table: (ntab,) T, ntab >= os * (W + 2), staged in
// shared memory when tab_smem, else read from device memory; vals: (n,)
// complex T by sample. grid: (nband, npix, npix) complex T, every cell
// written; tile x tile uv tiles, ntiles of them, ntc a row. chunk entries
// staged per pass: refused (invalid value) where the layout breaks a limit
// of the tile spread. T is double when is_double, else float. Returns
// cudaGetLastError() after the launch.
extern "C" int gridtab_spread_launch(const int* ent_pos, const int* ent_off,
                                     const int* ent_start, const int* order,
                                     const int* fr, const int* fc, const void* table,
                                     const void* vals, void* grid, int support, int ntab,
                                     int os, int tab_smem, int npix, int nband, int tile,
                                     int ntiles, int ntc, int chunk, int is_double,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) spread<T, W>(ent_pos, ent_off, ent_start, order, fr, fc, table, ntab, \
                                os, tab_smem, vals, grid, npix, nband, tile, ntiles,  \
                                ntc, chunk, st)
    if (is_double) { GRIDTAB_SUPPORTS(CALL, double) }
    GRIDTAB_SUPPORTS(CALL, float)
#undef CALL
}

// blocks: (nblocks,) int32 the (tile, band) lists that have kept samples
// (list tile * nband + band); home_start: (ntiles * nband + 1,) int32
// offsets of each list's run of plan positions; order: (nkeep,) int32 the
// kept samples in plan order; ir0, ic0, fr, fc: (nkeep,) int32 window
// starts and table fractions in plan order; table as for the spread;
// grid: (nband, npix, npix) complex T; out: (n,) complex T, written at the
// kept samples only. Refused (invalid value) where the staged tile passes
// SPREAD_BUDGET bytes of shared memory.
extern "C" int gridtab_degrid_launch(const int* blocks, const int* home_start,
                                     const int* order, const int* ir0, const int* ic0,
                                     const int* fr, const int* fc, const void* table,
                                     const void* grid, void* out, int support, int ntab,
                                     int os, int tab_smem, int nblocks, int npix,
                                     int nband, int tile, int ntc, int is_double,
                                     void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CALL(T, W) table_gather<T, W>(blocks, home_start, order, ir0, ic0, fr, fc, table,  \
                                      ntab, os, tab_smem, grid, out, nblocks, npix, nband, \
                                      tile, ntc, st)
    if (is_double) { GRIDTAB_SUPPORTS(CALL, double) }
    GRIDTAB_SUPPORTS(CALL, float)
#undef CALL
}
