// Shared by wgrid.cu, grid2d.cu and gridtab.cu: the ES kernel, the complex
// vector types, the tile spread kernel that grids all three maps, and the
// tile gather that degrids them (a kernel per map: their taps differ).
//
//   w-stack:  G[p0+t, iu0+a, iv0+b] += wsc[t] * es((uf-a)/(W/2)) * es((vf-b)/(W/2)) * V
//   2D:       G[c, iu0+a, iv0+b]    += es((uf-a)/(W/2)) * es((vf-b)/(W/2)) * V[c]
//   table:    G[band, ir0+a, ic0+b] += K[(a+1)*os + fr] * K[(b+1)*os + fc] * S
//
// The 2D map is the w-stack map with p0 = 0 and one "tap" per correlation,
// and the table map is the 2D map of one value with the table's taps in
// place of the ES kernel's (EsTaps, TableTaps: the producer's tap policy)
// and the band as the block's plane; so one kernel spreads all three.
// Everything per sample and per entry is planned on the host
// (ops/cuda_wgrid.WGridPlan, ops/cuda_gridtab.TableGridPlan); this file
// only checks a launch's layout against its limits.
//
// The spread (Romein, "An efficient work-distribution strategy for
// gridding radio-telescope data on GPUs", ICS 2012, made deterministic):
//  - One block owns one uv tile (tile_u x tile_v cells, no halo) of a
//    block of planes, in shared memory, and writes each of its grid cells
//    exactly once: no padded tiles go through device memory, and there is
//    no fold.
//  - The host lists, per tile (or per block: the table map's bands) and in
//    a fixed order, every entry: a sample whose window meets the tile (its
//    own samples and the neighbours' whose windows spill in), with the
//    window start relative to the tile, du, dv in (-W, tile). A window that
//    wraps mod nu, nv, or a grid narrower than W, gives one entry per
//    periodic copy that meets the tile; the table map's windows never wrap
//    (cells off the grid have no owner and are dropped). The block clips
//    every tap to its tile.
//  - Consumer thread (g, c) owns the residues r = c + k * C (k < R, r <
//    W^2, (ra, rb) = (r / W, r mod W)) and with each of them the cells
//    whose tile coordinates are = (ra, rb) mod W, in planes g * NP .. g * NP
//    + NP - 1 (NP at most SPREAD_MAXP, a template parameter; a group skips
//    the entries whose w-window misses its planes). R = 1 up to W = 21;
//    wider windows (the table map's W to 31) have more residues than a
//    block has consumers, and a consumer holds 2 or 3. Each entry's window
//    holds exactly one cell of each residue, a = (ra - du) mod W, so every
//    consumer works on every entry, without a barrier or a __syncwarp
//    between entries: program order alone orders a thread's deposits. It
//    keeps its sums in registers while a residue's cell stays the same over
//    consecutive entries (the host sorts a tile's entries by window start)
//    and adds them to shared memory when the cell changes (the table map,
//    whose blocks are sparse, without a branch). Each cell is summed by one
//    thread in a fixed order: no atomics, and two launches give
//    bitwise-equal grids.
//  - Two producer warps stage the next CHUNK entries, one a lane (their
//    plan-order positions read contiguously, a chunk ahead; the values
//    gathered; for every residue along each axis its cell's offset and tap,
//    and per plane the w-tap times V, computed once per entry) into the
//    second of two buffers while the consumers spread the current one: one
//    __syncthreads per chunk. A consumer's step is then a few shared loads,
//    the cell and plane-window compares and one FMA pair per plane, with
//    the next entry's loads issued before it; its flushes load first and
//    store after. The table map's kernel table is staged in shared memory
//    once per block where it fits the host's budget, else read through the
//    read-only path.
//
// The gather (the three degrids; the mirror of the spread):
//  - One block per uv tile that has samples (the host lists them; on a
//    w-stack whose planes do not fit, per tile and block of planes; on the
//    table map per tile and band). It stages the tile and its W - 1 halo,
//    from device memory into shared memory with cp.async, row by row
//    (coalesced), every plane of a cell from one index: the 2D map's NC
//    correlations, the w-stack's planes of the block, the table map's band.
//    The ES maps wrap mod nu, nv, resolved here once per staged cell, never
//    per tap, by subtraction (an integer division per cell made the staging
//    as costly in issued instructions as the gather itself). The table map
//    never wraps: cells off the grid are staged as zero, and on the first
//    tile row and column W - 1 lead rows and columns of them precede the
//    tile, since a window there may start before the grid.
//  - The block's samples are one run of positions: the plan-order run whose
//    window start (the table map: window's first grid cell) lies in the
//    tile; on a w-stack of several blocks of planes, a separate gather
//    order, each sample in the block that holds its whole w-window. The
//    host lists the w-stack's and the table map's blocks by rows of tiles,
//    the heaviest rows first (the longest blocks then do not start last),
//    and the 2D map's in tile order. A group of lanes takes one sample,
//    its geometry loaded a round ahead, and splits its window:
//      2D: a half-warp forms the 2W ES taps once into a slot of shared
//        memory, then takes tap k = 16 s + h at (k / W, k mod W), each lane
//        adding tap x cell for every correlation; the staged rows have a
//        pitch = W (mod 16) cells, so the 16 consecutive taps of a step
//        fall in 16 different bank pairs and one shared load reads them
//        without a bank conflict.
//      w-stack: L lanes (4 up to W = 8, else 16) form the 2W ES taps and
//        the wsup w-taps once, then take the W * wsup window rows q = t * W
//        + a (w-tap t, row a), row q = L s + h to lane h: W cells times the
//        column taps, which the lane holds in registers, then times the
//        row's w-tap x ES tap (a flat split of the W^2 wsup taps would look
//        up two taps per cell instead). The rows have an odd pitch and the
//        planes a stride = W * pitch (mod 16), so row q lies at pitch * q
//        (mod 16) and a step's L rows in L bank pairs. Fewer lanes a sample
//        share its overhead (geometry, taps, reduction) among more samples a
//        warp, at the cost of conflicts between the samples of a half-warp:
//        on the H100 four were faster than eight, and eight than sixteen,
//        at both config-4 cells (PERF.md §6).
//      table: 4 lanes a sample up to W = 8 (else 16) take the window rows,
//        a lane a row, with the column taps in registers, read from the
//        block's staged table (or device memory) with no slot: the
//        sample's overhead is shared by eight samples a warp.
//    The partial sums are then reduced over the group's lanes by shuffles
//    in a fixed pattern (halving the values held at each step), so two
//    launches give bitwise-equal values, written to the sample's own index.
//
// No --use_fast_math: expf/exp and sqrtf/sqrt are the accurate library
// versions, and the strict |z| < 1 cutoff is decided on the same
// (u - a) / (W/2) as the plain versions.

#pragma once

#include <cuda_runtime.h>

namespace {

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

constexpr int SPREAD_CHUNK = 64;             // entries staged per pass
constexpr int SPREAD_MAXP = 5;               // planes one consumer accumulates, at most
constexpr int SPREAD_PRODUCERS = 2;          // producer warps: one entry a lane per pass
constexpr int SPREAD_THREADS = 512;          // consumers (whole warps) + producers
constexpr int SPREAD_CONSUMERS = SPREAD_THREADS - 32 * SPREAD_PRODUCERS;
constexpr int SPREAD_BUDGET = 227 * 1024;    // dynamic shared memory per block
constexpr int SPREAD_OUT = -(1 << 28);       // a staged row or column off the tile
static_assert(SPREAD_CHUNK == 32 * SPREAD_PRODUCERS, "one staged entry a producer lane");

// Residues one consumer holds (R) and consumers of one group (C) at support W.
template <int W>
__host__ __device__ constexpr int spread_residues() {
    return (W * W + SPREAD_CONSUMERS - 1) / SPREAD_CONSUMERS;
}

template <int W>
__host__ __device__ constexpr int spread_group() {
    return (W * W + spread_residues<W>() - 1) / spread_residues<W>();
}

// The producer's taps of the w-stack and 2D maps: the ES kernel at the
// sample's offsets from its window start (uf, vf in plan order).
template <typename T, int W>
struct EsTaps {
    const T* __restrict__ uf;
    const T* __restrict__ vf;
    T beta;
    static constexpr bool has_table = false;
    static constexpr bool sparse = false;
    struct At { T u, v; };
    // through the read-only path, as the restrict-qualified kernel
    // arguments these pointers were
    __device__ __forceinline__ At at(int pos, int) const {
        return {__ldg(uf + pos), __ldg(vf + pos)};
    }
    __device__ __forceinline__ T u(const At& x, int a) const {
        return es_tap((x.u - T(a)) / (T(W) / T(2)), beta);
    }
    __device__ __forceinline__ T v(const At& x, int b) const {
        return es_tap((x.v - T(b)) / (T(W) / T(2)), beta);
    }
};

// The producer's taps of the table map: tap a of a sample with table
// fraction f is K[(a + 1) * os + f] (fr along the rows, fc along the
// columns, by sample index), read from the block's staged copy (s_tab)
// or, a table too large to stage, from device memory through the
// read-only path.
template <typename T, int W>
struct TableTaps {
    const T* __restrict__ table;
    const int* __restrict__ fr;
    const int* __restrict__ fc;
    int os, ntab, staged;
    const T* s_tab;
    static constexpr bool has_table = true;
    // the facet cell's blocks hold few entries for their tile's cells, so
    // that nearly every entry moves every residue's cell: a flush without a
    // branch costs less there (spread_consume)
    static constexpr bool sparse = true;
    struct At { int r, c; };
    __device__ __forceinline__ At at(int, int s) const { return {fr[s], fc[s]}; }
    __device__ __forceinline__ T k(int i) const { return staged ? s_tab[i] : __ldg(table + i); }
    __device__ __forceinline__ T u(const At& x, int a) const { return k((a + 1) * os + x.r); }
    __device__ __forceinline__ T v(const At& x, int b) const { return k((b + 1) * os + x.c); }
};

// One staged residue of an entry along one axis: the owned cell's row
// offset (lu * pitch) or column (lv), SPREAD_OUT where it is off the tile,
// and the tap of that cell.
template <typename T>
struct __align__(2 * sizeof(T)) SpreadTap {
    int cell;
    T k;
};

// Bytes of one staging buffer: per entry W row and W column taps (one per
// residue), one value per plane of the block (w-tap times V, zero off the
// entry's w-window; or the correlation's value) and the entry's first
// plane in the block; CHUNK + 1 entries, so that a consumer's load of the
// entry after the last is in bounds (its values are never used).
template <typename T, int W>
__host__ __device__ constexpr size_t spread_stage_bytes(int plane_block) {
    // rounded up to 16 bytes: the second buffer's taps stay aligned
    return ((size_t)(SPREAD_CHUNK + 1)
                * (2 * W * sizeof(SpreadTap<T>)
                   + plane_block * sizeof(typename Vec2<T>::type) + sizeof(int))
            + 15) / 16 * 16;
}

// Dynamic shared memory of a spread block: its planes of the tile (rows
// padded to an odd pitch), two staging buffers and ntab staged table
// values.
template <typename T, int W>
size_t spread_smem(int plane_block, int tile_u, int tile_v, int ntab) {
    return (size_t)plane_block * tile_u * (tile_v | 1) * sizeof(typename Vec2<T>::type)
           + 2 * spread_stage_bytes<T, W>(plane_block) + (size_t)ntab * sizeof(T);
}

// A producer lane stages entry q of a chunk into buf (CHUNK is the
// producers' lane count, so one entry a lane): for every residue r along
// each axis the owned cell's row (column) offset and tap, a = (r - du) mod
// W; and per plane of the block the value to deposit. pos and o are the
// entry's plan position and packed offsets ((du + W) << 5 | du mod W) |
// ((dv + W) << 5 | dv mod W) << 16, loaded a chunk ahead. wsc non-null: a w-stack (one value per sample,
// ntaps w-taps, planes pb0 .. pb0 + npb - 1); else the 2D or table map
// (npb correlations, vis element (c, s) at vis[c * cs + s * ss]).
template <typename T, int W, typename Taps>
__device__ __forceinline__ void spread_stage(
        unsigned char* buf, int q, int pos, int o, const Taps taps,
        const int* __restrict__ order, const int* __restrict__ p0,
        const T* __restrict__ wsc, const typename Vec2<T>::type* __restrict__ vis,
        long long cs, long long ss, int n, int ntaps, int pb0, int npb, int plane_block,
        int hu, int hv, int pitch) {
    using V2 = typename Vec2<T>::type;
    SpreadTap<T>* s_u = reinterpret_cast<SpreadTap<T>*>(buf);
    SpreadTap<T>* s_v = s_u + (SPREAD_CHUNK + 1) * W;
    V2* s_w0 = reinterpret_cast<V2*>(s_v + (SPREAD_CHUNK + 1) * W);
    int* s_p = reinterpret_cast<int*>(s_w0 + (SPREAD_CHUNK + 1) * plane_block);
    V2* s_w = s_w0 + q * plane_block;
    const int s = order[pos];
    const typename Taps::At x = taps.at(pos, s);
    const int du = ((o >> 5) & 0x7ff) - W, ru = o & 31;
    const int dv = ((o >> 21) & 0x7ff) - W, rv = (o >> 16) & 31;
#pragma unroll
    for (int r = 0; r < W; ++r) {
        const int a = r - ru + (r < ru ? W : 0);
        const int lu = du + a;
        s_u[q * W + r] = {(unsigned)lu < (unsigned)hu ? lu * pitch : SPREAD_OUT,
                          taps.u(x, a)};
        const int b = r - rv + (r < rv ? W : 0);
        const int lv = dv + b;
        s_v[q * W + r] = {(unsigned)lv < (unsigned)hv ? lv : SPREAD_OUT, taps.v(x, b)};
    }
    if (wsc != nullptr) {
        const V2 v = vis[(long long)s * ss];
        const int p = p0[pos] - pb0;
        s_p[q] = p;
        for (int pl = 0; pl < npb; ++pl) {
            const int t = pl - p;
            const T k = (unsigned)t < (unsigned)ntaps ? wsc[(size_t)t * n + pos] : T(0);
            s_w[pl] = vec2(k * v.x, k * v.y);
        }
    } else {
        s_p[q] = 0;
        for (int c = 0; c < npb; ++c) s_w[c] = vis[c * cs + (long long)s * ss];
    }
}

// Add a residue's running sums to its owned cell cur of each of its NP
// planes that it holds (acc + base[q]): the loads first, then the stores.
template <typename T, int NP>
__device__ __forceinline__ void spread_flush(typename Vec2<T>::type* acc,
                                             const int (&base)[NP], const bool (&held)[NP],
                                             int cur, typename Vec2<T>::type (&sum)[NP]) {
    using V2 = typename Vec2<T>::type;
    V2 old[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q)
        if (held[q]) old[q] = acc[base[q] + cur];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
        if (held[q]) acc[base[q] + cur] = vec2(old[q].x + sum[q].x, old[q].y + sum[q].y);
        sum[q] = vec2(T(0), T(0));
    }
}

// A consumer deposits the cn staged entries of buf, in order, into the
// owned cells of its R residues (ra[k], rb[k]; own[k]: the residue
// exists) in its NP planes pl0 .. pl0 + NP - 1 (pl[q], held[q]; acc +
// base[q]), skipping the entries whose planes pw .. pw + ntaps - 1 miss
// them. Entry j + 1's operands are loaded before entry j is deposited (and
// its cells flushed), so that their latency overlaps. SPARSE (the table
// map): every entry loads the owned cells' old values and stores the flush
// only where a cell moved, with no branch; else (the ES maps, one residue
// a consumer) the flush is a branch, taken on the entries that move the
// cell (a quarter or so of a dense block's).
template <typename T, int W, int NP, int R, bool SPARSE>
__device__ __forceinline__ void spread_consume(
        const unsigned char* buf, int cn, const int (&ra)[R], const int (&rb)[R],
        const bool (&own)[R], int plane_block, int ntaps, const int (&pl)[NP],
        const int (&base)[NP], const bool (&held)[NP], typename Vec2<T>::type* acc,
        typename Vec2<T>::type (&sum)[R][NP], int (&cur)[R]) {
    using V2 = typename Vec2<T>::type;
    const SpreadTap<T>* s_u = reinterpret_cast<const SpreadTap<T>*>(buf);
    const SpreadTap<T>* s_v = s_u + (SPREAD_CHUNK + 1) * W;
    const V2* s_w = reinterpret_cast<const V2*>(s_u + 2 * (SPREAD_CHUNK + 1) * W);
    const int* s_p = reinterpret_cast<const int*>(s_w + (SPREAD_CHUNK + 1) * plane_block);
    // the entry's first plane pw meets pl0 .. pl0 + NP - 1 iff
    // pl0 - ntaps < pw < pl0 + NP
    const int pw_lo = pl[0] - ntaps, pw_hi = pl[0] + NP;
    SpreadTap<T> nu[R], nv[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        nu[k] = s_u[ra[k]];
        nv[k] = s_v[rb[k]];
    }
    int np_ = s_p[0];
    V2 nw[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q)
        nw[q] = held[q] ? s_w[pl[q]] : vec2(T(0), T(0));
    for (int j = 0; j < cn; ++j) {
        SpreadTap<T> cu[R], cv[R];
#pragma unroll
        for (int k = 0; k < R; ++k) {
            cu[k] = nu[k];
            cv[k] = nv[k];
        }
        const int pw = np_;
        V2 cw[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) cw[q] = nw[q];
#pragma unroll
        for (int k = 0; k < R; ++k) {  // entry cn: in bounds, never used
            nu[k] = s_u[(j + 1) * W + ra[k]];
            nv[k] = s_v[(j + 1) * W + rb[k]];
        }
        np_ = s_p[j + 1];
        const V2* w = s_w + (j + 1) * plane_block;
#pragma unroll
        for (int q = 0; q < NP; ++q)
            if (held[q]) nw[q] = w[pl[q]];
        if constexpr (SPARSE) {
            if (pw <= pw_lo || pw >= pw_hi) continue;  // the entry misses the planes
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int cell = cu[k].cell + cv[k].cell;
                const bool dep = (R == 1 || own[k]) && cell >= 0;
                const bool moved = dep && cell != cur[k];
                const bool flush = moved && cur[k] >= 0;
                const int at = flush ? cur[k] : 0;
                V2 old[NP];
#pragma unroll
                for (int q = 0; q < NP; ++q) old[q] = acc[base[q] + at];
#pragma unroll
                for (int q = 0; q < NP; ++q) {
                    const V2 x = vec2(old[q].x + sum[k][q].x, old[q].y + sum[k][q].y);
                    if (flush && held[q]) acc[base[q] + at] = x;
                    sum[k][q] = moved ? vec2(T(0), T(0)) : sum[k][q];
                }
                cur[k] = moved ? cell : cur[k];
                const T tap = dep ? cu[k].k * cv[k].k : T(0);
#pragma unroll
                for (int q = 0; q < NP; ++q) {
                    if (held[q]) {
                        sum[k][q].x += tap * cw[q].x;
                        sum[k][q].y += tap * cw[q].y;
                    }
                }
            }
        } else {
            // the ES maps (W <= 10): one residue a consumer; this shape of
            // the checks is the one that compiles to the fastest loop
            static_assert(R == 1, "a dense map holds one residue a consumer");
            const int cell = cu[0].cell + cv[0].cell;
            // the owned cell is off the tile, or the entry misses the planes
            if (cell < 0 || pw <= pw_lo || pw >= pw_hi) continue;
            if (cell != cur[0]) {  // the owned cell moved: add the sums, start anew
                if (cur[0] >= 0) spread_flush<T, NP>(acc, base, held, cur[0], sum[0]);
                cur[0] = cell;
            }
            const T tap = cu[0].k * cv[0].k;
#pragma unroll
            for (int q = 0; q < NP; ++q) {
                if (held[q]) {
                    sum[0][q].x += tap * cw[q].x;
                    sum[0][q].y += tap * cw[q].y;
                }
            }
        }
    }
}

// One block per (tile, block of planes): grid (nplanes, nu, nv), every
// cell of the block's tile and planes written. Block b is tile b / nblk,
// planes (b mod nblk) * plane_block ...; its entries are ent_start[l] ..
// ent_start[l + 1] - 1 with l = b if block_lists (the table map: a list
// per tile and band), else l = its tile (every block of planes of a tile
// reads the tile's list). ent_pos is the sample's position in plan order
// (the index of its geometry), order[pos] its sample index (of its value);
// ent_off packs ((du + W) << 5 | du mod W) | ((dv + W) << 5 | dv mod W) << 16.
template <typename T, int W, int NP, typename Taps>
__global__ void __launch_bounds__(SPREAD_THREADS)
tile_spread_kernel(const int* __restrict__ ent_pos, const int* __restrict__ ent_off,
                   const int* __restrict__ ent_start, const int* __restrict__ order,
                   const int* __restrict__ p0, Taps taps, const T* __restrict__ wsc,
                   const typename Vec2<T>::type* __restrict__ vis, long long cs,
                   long long ss, typename Vec2<T>::type* __restrict__ grid, int n,
                   int nu, int nv, int nplanes, int ntaps, int tile_u, int tile_v,
                   int ntv, int plane_block, int nblk, int groups, int block_lists) {
    using V2 = typename Vec2<T>::type;
    constexpr int R = spread_residues<W>();
    constexpr int C = spread_group<W>();
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile = blockIdx.x / nblk;
    const int pb0 = (blockIdx.x % nblk) * plane_block;
    const int npb = min(plane_block, nplanes - pb0);
    const int tu = tile / ntv, tv = tile - tu * ntv;
    const int hu = min(tile_u, nu - tu * tile_u), hv = min(tile_v, nv - tv * tile_v);
    const int pitch = tile_v | 1;  // odd: consecutive rows start in other banks
    const int plane_cells = tile_u * pitch;

    V2* acc = reinterpret_cast<V2*>(smem);  // (plane_block, tile_u, pitch)
    unsigned char* stage = smem + (size_t)plane_block * plane_cells * sizeof(V2);
    const size_t stage_bytes = spread_stage_bytes<T, W>(plane_block);

    for (int i = threadIdx.x; i < npb * plane_cells; i += blockDim.x)
        acc[i] = vec2(T(0), T(0));
    if constexpr (Taps::has_table) {
        if (taps.staged) {
            T* s_tab = reinterpret_cast<T*>(stage + 2 * stage_bytes);
            for (int i = threadIdx.x; i < taps.ntab; i += blockDim.x)
                s_tab[i] = taps.table[i];
            taps.s_tab = s_tab;
        }
        __syncthreads();  // the table is in before the first chunk is staged
    }

    const int tid = threadIdx.x;
    const int consumers = groups * C;
    const int producer0 = (consumers + 31) & ~31;
    const bool producer = tid >= producer0;
    const int lane = tid - producer0;
    const int list = block_lists ? (int)blockIdx.x : tile;
    const int lo = ent_start[list], hi = ent_start[list + 1];

    // consumer (g, c): its residues c + k * C and its NP planes g * NP + q < npb
    const int g = tid / C;
    const int c = tid - g * C;
    const bool active = tid < consumers;
    int ra[R], rb[R], cur[R];
    bool own[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const int r = c + k * C;
        own[k] = r < W * W;
        ra[k] = own[k] ? r / W : 0;
        rb[k] = own[k] ? r - (r / W) * W : 0;
        cur[k] = -1;
    }
    int pl[NP], base[NP];
    bool held[NP];
    V2 sum[R][NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
        pl[q] = g * NP + q;
        base[q] = pl[q] * plane_cells;
        held[q] = active && pl[q] < npb;
#pragma unroll
        for (int k = 0; k < R; ++k) sum[k][q] = vec2(T(0), T(0));
    }

    // a producer lane's entry of the chunk it stages next, loaded a chunk
    // ahead
    int npos = 0, noff = 0;
#define SPREAD_AHEAD(C0)                        \
    if ((C0) + lane < hi) {                     \
        npos = ent_pos[(C0) + lane];            \
        noff = ent_off[(C0) + lane];            \
    }
#define SPREAD_STAGE(BUF, C0)                                                          \
    if ((C0) + lane < hi) {                                                            \
        const int pos = npos, o = noff;                                                \
        SPREAD_AHEAD((C0) + SPREAD_CHUNK)                                              \
        spread_stage<T, W, Taps>(BUF, lane, pos, o, taps, order, p0, wsc, vis, cs, ss, \
                                 n, ntaps, pb0, npb, plane_block, hu, hv, pitch);      \
    }
    if (producer) {
        SPREAD_AHEAD(lo)
        SPREAD_STAGE(stage, lo)
    }
    __syncthreads();  // chunk 0 staged, the tile zeroed
    int k = 0;
    for (int c0 = lo; c0 < hi; c0 += SPREAD_CHUNK, ++k) {
        if (producer) {
            SPREAD_STAGE(stage + ((k + 1) & 1) * stage_bytes, c0 + SPREAD_CHUNK)
        } else if (active) {
            spread_consume<T, W, NP, R, Taps::sparse>(
                stage + (k & 1) * stage_bytes, min(SPREAD_CHUNK, hi - c0), ra, rb, own,
                plane_block, ntaps, pl, base, held, acc, sum, cur);
        }
        __syncthreads();  // chunk k spread, chunk k + 1 staged
    }
#undef SPREAD_STAGE
#undef SPREAD_AHEAD
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (cur[r] >= 0) spread_flush<T, NP>(acc, base, held, cur[r], sum[r]);
    __syncthreads();  // every sum is in
    const int cells = hu * hv;
    for (int i = threadIdx.x; i < npb * cells; i += blockDim.x) {
        const int p = i / cells, rem = i - p * cells;
        const int lu = rem / hv, lv = rem - lu * hv;
        grid[((size_t)(pb0 + p) * nu + (size_t)tu * tile_u + lu) * nv
             + (size_t)tv * tile_v + lv] = acc[p * plane_cells + lu * pitch + lv];
    }
}

// One launch of tile_spread_kernel with NP planes a consumer (ceil(plane_block
// / groups)) and ntab table values staged: refused (invalid value) if the
// layout breaks a limit: more than SPREAD_MAXP planes a consumer, more
// threads than SPREAD_THREADS, more shared memory than SPREAD_BUDGET, more
// w-taps than W (or correlations than planes), offsets that do not pack, or
// a zero count.
template <typename T, int W, int NP, typename Taps>
int spread_launch(const int* ent_pos, const int* ent_off, const int* ent_start,
                  const int* order, const int* p0, Taps taps, const void* wsc,
                  const void* vis, long long cs, long long ss, void* grid, int n, int nu,
                  int nv, int nplanes, int ntaps, int tile_u, int tile_v, int ntiles,
                  int ntv, int plane_block, int groups, int block_lists, int chunk,
                  int ntab, cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const int consumers = groups * spread_group<W>();
    const int threads = ((consumers + 31) & ~31) + 32 * SPREAD_PRODUCERS;
    if (ntiles <= 0 || nplanes <= 0 || plane_block <= 0 || groups <= 0
        || tile_u <= 0 || tile_v <= 0 || ntaps <= 0 || ntaps > W
        || (wsc == nullptr && ntaps != plane_block)
        || (spread_residues<W>() > 1 && groups != 1)
        || chunk != SPREAD_CHUNK || (plane_block + groups - 1) / groups != NP
        || threads > SPREAD_THREADS || tile_u + 2 * W >= (1 << 11)
        || tile_v + 2 * W >= (1 << 11))
        return (int)cudaErrorInvalidValue;
    const size_t smem = spread_smem<T, W>(plane_block, tile_u, tile_v, ntab);
    if (smem > (size_t)SPREAD_BUDGET) return (int)cudaErrorInvalidValue;
    const int nblk = (nplanes + plane_block - 1) / plane_block;
    tile_spread_kernel<T, W, NP, Taps><<<ntiles * nblk, threads, smem, stream>>>(
        ent_pos, ent_off, ent_start, order, p0, taps, static_cast<const T*>(wsc),
        static_cast<const V2*>(vis), cs, ss, static_cast<V2*>(grid), n, nu, nv, nplanes,
        ntaps, tile_u, tile_v, ntv, plane_block, nblk, groups, block_lists);
    return (int)cudaGetLastError();
}

// The tile spread of the w-stack and 2D maps (ES taps), instantiated for
// each count of planes a consumer holds.
template <typename T, int W>
int tile_spread(const int* ent_pos, const int* ent_off, const int* ent_start,
                const int* order, const int* p0, const void* uf, const void* vf,
                const void* wsc, const void* vis, long long cs, long long ss, void* grid,
                int n, int nu, int nv, int nplanes, int ntaps, int tile_u, int tile_v,
                int ntiles, int ntv, int plane_block, int groups, int chunk, double beta,
                cudaStream_t stream) {
    const EsTaps<T, W> taps{static_cast<const T*>(uf), static_cast<const T*>(vf), (T)beta};
    const int np = (plane_block + groups - 1) / max(groups, 1);
#define SPREAD_LAUNCH(NP)                                                                \
    return spread_launch<T, W, NP, EsTaps<T, W>>(                                         \
        ent_pos, ent_off, ent_start, order, p0, taps, wsc, vis, cs, ss, grid, n, nu, nv,  \
        nplanes, ntaps, tile_u, tile_v, ntiles, ntv, plane_block, groups, 0, chunk, 0,    \
        stream)
    switch (np) {  // the planes a consumer holds: a compile-time count
        case 1: SPREAD_LAUNCH(1);
        case 2: SPREAD_LAUNCH(2);
        case 3: SPREAD_LAUNCH(3);
        case 4: SPREAD_LAUNCH(4);
        case 5: SPREAD_LAUNCH(5);
        default: return (int)cudaErrorInvalidValue;
    }
#undef SPREAD_LAUNCH
}

template <typename T, int W, int NP, typename Taps>
int allow_spread_budget() {
    return (int)cudaFuncSetAttribute(tile_spread_kernel<T, W, NP, Taps>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     SPREAD_BUDGET);
}

template <typename T, int W>
int allow_es_spread_budget() {
    int err = allow_spread_budget<T, W, 1, EsTaps<T, W>>();
    err = err ? err : allow_spread_budget<T, W, 2, EsTaps<T, W>>();
    err = err ? err : allow_spread_budget<T, W, 3, EsTaps<T, W>>();
    err = err ? err : allow_spread_budget<T, W, 4, EsTaps<T, W>>();
    return err ? err : allow_spread_budget<T, W, 5, EsTaps<T, W>>();
}

// Lets every ES tile spread instance of T take SPREAD_BUDGET bytes of
// dynamic shared memory on the current device (a template, so that a file
// that does not call it does not compile those instances).
template <typename T>
int allow_es_spread_budget_all() {
    int err = allow_es_spread_budget<T, 4>();
    err = err ? err : allow_es_spread_budget<T, 6>();
    err = err ? err : allow_es_spread_budget<T, 8>();
    return err ? err : allow_es_spread_budget<T, 10>();
}

// ------------------------------------------------------------ tile gather

constexpr int GATHER_THREADS = 256;               // 8 warps: 16 samples at a time
constexpr int GATHER_SLOTS = GATHER_THREADS / 16;  // one sample a half-warp

// The row pitch (cells) of a staged tile of cols columns: the least >= cols
// that is = W (mod 16), so that 16 consecutive taps of a window fall in 16
// different bank pairs (complex64; 8 of 16 bank quads, complex128).
__host__ __device__ constexpr int gather_pitch(int cols, int W) {
    return cols + (((W - cols) % 16) + 16) % 16;
}

template <typename T, int NC>
__host__ __device__ constexpr size_t gather_smem(int tile_u, int tile_v, int W) {
    return (size_t)NC * (tile_u + W - 1) * gather_pitch(tile_v + W - 1, W)
               * sizeof(typename Vec2<T>::type)
           + (size_t)GATHER_SLOTS * 2 * W * sizeof(T);
}

// The w-stack gather's row pitch (odd) and plane stride (= W * pitch mod
// 16) of a staged tile of rows x cols cells: the window row (t, a), at
// t * plane + a * pitch = pitch * (t * W + a) (mod 16), so the 16 rows q =
// t * W + a that a half-warp reads at once lie in 16 different bank pairs
// (pitch odd is a unit mod 16).
__host__ __device__ constexpr int stack_pitch(int cols) { return cols | 1; }

__host__ __device__ constexpr int stack_plane(int rows, int cols, int W) {
    return rows * stack_pitch(cols)
           + (((W * stack_pitch(cols) - rows * stack_pitch(cols)) % 16) + 16) % 16;
}

// The stack gather's lanes a sample (a group takes the W * WS window
// rows): 4 up to W = 8, else 16.
__host__ __device__ constexpr int stack_lanes(int W) { return W <= 8 ? 4 : 16; }

template <typename T, int W>
__host__ __device__ constexpr size_t stack_gather_smem(int plane_block, int tile_u,
                                                       int tile_v) {
    return (size_t)plane_block * stack_plane(tile_u + W - 1, tile_v + W - 1, W)
               * sizeof(typename Vec2<T>::type)
           + (size_t)(GATHER_THREADS / stack_lanes(W)) * 3 * W * sizeof(T);
}

// The table gather's lanes a sample: 4 up to W = 8, else 16.
__host__ __device__ constexpr int table_lanes(int W) { return W <= 8 ? 4 : 16; }

// The table gather's staged tile: the tile, its W - 1 halo after it and,
// on the grid's first tile row or column, W - 1 lead cells before it (off
// the grid, staged as zero), rows at an odd pitch.
template <int W>
__host__ __device__ constexpr size_t table_gather_cells(int tile) {
    return (size_t)(tile + 2 * (W - 1)) * stack_pitch(tile + 2 * (W - 1));
}

template <typename T, int W>
__host__ __device__ constexpr size_t table_gather_smem(int tile, int ntab) {
    return table_gather_cells<W>(tile) * sizeof(typename Vec2<T>::type)
           + (size_t)ntab * sizeof(T);
}

// An asynchronous copy of one cell (8 or 16 bytes) from device memory to
// shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async_cell(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A block stages rows x cols cells of np planes of the grid (plane stride
// gplane cells; nu x nv a plane), the first at grid row r0 and column c0,
// into s_g (plane stride splane, row pitch pitch): a warp a row, every
// plane of a cell from one index, cp.async. WRAP: the rows and columns
// wrap mod nu, nv (r0, c0 in [0, nu), [0, nv)), resolved by subtraction
// once per cell (an integer division per cell made the staging as costly
// in issued instructions as the gather itself; the loops run more than
// once only on a grid narrower than the window); else a cell off [0, nu)
// x [0, nv) is staged as zero.
template <bool WRAP, typename V2>
__device__ __forceinline__ void gather_stage(V2* s_g, const V2* __restrict__ grid, int np,
                                             size_t gplane, int splane, int rows, int cols,
                                             int pitch, int r0, int c0, int nu, int nv) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < rows; r += GATHER_THREADS / 32) {
        int gu = r0 + r;
        if constexpr (WRAP) {
            while (gu >= nu) gu -= nu;
        }
        for (int j = lane; j < cols; j += 32) {
            int gv = c0 + j;
            if constexpr (WRAP) {
                while (gv >= nv) gv -= nv;
            }
            V2* dst = s_g + r * pitch + j;
            if (WRAP || ((unsigned)gu < (unsigned)nu && (unsigned)gv < (unsigned)nv)) {
                const V2* src = grid + (size_t)gu * nv + gv;
#pragma unroll 4
                for (int c = 0; c < np; ++c)
                    cp_async_cell<sizeof(V2)>(dst + (size_t)c * splane, src + c * gplane);
            } else {
                for (int c = 0; c < np; ++c) dst[(size_t)c * splane] = V2{};
            }
        }
    }
}

// The sum over the 2M lanes of a group (a half-warp: M = 8) of each of its
// lanes' values acc[0 .. HELD - 1], in a fixed order: at offset M the lane
// with bit M set keeps the upper half of the values held and its partner
// the lower, each adding the other's half; once one value is left, the
// rest of the offsets sum it. Lane h then holds value (h >> (log2 2M -
// log2 V)).
template <int HELD, int M, typename T, int V>
__device__ __forceinline__ void gather_reduce(T (&acc)[V], int h) {
    if constexpr (M >= 1) {
        if constexpr (HELD > 1) {
            constexpr int H = HELD / 2;
            const bool upper = (h & M) != 0;
#pragma unroll
            for (int i = 0; i < H; ++i) {
                const T send = upper ? acc[i] : acc[i + H];
                const T keep = upper ? acc[i + H] : acc[i];
                acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, M, 16);
            }
            gather_reduce<H, M / 2>(acc, h);
        } else {
            acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], M, 16);
            gather_reduce<1, M / 2>(acc, h);
        }
    }
}

// A sample's real and imaginary sums (re, im on every lane h < L of its
// group of L = 8 or 16 lanes) reduced over the group and written by lanes
// 0 and L / 2 to the sample's own complex value out[sample].
template <int L, typename T>
__device__ __forceinline__ void gather_write(T re, T im, int h, bool valid, T* out,
                                             int sample) {
    T acc[2] = {re, im};
    gather_reduce<2, L / 2>(acc, h);
    if (valid && (h & (L / 2 - 1)) == 0) out[(size_t)sample * 2 + h / (L / 2)] = acc[0];
}

// The 2D map: one block per listed tile (tiles[blockIdx.x]) of the (NC,
// nu, nv) grid: the values of its samples, plan positions home_start[tile]
// .. home_start[tile + 1] - 1 (the samples whose window start lies in the
// tile), written to out (n, NC) at their sample index order[pos].
template <typename T, int W, int NC>
__global__ void __launch_bounds__(GATHER_THREADS)
tile_gather_kernel(const int* __restrict__ tiles, const int* __restrict__ home_start,
                   const int* __restrict__ order, const int* __restrict__ iu0,
                   const int* __restrict__ iv0, const T* __restrict__ uf,
                   const T* __restrict__ vf,
                   const typename Vec2<T>::type* __restrict__ grid,
                   T* __restrict__ out, int nu, int nv, int tile_u, int tile_v, int ntv,
                   T beta) {
    using V2 = typename Vec2<T>::type;
    constexpr int STEPS = (W * W + 15) / 16;  // taps a lane takes per sample
    constexpr int V = 2 * NC;                 // partial sums a lane holds
    constexpr int LV = V == 8 ? 3 : V == 4 ? 2 : 1;
    static_assert(V == 2 || V == 4 || V == 8, "NC in 1, 2, 4");
    extern __shared__ __align__(16) unsigned char smem[];
    const int tile = tiles[blockIdx.x];
    const int tu = tile / ntv, tv = tile - tu * ntv;
    const int u0 = tu * tile_u, v0 = tv * tile_v;
    const int hu = min(tile_u, nu - u0), hv = min(tile_v, nv - v0);
    const int pitch = gather_pitch(tile_v + W - 1, W);
    const int plane = (tile_u + W - 1) * pitch;
    V2* s_g = reinterpret_cast<V2*>(smem);                  // (NC, tile_u + W - 1, pitch)
    T* s_es = reinterpret_cast<T*>(s_g + (size_t)NC * plane);  // (SLOTS, 2W)

    // the tile and its halo, every correlation (u0 + r < nu + tile_u + W)
    gather_stage<true>(s_g, grid, NC, (size_t)nu * nv, plane, hu + W - 1, hv + W - 1,
                       pitch, u0, v0, nu, nv);

    // a lane's taps of a sample: k = 16 s + h at (k / W, k mod W)
    const int h = threadIdx.x & 15;
    const int slot = threadIdx.x >> 4;
    const int warp = threadIdx.x >> 5;
    int ka[STEPS], kb[STEPS], off[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
        const int k = 16 * s + h;
        ka[s] = k < W * W ? k / W : -1;
        kb[s] = k < W * W ? k - (k / W) * W : 0;
        off[s] = ka[s] * pitch + kb[s];
    }
    T* es = s_es + slot * 2 * W;
    // a half-warp's sample geometry, loaded a round ahead (the first round's
    // while the tile stages); a listed tile has samples, so hi > lo
    const int lo = home_start[tile], hi = home_start[tile + 1];
    int next = min(lo + 2 * warp + (slot & 1), hi - 1);
    T nuf = uf[next], nvf = vf[next];
    int niu = iu0[next], niv = iv0[next], nout = order[next];
    cp_async_wait_all();
    __syncthreads();  // the tile is staged

    const T half = T(W) / T(2);
    // a warp takes two samples at a time (both halves run every shuffle)
    for (int base = lo + 2 * warp; base < hi; base += GATHER_SLOTS) {
        const bool valid = base + (slot & 1) < hi;
        const T u = nuf, v = nvf;
        int lu = niu, lv = niv;
        const int sample = nout;
        next = min(base + GATHER_SLOTS + (slot & 1), hi - 1);
        nuf = uf[next];
        nvf = vf[next];
        niu = iu0[next];
        niv = iv0[next];
        nout = order[next];
        // the window start mod nu, nv by subtraction (the planner's iu0 lies
        // in [-(W/2 - 1), nu): the loops run at most once there)
        while (lu < 0) lu += nu;
        while (lu >= nu) lu -= nu;
        while (lv < 0) lv += nv;
        while (lv >= nv) lv -= nv;
        lu -= u0;
        lv -= v0;
        for (int t = h; t < 2 * W; t += 16)
            es[t] = es_tap(((t < W ? u : v) - T(t < W ? t : t - W)) / half, beta);
        __syncwarp();
        T acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = T(0);
        const V2* win = s_g + lu * pitch + lv;
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
            if (ka[s] < 0) continue;
            const T w = es[ka[s]] * es[W + kb[s]];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const V2 x = win[c * plane + off[s]];
                acc[2 * c] += w * x.x;
                acc[2 * c + 1] += w * x.y;
            }
        }
        gather_reduce<V, 8>(acc, h);
        // lane h holds value (h >> (4 - LV)) of [re0, im0, re1, ...]
        if (valid && (h & ((1 << (4 - LV)) - 1)) == 0)
            out[(size_t)sample * V + (h >> (4 - LV))] = acc[0];
        __syncwarp();  // the taps are read before the next sample's are written
    }
}

// A launch of tile_gather_kernel over ntiles listed tiles: refused
// (invalid value) beyond SPREAD_BUDGET bytes of shared memory.
template <typename T, int W, int NC>
int tile_gather(const int* tiles, const int* home_start, const int* order,
                const int* iu0, const int* iv0, const void* uf, const void* vf,
                const void* grid, void* out, int ntiles, int nu, int nv, int tile_u,
                int tile_v, int ntv, double beta, cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const size_t smem = gather_smem<T, NC>(tile_u, tile_v, W);
    if (ntiles < 0 || tile_u <= 0 || tile_v <= 0 || smem > (size_t)SPREAD_BUDGET)
        return (int)cudaErrorInvalidValue;
    if (ntiles == 0) return (int)cudaSuccess;
    tile_gather_kernel<T, W, NC><<<ntiles, GATHER_THREADS, smem, stream>>>(
        tiles, home_start, order, iu0, iv0, static_cast<const T*>(uf),
        static_cast<const T*>(vf), static_cast<const V2*>(grid), static_cast<T*>(out),
        nu, nv, tile_u, tile_v, ntv, (T)beta);
    return (int)cudaGetLastError();
}

template <typename T, int W>
int allow_gather_budget() {
    int err = (int)cudaFuncSetAttribute(tile_gather_kernel<T, W, 1>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        SPREAD_BUDGET);
    err = err ? err : (int)cudaFuncSetAttribute(tile_gather_kernel<T, W, 2>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                SPREAD_BUDGET);
    return err ? err : (int)cudaFuncSetAttribute(tile_gather_kernel<T, W, 4>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 SPREAD_BUDGET);
}

// The w-stack map: one block per listed (uv tile, block of planes),
// blocks[4 b ..] = (tile, first plane pb0, lo, hi): planes pb0 .. pb0 +
// plane_block - 1 (cut to the stack) of the (nplanes, nu, nv) grid,
// staged with the tile's halo; its samples are gather positions lo .. hi
// - 1, plan position gpos[i] (i itself where gpos is null: one block of
// planes, the plan's own order), each with its whole w-window p0 .. p0 +
// WS - 1 in the block's planes. L = stack_lanes(W) lanes take a
// sample: the 2W ES taps and the WS w-taps once, then the W * WS window
// rows (t, a), q = t * W + a = L s + h, a lane a row: the row's W cells
// times the column taps (held in registers), times the row's w-tap x ES
// tap. The value goes to out[order[pos]].
template <typename T, int W, int WS>
__global__ void __launch_bounds__(GATHER_THREADS)
stack_gather_kernel(const int* __restrict__ blocks, const int* __restrict__ gpos,
                    const int* __restrict__ order, const int* __restrict__ iu0,
                    const int* __restrict__ iv0, const int* __restrict__ p0,
                    const T* __restrict__ uf, const T* __restrict__ vf,
                    const T* __restrict__ wsc,
                    const typename Vec2<T>::type* __restrict__ grid,
                    T* __restrict__ out, int n, int nu, int nv, int nplanes, int tile_u,
                    int tile_v, int ntv, int plane_block, T beta) {
    using V2 = typename Vec2<T>::type;
    constexpr int L = stack_lanes(W);
    constexpr int ROWS = W * WS;                // (w-tap, row) pairs of a window
    constexpr int STEPS = (ROWS + L - 1) / L;  // rows a lane takes per sample
    constexpr int SLOTS = GATHER_THREADS / L;  // samples a block takes at once
    constexpr int PER_WARP = 32 / L;
    constexpr int NW = (WS + L - 1) / L;       // w-taps a lane loads
    extern __shared__ __align__(16) unsigned char smem[];
    const int* blk = blocks + 4 * (size_t)blockIdx.x;
    const int tile = blk[0], pb0 = blk[1];
    const int npb = min(plane_block, nplanes - pb0);
    const int tu = tile / ntv, tv = tile - tu * ntv;
    const int u0 = tu * tile_u, v0 = tv * tile_v;
    const int hu = min(tile_u, nu - u0), hv = min(tile_v, nv - v0);
    const int pitch = stack_pitch(tile_v + W - 1);
    const int plane = stack_plane(tile_u + W - 1, tile_v + W - 1, W);
    V2* s_g = reinterpret_cast<V2*>(smem);  // (plane_block, tile_u + W - 1, pitch)
    T* s_k = reinterpret_cast<T*>(s_g + (size_t)plane_block * plane);  // (SLOTS, 3W)

    gather_stage<true>(s_g, grid + (size_t)pb0 * nu * nv, npb, (size_t)nu * nv, plane,
                       hu + W - 1, hv + W - 1, pitch, u0, v0, nu, nv);

    // a lane's rows of a window: q = L s + h = t * W + a, at t * plane + a
    // * pitch, with its ES tap k[a] and w-tap k[2W + t]
    const int h = threadIdx.x % L;
    const int slot = threadIdx.x / L, sub = slot % PER_WARP;
    const int warp = threadIdx.x >> 5;
    int roff[STEPS], ra[STEPS], rt[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
        const int q = L * s + h;
        const int t = q / W, a = q - (q / W) * W;
        ra[s] = q < ROWS ? a : -1;
        rt[s] = 2 * W + t;
        roff[s] = t * plane + a * pitch;
    }
    T* k = s_k + slot * 3 * W;  // eu[W], ev[W], ws[WS]
    // a group's sample, loaded a round ahead (the first round's while the
    // tile stages); a listed block has samples, so hi > lo
    const int lo = blk[2], hi = blk[3];
    int next = min(lo + PER_WARP * warp + sub, hi - 1);
    int npos = gpos != nullptr ? gpos[next] : next;
    T nuf = uf[npos], nvf = vf[npos];
    T nws[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j)
        nws[j] = h + j * L < WS ? wsc[(size_t)(h + j * L) * n + npos] : T(0);
    int niu = iu0[npos], niv = iv0[npos], np0 = p0[npos], nout = order[npos];
    cp_async_wait_all();
    __syncthreads();  // the planes are staged

    const T half = T(W) / T(2);
    for (int base = lo + PER_WARP * warp; base < hi; base += SLOTS) {
        const bool valid = base + sub < hi;
        const T u = nuf, v = nvf;
        T ws[NW];
#pragma unroll
        for (int j = 0; j < NW; ++j) ws[j] = nws[j];
        int lu = niu, lv = niv;
        const int p = np0 - pb0, sample = nout;
        next = min(base + SLOTS + sub, hi - 1);
        npos = gpos != nullptr ? gpos[next] : next;
        nuf = uf[npos];
        nvf = vf[npos];
#pragma unroll
        for (int j = 0; j < NW; ++j)
            if (h + j * L < WS) nws[j] = wsc[(size_t)(h + j * L) * n + npos];
        niu = iu0[npos];
        niv = iv0[npos];
        np0 = p0[npos];
        nout = order[npos];
        while (lu < 0) lu += nu;
        while (lu >= nu) lu -= nu;
        while (lv < 0) lv += nv;
        while (lv >= nv) lv -= nv;
        lu -= u0;
        lv -= v0;
        for (int t = h; t < 2 * W; t += L)
            k[t] = es_tap(((t < W ? u : v) - T(t < W ? t : t - W)) / half, beta);
#pragma unroll
        for (int j = 0; j < NW; ++j)
            if (h + j * L < WS) k[2 * W + h + j * L] = ws[j];
        __syncwarp();
        T ev[W];
#pragma unroll
        for (int b = 0; b < W; ++b) ev[b] = k[W + b];
        T re = T(0), im = T(0);
        const V2* win = s_g + (size_t)p * plane + lu * pitch + lv;
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
            if (ra[s] < 0) continue;
            const V2* row = win + roff[s];
            T xr = T(0), xi = T(0);
#pragma unroll
            for (int b = 0; b < W; ++b) {
                const V2 x = row[b];
                xr += ev[b] * x.x;
                xi += ev[b] * x.y;
            }
            const T w = k[rt[s]] * k[ra[s]];
            re += w * xr;
            im += w * xi;
        }
        gather_write<L>(re, im, h, valid, out, sample);
        __syncwarp();  // the taps are read before the next sample's are written
    }
}

// A launch of stack_gather_kernel over nblocks listed (tile, plane block)
// blocks: refused (invalid value) beyond SPREAD_BUDGET bytes of shared
// memory or with fewer planes a block than w-taps.
template <typename T, int W, int WS>
int stack_gather(const int* blocks, const int* gpos, const int* order, const int* iu0,
                 const int* iv0, const int* p0, const void* uf, const void* vf, const void* wsc,
                 const void* grid, void* out, int nblocks, int n, int nu, int nv,
                 int nplanes, int tile_u, int tile_v, int ntv, int plane_block,
                 double beta, cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const size_t smem = stack_gather_smem<T, W>(plane_block, tile_u, tile_v);
    if (nblocks < 0 || tile_u <= 0 || tile_v <= 0 || plane_block < WS
        || smem > (size_t)SPREAD_BUDGET)
        return (int)cudaErrorInvalidValue;
    if (nblocks == 0) return (int)cudaSuccess;
    stack_gather_kernel<T, W, WS><<<nblocks, GATHER_THREADS, smem, stream>>>(
        blocks, gpos, order, iu0, iv0, p0,
        static_cast<const T*>(uf), static_cast<const T*>(vf), static_cast<const T*>(wsc),
        static_cast<const V2*>(grid), static_cast<T*>(out), n, nu, nv, nplanes, tile_u,
        tile_v, ntv, plane_block, (T)beta);
    return (int)cudaGetLastError();
}

template <typename T, int W>
int allow_stack_gather_budget() {
    const int err = (int)cudaFuncSetAttribute(stack_gather_kernel<T, W, 1>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              SPREAD_BUDGET);
    return err ? err : (int)cudaFuncSetAttribute(stack_gather_kernel<T, W, W>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 SPREAD_BUDGET);
}

// The table map: one block per listed (uv tile, band), list l =
// blocks[blockIdx.x] = tile * nband + band of the (nband, npix, npix)
// grids, its samples plan positions home_start[l] .. home_start[l + 1] -
// 1 (the kept samples whose window's first grid cell lies in the tile),
// their window starts ir0, ic0 and table fractions fr, fc in plan order.
// The tile and its halo are staged cut to the grid, with W - 1 lead rows
// (columns) of zeros on the first tile row (column), where a window may
// start before the grid: no tap wraps, and an off-grid tap reads a zero.
// L = table_lanes(W) lanes take a sample, a lane a window row a = L s + h
// (one step up to W = L): the row's W cells times the column taps
// K[(b + 1) os + fc], which every lane holds in registers, then times the
// row tap K[(a + 1) os + fr]; the taps are read from the block's staged
// table, or from device memory where tab_smem is 0. The rows have an odd
// pitch, so a sample's rows lie in different bank pairs. The value goes to
// out[order[pos]].
template <typename T, int W>
__global__ void __launch_bounds__(GATHER_THREADS)
table_gather_kernel(const int* __restrict__ blocks, const int* __restrict__ home_start,
                    const int* __restrict__ order, const int* __restrict__ ir0,
                    const int* __restrict__ ic0, const int* __restrict__ fr,
                    const int* __restrict__ fc, const T* __restrict__ table, int ntab,
                    int os, int tab_smem, const typename Vec2<T>::type* __restrict__ grid,
                    T* __restrict__ out, int npix, int nband, int tile, int ntc) {
    using V2 = typename Vec2<T>::type;
    constexpr int L = table_lanes(W);
    constexpr int STEPS = (W + L - 1) / L;        // rows a lane takes per sample
    constexpr int SLOTS = GATHER_THREADS / L;     // samples a block takes at once
    constexpr int PER_WARP = 32 / L;
    extern __shared__ __align__(16) unsigned char smem[];
    const int list = blocks[blockIdx.x];
    const int t = list / nband, band = list - t * nband;
    const int tr = t / ntc, tc = t - tr * ntc;
    const int r0 = tr * tile, c0 = tc * tile;
    const int lr = r0 == 0 ? W - 1 : 0, lc = c0 == 0 ? W - 1 : 0;
    const int rows = lr + min(tile, npix - r0) + W - 1;
    const int cols = lc + min(tile, npix - c0) + W - 1;
    const int pitch = stack_pitch(tile + 2 * (W - 1));
    V2* s_g = reinterpret_cast<V2*>(smem);
    T* s_tab = reinterpret_cast<T*>(s_g + table_gather_cells<W>(tile));

    gather_stage<false>(s_g, grid + (size_t)band * npix * npix, 1, 0, 0, rows, cols,
                        pitch, r0 - lr, c0 - lc, npix, npix);
    if (tab_smem)
        for (int i = threadIdx.x; i < ntab; i += GATHER_THREADS) s_tab[i] = table[i];
    // generic loads: the staged copy in shared memory, or device memory
    const T* tab = tab_smem ? s_tab : table;

    const int h = threadIdx.x % L;
    const int sub = (threadIdx.x / L) % PER_WARP;
    const int warp = threadIdx.x >> 5;
    int ra[STEPS], roff[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
        const int a = L * s + h;
        ra[s] = a < W ? a : -1;
        roff[s] = a * pitch;
    }
    // a group's sample geometry, loaded a round ahead (the first round's
    // while the tile stages); a listed block has samples, so hi > lo
    const int lo = home_start[list], hi = home_start[list + 1];
    int next = min(lo + PER_WARP * warp + sub, hi - 1);
    int nr = ir0[next], nc = ic0[next], nfr = fr[next], nfc = fc[next];
    int nout = order[next];
    cp_async_wait_all();
    __syncthreads();  // the tile and the table are staged

    for (int base = lo + PER_WARP * warp; base < hi; base += SLOTS) {
        const bool valid = base + sub < hi;
        const V2* win = s_g + (nr - (r0 - lr)) * pitch + nc - (c0 - lc);
        const int f_r = nfr, f_c = nfc, sample = nout;
        next = min(base + SLOTS + sub, hi - 1);
        nr = ir0[next];
        nc = ic0[next];
        nfr = fr[next];
        nfc = fc[next];
        nout = order[next];
        T kc[W];
#pragma unroll
        for (int b = 0; b < W; ++b) kc[b] = tab[(b + 1) * os + f_c];
        T re = T(0), im = T(0);
#pragma unroll
        for (int s = 0; s < STEPS; ++s) {
            if (ra[s] < 0) continue;
            const V2* row = win + roff[s];
            T xr = T(0), xi = T(0);
#pragma unroll
            for (int b = 0; b < W; ++b) {
                const V2 x = row[b];
                xr += kc[b] * x.x;
                xi += kc[b] * x.y;
            }
            const T kr = tab[(ra[s] + 1) * os + f_r];
            re += kr * xr;
            im += kr * xi;
        }
        gather_write<L>(re, im, h, valid, out, sample);
    }
}

// A launch of table_gather_kernel over nblocks listed (tile, band) blocks:
// refused (invalid value) beyond SPREAD_BUDGET bytes of shared memory or
// with a table shorter than os * (W + 2).
template <typename T, int W>
int table_gather(const int* blocks, const int* home_start, const int* order,
                 const int* ir0, const int* ic0, const int* fr, const int* fc,
                 const void* table, int ntab, int os, int tab_smem, const void* grid,
                 void* out, int nblocks, int npix, int nband, int tile, int ntc,
                 cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const size_t smem = table_gather_smem<T, W>(tile, tab_smem ? ntab : 0);
    if (nblocks < 0 || tile <= 0 || nband <= 0 || ntab < os * (W + 2)
        || smem > (size_t)SPREAD_BUDGET)
        return (int)cudaErrorInvalidValue;
    if (nblocks == 0) return (int)cudaSuccess;
    table_gather_kernel<T, W><<<nblocks, GATHER_THREADS, smem, stream>>>(
        blocks, home_start, order, ir0, ic0, fr, fc, static_cast<const T*>(table), ntab,
        os, tab_smem, static_cast<const V2*>(grid), static_cast<T*>(out), npix, nband,
        tile, ntc);
    return (int)cudaGetLastError();
}

template <typename T, int W>
int allow_table_gather_budget() {
    return (int)cudaFuncSetAttribute(table_gather_kernel<T, W>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     SPREAD_BUDGET);
}

}  // namespace

#define GRIDDING_SUPPORTS(CALL, T)     \
    switch (support) {                 \
        case 4: return CALL(T, 4);     \
        case 6: return CALL(T, 6);     \
        case 8: return CALL(T, 8);     \
        case 10: return CALL(T, 10);   \
        default: return (int)cudaErrorInvalidValue; \
    }
