// Shared by wgrid.cu and grid2d.cu: the ES kernel, the complex vector
// types, and the tile spread kernel that grids both maps.
//
//   w-stack:  G[p0+t, iu0+a, iv0+b] += wsc[t] * es((uf-a)/(W/2)) * es((vf-b)/(W/2)) * V
//   2D:       G[c, iu0+a, iv0+b]    += es((uf-a)/(W/2)) * es((vf-b)/(W/2)) * V[c]
//
// The 2D map is the w-stack map with p0 = 0 and one "tap" per correlation,
// so one kernel spreads both. Everything per sample and per entry is
// planned on the host (ops/cuda_wgrid.WGridPlan); this file only checks a
// launch's layout against its limits.
//
// The design (Romein, "An efficient work-distribution strategy for
// gridding radio-telescope data on GPUs", ICS 2012, made deterministic):
//  - One block owns one uv tile (tile_u x tile_v cells, no halo) of a
//    block of planes, in shared memory, and writes each of its grid cells
//    exactly once: no padded tiles go through device memory, and there is
//    no fold.
//  - The host lists, per tile and in a fixed order, every entry: a sample
//    whose window meets the tile (its own samples and the neighbours'
//    whose windows spill in), with the window start relative to the tile,
//    du, dv in (-W, tile). A window that wraps mod nu, nv, or a grid
//    narrower than W, gives one entry per periodic copy that meets the
//    tile; the block clips every tap to its tile.
//  - Consumer thread (g, ra, rb) owns the cells whose tile coordinates are
//    = (ra, rb) mod W, in planes g * NP .. g * NP + NP - 1 (NP at most
//    SPREAD_MAXP, a template parameter; a group skips the entries whose
//    w-window misses its planes). Each
//    entry's window holds exactly one such cell, a = (ra - du) mod W, so
//    every consumer works on every entry, without a barrier or a
//    __syncwarp between entries: program order alone orders a thread's
//    deposits. It keeps its sums in registers while its cell stays the
//    same over consecutive entries (the host sorts a tile's entries by
//    window start) and adds them to shared memory when the cell changes.
//    Each cell is summed by one thread in a fixed order: no atomics, and
//    two launches give bitwise-equal grids.
//  - Two producer warps stage the next CHUNK entries, one a lane (their
//    plan-order geometry read contiguously, a chunk ahead; the
//    visibilities gathered; for every consumer residue its cell's offset
//    and ES tap, and per plane the w-tap times V, computed once per entry)
//    into the second of two buffers while the consumers spread the current
//    one: one __syncthreads per chunk. A consumer's step is then a few
//    shared loads, the cell and plane-window compares and one FMA pair per
//    plane, with the next entry's loads issued before it; its flushes load
//    first and store after.
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
constexpr int SPREAD_BUDGET = 227 * 1024;    // dynamic shared memory per block
constexpr int SPREAD_OUT = -(1 << 28);       // a staged row or column off the tile
static_assert(SPREAD_CHUNK == 32 * SPREAD_PRODUCERS, "one staged entry a producer lane");

// One staged residue of an entry along one axis: the owned cell's row
// offset (lu * pitch) or column (lv), SPREAD_OUT where it is off the tile,
// and the ES tap of that cell.
template <typename T>
struct __align__(2 * sizeof(T)) SpreadTap {
    int cell;
    T k;
};

// Bytes of one staging buffer: per entry W row and W column taps (one per
// consumer residue), one value per plane of the block (w-tap times V,
// zero off the entry's w-window; or the correlation's value) and the
// entry's first plane in the block; CHUNK + 1 entries, so that a
// consumer's load of the entry after the last is in bounds (its values
// are never used).
template <typename T, int W>
__host__ __device__ constexpr size_t spread_stage_bytes(int plane_block) {
    // rounded up to 16 bytes: the second buffer's taps stay aligned
    return ((size_t)(SPREAD_CHUNK + 1)
                * (2 * W * sizeof(SpreadTap<T>)
                   + plane_block * sizeof(typename Vec2<T>::type) + sizeof(int))
            + 15) / 16 * 16;
}

template <typename T, int W>
size_t spread_smem(int plane_block, int tile_u, int tile_v) {
    return (size_t)plane_block * tile_u * (tile_v | 1) * sizeof(typename Vec2<T>::type)
           + 2 * spread_stage_bytes<T, W>(plane_block);
}

// A producer lane stages entry q of a chunk into buf (CHUNK is the
// producers' lane count, so one entry a lane): for every consumer residue
// r the owned cell's row (column) offset and ES tap, a = (r - du) mod W;
// and per plane of the block the value to deposit. pos and o are the
// entry's plan position and packed offsets, loaded a chunk ahead. wsc
// non-null: a w-stack (one value per sample, ntaps w-taps, planes pb0 ..
// pb0 + npb - 1); else the 2D map (npb correlations, vis element (c, s) at
// vis[c * cs + s * ss]).
template <typename T, int W>
__device__ __forceinline__ void spread_stage(
        unsigned char* buf, int q, int pos, int o, const int* __restrict__ order,
        const int* __restrict__ p0, const T* __restrict__ uf, const T* __restrict__ vf,
        const T* __restrict__ wsc, const typename Vec2<T>::type* __restrict__ vis,
        long long cs, long long ss, int n, int ntaps, int pb0, int npb, int plane_block,
        int hu, int hv, int pitch, T beta) {
    using V2 = typename Vec2<T>::type;
    SpreadTap<T>* s_u = reinterpret_cast<SpreadTap<T>*>(buf);
    SpreadTap<T>* s_v = s_u + (SPREAD_CHUNK + 1) * W;
    V2* s_w0 = reinterpret_cast<V2*>(s_v + (SPREAD_CHUNK + 1) * W);
    int* s_p = reinterpret_cast<int*>(s_w0 + (SPREAD_CHUNK + 1) * plane_block);
    V2* s_w = s_w0 + q * plane_block;
    const T half = T(W) / T(2);
    const int s = order[pos];
    const T u = uf[pos], v = vf[pos];
    const int du = ((o >> 4) & 0xfff) - W, ru = o & 15;
    const int dv = ((o >> 20) & 0xfff) - W, rv = (o >> 16) & 15;
#pragma unroll
    for (int r = 0; r < W; ++r) {
        const int a = r - ru + (r < ru ? W : 0);
        const int lu = du + a;
        s_u[q * W + r] = {(unsigned)lu < (unsigned)hu ? lu * pitch : SPREAD_OUT,
                          es_tap((u - T(a)) / half, beta)};
        const int b = r - rv + (r < rv ? W : 0);
        const int lv = dv + b;
        s_v[q * W + r] = {(unsigned)lv < (unsigned)hv ? lv : SPREAD_OUT,
                          es_tap((v - T(b)) / half, beta)};
    }
    if (wsc != nullptr) {
        const V2 x = vis[(long long)s * ss];
        const int p = p0[pos] - pb0;
        s_p[q] = p;
        for (int pl = 0; pl < npb; ++pl) {
            const int t = pl - p;
            const T k = (unsigned)t < (unsigned)ntaps ? wsc[(size_t)t * n + pos] : T(0);
            s_w[pl] = vec2(k * x.x, k * x.y);
        }
    } else {
        s_p[q] = 0;
        for (int c = 0; c < npb; ++c) s_w[c] = vis[c * cs + (long long)s * ss];
    }
}

// Add a consumer's running sums to its owned cell cur of each of its NP
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

// A consumer (ra, rb) deposits the cn staged entries of buf, in order, into
// its owned cells of its NP planes pl0 .. pl0 + NP - 1 (pl[q], held[q];
// acc + base[q]), skipping the entries whose planes pw .. pw + ntaps - 1
// miss them. Entry j + 1's operands are loaded before entry j is
// deposited (and its cell flushed), so that their latency overlaps.
template <typename T, int W, int NP>
__device__ __forceinline__ void spread_consume(
        const unsigned char* buf, int cn, int ra, int rb, int plane_block, int ntaps,
        const int (&pl)[NP], const int (&base)[NP], const bool (&held)[NP],
        typename Vec2<T>::type* acc, typename Vec2<T>::type (&sum)[NP], int& cur) {
    using V2 = typename Vec2<T>::type;
    const int* s_p = reinterpret_cast<const int*>(
        reinterpret_cast<const V2*>(reinterpret_cast<const SpreadTap<T>*>(buf)
                                    + 2 * (SPREAD_CHUNK + 1) * W)
        + (SPREAD_CHUNK + 1) * plane_block);
    // the entry's first plane pw meets pl0 .. pl0 + NP - 1 iff
    // pl0 - ntaps < pw < pl0 + NP
    const int pw_lo = pl[0] - ntaps, pw_hi = pl[0] + NP;
    const SpreadTap<T>* s_u = reinterpret_cast<const SpreadTap<T>*>(buf) + ra;
    const SpreadTap<T>* s_v = reinterpret_cast<const SpreadTap<T>*>(buf)
                              + (SPREAD_CHUNK + 1) * W + rb;
    const V2* s_w = reinterpret_cast<const V2*>(
        reinterpret_cast<const SpreadTap<T>*>(buf) + 2 * (SPREAD_CHUNK + 1) * W);
    SpreadTap<T> nu = s_u[0], nv = s_v[0];
    int np_ = s_p[0];
    V2 nw[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q)
        nw[q] = held[q] ? s_w[pl[q]] : vec2(T(0), T(0));
    for (int j = 0; j < cn; ++j) {
        const SpreadTap<T> cu = nu, cv = nv;
        const int pw = np_;
        V2 cw[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) cw[q] = nw[q];
        nu = s_u[(j + 1) * W];  // entry cn: in bounds, never used
        nv = s_v[(j + 1) * W];
        np_ = s_p[j + 1];
        const V2* w = s_w + (j + 1) * plane_block;
#pragma unroll
        for (int q = 0; q < NP; ++q)
            if (held[q]) nw[q] = w[pl[q]];
        const int cell = cu.cell + cv.cell;
        // the owned cell is off the tile, or the entry misses the planes
        if (cell < 0 || pw <= pw_lo || pw >= pw_hi) continue;
        if (cell != cur) {       // the owned cell moved: add the sums, start anew
            if (cur >= 0) spread_flush<T, NP>(acc, base, held, cur, sum);
            cur = cell;
        }
        const T tap = cu.k * cv.k;
#pragma unroll
        for (int q = 0; q < NP; ++q) {
            if (held[q]) {
                sum[q].x += tap * cw[q].x;
                sum[q].y += tap * cw[q].y;
            }
        }
    }
}

// One block per (tile, block of planes): grid (nplanes, nu, nv), every
// cell of the block's tile and planes written. Entries of tile t are
// ent_start[t] .. ent_start[t + 1] - 1; ent_pos is the sample's position
// in plan order (geometry index), order[pos] its sample index (vis index);
// ent_off packs ((du + W) << 4 | du mod W) | ((dv + W) << 4 | dv mod W) << 16.
template <typename T, int W, int NP>
__global__ void __launch_bounds__(SPREAD_THREADS)
tile_spread_kernel(const int* __restrict__ ent_pos, const int* __restrict__ ent_off,
                   const int* __restrict__ ent_start, const int* __restrict__ order,
                   const int* __restrict__ p0, const T* __restrict__ uf,
                   const T* __restrict__ vf, const T* __restrict__ wsc,
                   const typename Vec2<T>::type* __restrict__ vis, long long cs,
                   long long ss, typename Vec2<T>::type* __restrict__ grid, int n,
                   int nu, int nv, int nplanes, int ntaps, int tile_u, int tile_v,
                   int ntv, int plane_block, int nblk, int groups, T beta) {
    using V2 = typename Vec2<T>::type;
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

    const int tid = threadIdx.x;
    const int consumers = groups * W * W;
    const int producer0 = (consumers + 31) & ~31;
    const bool producer = tid >= producer0;
    const int lane = tid - producer0;
    const int lo = ent_start[tile], hi = ent_start[tile + 1];

    // consumer (g, ra, rb) and its NP planes g * NP + q < npb
    const int g = tid / (W * W);
    const int r = tid - g * W * W;
    const int ra = r / W, rb = r - ra * W;
    const bool active = tid < consumers;
    int pl[NP], base[NP];
    bool held[NP];
    V2 sum[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
        pl[q] = g * NP + q;
        base[q] = pl[q] * plane_cells;
        held[q] = active && pl[q] < npb;
        sum[q] = vec2(T(0), T(0));
    }
    int cur = -1;

    // a producer lane's entry of the chunk it stages next, loaded a chunk
    // ahead
    int npos = 0, noff = 0;
#define SPREAD_AHEAD(C)                         \
    if ((C) + lane < hi) {                      \
        npos = ent_pos[(C) + lane];             \
        noff = ent_off[(C) + lane];             \
    }
#define SPREAD_STAGE(BUF, C0)                                                          \
    if ((C0) + lane < hi) {                                                            \
        const int pos = npos, o = noff;                                                \
        SPREAD_AHEAD((C0) + SPREAD_CHUNK)                                              \
        spread_stage<T, W>(BUF, lane, pos, o, order, p0, uf, vf, wsc, vis, cs, ss, n,  \
                           ntaps, pb0, npb, plane_block, hu, hv, pitch, beta);         \
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
            spread_consume<T, W, NP>(stage + (k & 1) * stage_bytes, min(SPREAD_CHUNK, hi - c0),
                                 ra, rb, plane_block, ntaps, pl, base, held, acc, sum, cur);
        }
        __syncthreads();  // chunk k spread, chunk k + 1 staged
    }
#undef SPREAD_STAGE
#undef SPREAD_AHEAD
    if (cur >= 0) spread_flush<T, NP>(acc, base, held, cur, sum);
    __syncthreads();  // every sum is in
    const int cells = hu * hv;
    for (int i = threadIdx.x; i < npb * cells; i += blockDim.x) {
        const int p = i / cells, rem = i - p * cells;
        const int lu = rem / hv, lv = rem - lu * hv;
        grid[((size_t)(pb0 + p) * nu + (size_t)tu * tile_u + lu) * nv
             + (size_t)tv * tile_v + lv] = acc[p * plane_cells + lu * pitch + lv];
    }
}

// The launch of tile_spread_kernel, instantiated for each count of planes a
// consumer holds (ceil(plane_block / groups)): refused (invalid value) if
// the layout breaks a limit: more than SPREAD_MAXP planes a consumer, more threads
// than SPREAD_THREADS, more shared memory than SPREAD_BUDGET, more w-taps
// than W (or correlations than planes), or a zero count.
template <typename T, int W>
int tile_spread(const int* ent_pos, const int* ent_off, const int* ent_start,
                const int* order, const int* p0, const void* uf, const void* vf,
                const void* wsc, const void* vis, long long cs, long long ss, void* grid,
                int n, int nu, int nv, int nplanes, int ntaps, int tile_u, int tile_v,
                int ntiles, int ntv, int plane_block, int groups, int chunk, double beta,
                cudaStream_t stream) {
    using V2 = typename Vec2<T>::type;
    const int consumers = groups * W * W;
    const int threads = ((consumers + 31) & ~31) + 32 * SPREAD_PRODUCERS;
    const int np = (plane_block + groups - 1) / max(groups, 1);
    if (ntiles <= 0 || nplanes <= 0 || plane_block <= 0 || groups <= 0
        || tile_u <= 0 || tile_v <= 0 || ntaps <= 0 || ntaps > W
        || (wsc == nullptr && ntaps != plane_block)
        || chunk != SPREAD_CHUNK || np > SPREAD_MAXP
        || threads > SPREAD_THREADS || tile_u + 2 * W >= 4096 || tile_v + 2 * W >= 4096)
        return (int)cudaErrorInvalidValue;
    const size_t smem = spread_smem<T, W>(plane_block, tile_u, tile_v);
    if (smem > (size_t)SPREAD_BUDGET) return (int)cudaErrorInvalidValue;
    const int nblk = (nplanes + plane_block - 1) / plane_block;
#define SPREAD_LAUNCH(NP)                                                                 \
    tile_spread_kernel<T, W, NP><<<ntiles * nblk, threads, smem, stream>>>(                \
        ent_pos, ent_off, ent_start, order, p0, static_cast<const T*>(uf),                 \
        static_cast<const T*>(vf), static_cast<const T*>(wsc),                             \
        static_cast<const V2*>(vis), cs, ss, static_cast<V2*>(grid), n, nu, nv, nplanes,   \
        ntaps, tile_u, tile_v, ntv, plane_block, nblk, groups, (T)beta)
    switch (np) {  // the planes a consumer holds: a compile-time count
        case 1: SPREAD_LAUNCH(1); break;
        case 2: SPREAD_LAUNCH(2); break;
        case 3: SPREAD_LAUNCH(3); break;
        case 4: SPREAD_LAUNCH(4); break;
        default: SPREAD_LAUNCH(5); break;
    }
#undef SPREAD_LAUNCH
    return (int)cudaGetLastError();
}

template <typename T, int W>
int allow_spread_budget() {
    int err = 0;
#define SPREAD_ALLOW(NP)                                                            \
    err = err ? err : (int)cudaFuncSetAttribute(tile_spread_kernel<T, W, NP>,        \
                                                cudaFuncAttributeMaxDynamicSharedMemorySize, \
                                                SPREAD_BUDGET)
    SPREAD_ALLOW(1);
    SPREAD_ALLOW(2);
    SPREAD_ALLOW(3);
    SPREAD_ALLOW(4);
    SPREAD_ALLOW(5);
#undef SPREAD_ALLOW
    return err;
}

// Lets every tile spread instance take SPREAD_BUDGET bytes of dynamic
// shared memory on the current device.
inline int allow_spread_budget_all() {
    int err = allow_spread_budget<float, 4>();
    err = err ? err : allow_spread_budget<float, 6>();
    err = err ? err : allow_spread_budget<float, 8>();
    err = err ? err : allow_spread_budget<float, 10>();
    err = err ? err : allow_spread_budget<double, 4>();
    err = err ? err : allow_spread_budget<double, 6>();
    err = err ? err : allow_spread_budget<double, 8>();
    return err ? err : allow_spread_budget<double, 10>();
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
