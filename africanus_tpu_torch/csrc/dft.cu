// Direct Fourier transforms between sources/pixels and visibilities, for
// Hopper (sm_90a), with a plain C interface loaded through ctypes.
//
//   forward:  V[r,f,c] = sum_s exp(2*pi*i*delay(s,r)*nu_f) * I[s,f,c]
//   adjoint:  I[p,f,c] = sum_r Re(exp(2*pi*i*delay(p,r)*nu_f) * V[r,f,c])
//
// delay(s,r) = sign*(u*l + v*m + w*(n-1))/c in seconds, a two-float
// (hi, lo) pair computed here, per (source or pixel, row), by the same
// error-free chain as africanus_tpu_torch/rime/phase.py:phase_dot_cycles
// (bitwise: every op is one rounded f32 op in the same order). The phase
// is then 2*pi*frac(delay*nu), reduced mod one cycle at ~48-bit precision.
//
// Replaces the two Pallas TPU kernels of africanus_tpu/ops/pallas_dft.py:
//   dft_forward_pallas / _dft_fwd_kernel (rows on lanes, sources
//     contracted on sublanes), and
//   dft_adjoint_pallas / _dft_adj_kernel (pixels on lanes, rows
//     contracted on sublanes, output revisited over the row grid axis).
// Both are kept as maps, not as schedules: no lane/sublane tiles, no
// 8-row chunks, no padding to 128. What carries over is the per-channel
// phase economics that the host chooses in _chan_group_tables (ported as
// numpy in ops/cuda_dft.py): channels run in groups of cg; per group the
// mode is
//   DIRECT    one two-float phase and one sincospi per channel;
//   EXACT     the phasor at the group's base frequency and at the step,
//             then a unit-phasor recurrence along the group's channels;
//   RESIDUAL  EXACT plus a rotation by 2*pi*delay*delta_f per channel
//             (6th-order small-angle polynomial, no transcendental).
// use_flo extends the frequencies to two-float pairs (f64 grids).
//
// What bounds them on an H100: FP32 instruction issue. Per (pixel or
// source, row, channel group) the delay chain is ~65 rounded f32 ops, each
// phase evaluation ~12 more and a sincospif, and each channel ~20
// (rotation, recurrence, 2*C accumulations). At the config-5 residual
// image (4096 pixels x 38612 rows x 2 groups of 8 channels) that is
// ~1e11 lane-instructions against ~3.4e13/s; bytes are negligible (the
// visibilities are 5 MB, read once per pixel tile through L2).
// What the design does about it:
//  - the delay is computed in the kernel from l, m, n-1 and uvw, so the
//    (pixel, row) delay planes (632 MB each at config 5) never exist; the
//    per-pixel and per-row Dekker splits are hoisted out of the pair loop;
//  - adjoint: one pixel per thread, cg*C accumulators in registers; a
//    block stages a tile of rows (geometry + V of its channel group) in
//    shared memory, read as broadcasts. The grid is (pixel tile, channel
//    group, row chunk) so that a 64-block problem still fills 132 SMs;
//    row chunks write partial images and a second kernel sums them in
//    chunk order: deterministic, no atomics;
//  - forward: one row per thread, every block loops over all sources
//    (staged in shared memory), so there is no cross-block reduction.
//
// Rounding hazards handled here (as in predict_kb.cu): the error-free
// chains are written with __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never
// contracts into FMAs; rintf rounds half to even like torch.round; no
// --use_fast_math. The rotation polynomial, the recurrence and the
// accumulation are left to the compiler, where an FMA only helps.

#include <cuda_runtime.h>

namespace {

constexpr int DIRECT = 0, EXACT = 1, RESIDUAL = 2;
constexpr int ADJ_CAP = 8;      // cg * C accumulators (adjoint)
constexpr int FWD_CAP = 4;      // cg * C accumulator pairs (forward)
constexpr int PIX_BLOCK = 128;  // adjoint: threads per block, one pixel each
constexpr int ROW_TILE = 32;    // adjoint: rows staged per pass
constexpr int ROW_BLOCK = 128;  // forward: threads per block, one row each
constexpr int SRC_TILE = 32;    // forward: sources staged per pass

__device__ __forceinline__ void split(float a, float& hi, float& lo) {
    const float c = __fmul_rn(a, 4097.0f);
    hi = __fsub_rn(c, __fsub_rn(c, a));
    lo = __fsub_rn(a, hi);
}

// error of p = a*b, from the Dekker halves of a and b
__device__ __forceinline__ float prod_err(float p, float ah, float al,
                                          float bh, float bl) {
    float e = __fsub_rn(__fmul_rn(ah, bh), p);
    e = __fadd_rn(e, __fmul_rn(ah, bl));
    e = __fadd_rn(e, __fmul_rn(al, bh));
    return __fadd_rn(e, __fmul_rn(al, bl));
}

__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
    s = __fadd_rn(a, b);
    const float v = __fsub_rn(s, a);
    e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

__device__ __forceinline__ void quick_two_sum(float a, float b, float& s, float& e) {
    s = __fadd_rn(a, b);
    e = __fsub_rn(b, __fsub_rn(s, a));
}

// Per source or pixel: l, m, n-1 (two-float) and their Dekker halves.
struct Dir {
    float l, lh, ll, m, mh, ml, nh, nhh, nhl, nl;
};

// Per row: u, v, w and their Dekker halves.
struct Row {
    float u, uh, ul, v, vh, vl, w, wh, wl;
};

__device__ __forceinline__ Dir make_dir(float l, float m, float nh, float nl) {
    Dir d;
    d.l = l; d.m = m; d.nh = nh; d.nl = nl;
    split(l, d.lh, d.ll);
    split(m, d.mh, d.ml);
    split(nh, d.nhh, d.nhl);
    return d;
}

__device__ __forceinline__ Row make_row(const float* uvw, int r) {
    Row w;
    w.u = uvw[3 * (size_t)r];
    w.v = uvw[3 * (size_t)r + 1];
    w.w = uvw[3 * (size_t)r + 2];
    split(w.u, w.uh, w.ul);
    split(w.v, w.vh, w.vl);
    split(w.w, w.wh, w.wl);
    return w;
}

// phase_dot_cycles for one (direction, row):
//   df_mul(df_add(df_add(l*u, m*v), (n-1)*(w, 0)), (chi, clo))
__device__ __forceinline__ void delay(const Dir& d, const Row& q, float chi,
                                      float chh, float chl, float clo,
                                      float& hi, float& lo) {
    const float p1 = __fmul_rn(d.l, q.u);
    const float e1 = prod_err(p1, d.lh, d.ll, q.uh, q.ul);
    const float p2 = __fmul_rn(d.m, q.v);
    const float e2 = prod_err(p2, d.mh, d.ml, q.vh, q.vl);
    float s, e, ah, al;
    two_sum(p1, p2, s, e);
    quick_two_sum(s, __fadd_rn(__fadd_rn(e, e1), e2), ah, al);

    const float p3 = __fmul_rn(d.nh, q.w);
    const float e3 = prod_err(p3, d.nhh, d.nhl, q.wh, q.wl);
    const float x3 = __fadd_rn(__fmul_rn(d.nh, 0.0f), __fmul_rn(d.nl, q.w));
    float bh, bl;
    quick_two_sum(p3, __fadd_rn(e3, x3), bh, bl);

    float mh_, ml_;
    two_sum(ah, bh, s, e);
    quick_two_sum(s, __fadd_rn(__fadd_rn(e, al), bl), mh_, ml_);

    float xh, xl;
    split(mh_, xh, xl);
    const float p = __fmul_rn(mh_, chi);
    const float ep = prod_err(p, xh, xl, chh, chl);
    const float x = __fadd_rn(__fmul_rn(mh_, clo), __fmul_rn(ml_, chi));
    quick_two_sum(p, __fadd_rn(ep, x), hi, lo);
}

// cos/sin of 2*pi*frac((dot + dlo) * (f + flo)); (dhh, dhl) split dot,
// (fhh, fhl) split f.
__device__ __forceinline__ void phasor(float dot, float dlo, float dhh,
                                       float dhl, float f, float fhh,
                                       float fhl, float flo, bool use_flo,
                                       float& cs, float& sn) {
    const float p = __fmul_rn(dot, f);
    float e = prod_err(p, dhh, dhl, fhh, fhl);
    e = __fadd_rn(e, __fmul_rn(dlo, f));
    if (use_flo) e = __fadd_rn(e, __fmul_rn(dot, flo));
    // p - rint(p) is exact (Sterbenz); frac in [-0.5, 0.5] (+ tiny)
    const float frac = __fadd_rn(__fsub_rn(p, rintf(p)), e);
    sincospif(2.0f * frac, &sn, &cs);  // 2*frac is exact
}

// rotate (kre, kim) by x = d2p*dot radians, |x| <= 0.35 (host-checked)
__device__ __forceinline__ void rotate(float& kre, float& kim, float dot, float d2p) {
    const float x = d2p * dot;
    const float x2 = x * x;
    const float c = 1.0f - x2 * (0.5f - x2 * ((1.0f / 24.0f) - x2 * (1.0f / 720.0f)));
    const float s = x * (1.0f - x2 * ((1.0f / 6.0f) - x2 * (1.0f / 120.0f)));
    const float re = kre * c - kim * s;
    kim = kim * c + kre * s;
    kre = re;
}

// A group's frequency tables in registers: fsm rows [f, hh, hl, lo] (or
// [2*pi*delta_f, 0, 0, 0] in RESIDUAL mode) and usm [base, step] columns.
template <int CGMAX>
struct Group {
    float ft[4][CGMAX];
    float ut[4][2];

    __device__ __forceinline__ void load(const float* fsm, const float* usm,
                                         int g, int cg) {
        const float* fs = fsm + (size_t)g * 4 * cg;
        const float* us = usm + (size_t)g * 8;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
            for (int f = 0; f < CGMAX; ++f) ft[k][f] = f < cg ? fs[k * cg + f] : 0.0f;
            ut[k][0] = us[2 * k];
            ut[k][1] = us[2 * k + 1];
        }
    }
};

// Calls body(f, kre, kim) for each channel f < cg of the group, for the
// pair with delay (dot, dlo).
template <int MODE, int CGMAX, typename Body>
__device__ __forceinline__ void for_channels(const Group<CGMAX>& grp, int cg,
                                             bool use_flo, float dot, float dlo,
                                             Body body) {
    float dhh, dhl;
    split(dot, dhh, dhl);
    if (MODE == DIRECT) {
#pragma unroll
        for (int f = 0; f < CGMAX; ++f) {
            if (f < cg) {
                float cs, sn;
                phasor(dot, dlo, dhh, dhl, grp.ft[0][f], grp.ft[1][f],
                       grp.ft[2][f], grp.ft[3][f], use_flo, cs, sn);
                body(f, cs, sn);
            }
        }
    } else {
        float bre, bim, sre, sim;
        phasor(dot, dlo, dhh, dhl, grp.ut[0][0], grp.ut[1][0], grp.ut[2][0],
               grp.ut[3][0], use_flo, bre, bim);
        phasor(dot, dlo, dhh, dhl, grp.ut[0][1], grp.ut[1][1], grp.ut[2][1],
               grp.ut[3][1], use_flo, sre, sim);
#pragma unroll
        for (int f = 0; f < CGMAX; ++f) {
            if (f < cg) {
                float kre = bre, kim = bim;
                if (MODE == RESIDUAL) rotate(kre, kim, dot, grp.ft[0][f]);
                body(f, kre, kim);
                const float nre = bre * sre - bim * sim;
                bim = bre * sim + bim * sre;
                bre = nre;
            }
        }
    }
}

// ---------------------------------------------------------------- adjoint

template <int C, int MODE>
__global__ void __launch_bounds__(PIX_BLOCK)
dft_adjoint_kernel(const float* __restrict__ l, const float* __restrict__ m,
                   const float* __restrict__ n1h, const float* __restrict__ n1l,
                   const float* __restrict__ uvw, const float2* __restrict__ vis,
                   const float* __restrict__ fsm, const float* __restrict__ usm,
                   int cg, int use_flo, float chi, float clo,
                   float* __restrict__ partial, int P, int R, int F,
                   int rows_per_chunk) {
    constexpr int CGMAX = ADJ_CAP / C;
    __shared__ Row s_row[ROW_TILE];
    __shared__ float2 s_vis[ROW_TILE][CGMAX * C];

    const int p = blockIdx.x * PIX_BLOCK + threadIdx.x;
    const int g = blockIdx.y;
    const int chunk = blockIdx.z;
    const int r_begin = chunk * rows_per_chunk;
    const int r_end = min(R, r_begin + rows_per_chunk);
    const bool active = p < P;
    const int ncg = cg * C;

    const Dir d = active ? make_dir(l[p], m[p], n1h[p], n1l[p])
                         : make_dir(0.0f, 0.0f, 0.0f, 0.0f);
    float chh, chl;
    split(chi, chh, chl);
    Group<CGMAX> grp;
    grp.load(fsm, usm, g, cg);

    float acc[CGMAX][C];
#pragma unroll
    for (int f = 0; f < CGMAX; ++f)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[f][c] = 0.0f;

    for (int r0 = r_begin; r0 < r_end; r0 += ROW_TILE) {
        const int nr = min(ROW_TILE, r_end - r0);
        __syncthreads();  // the previous tile has been consumed
        if (threadIdx.x < nr) s_row[threadIdx.x] = make_row(uvw, r0 + threadIdx.x);
        for (int i = threadIdx.x; i < nr * ncg; i += PIX_BLOCK) {
            const int lr = i / ncg, k = i % ncg;
            s_vis[lr][k] = vis[((size_t)(r0 + lr) * F + (size_t)g * cg) * C + k];
        }
        __syncthreads();
        if (!active) continue;

        for (int lr = 0; lr < nr; ++lr) {
            float dot, dlo;
            delay(d, s_row[lr], chi, chh, chl, clo, dot, dlo);
            for_channels<MODE>(grp, cg, use_flo != 0, dot, dlo,
                               [&](int f, float kre, float kim) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float2 v = s_vis[lr][f * C + c];
                    acc[f][c] += kre * v.x - kim * v.y;
                }
            });
        }
    }

    if (!active) return;
    // partial: (chunk, F, C, P), pixels fastest
#pragma unroll
    for (int f = 0; f < CGMAX; ++f) {
        if (f >= cg) break;
#pragma unroll
        for (int c = 0; c < C; ++c)
            partial[(((size_t)chunk * F + (size_t)g * cg + f) * C + c) * P + p] = acc[f][c];
    }
}

// out[p, k] = sum over chunks, in chunk order, of partial[chunk, k, p]
// (k = f*C + c): deterministic.
__global__ void dft_adjoint_sum(const float* __restrict__ partial,
                                float* __restrict__ out, int P, int FC,
                                int nchunks) {
    const size_t n = (size_t)FC * P;
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.0f;
    for (int k = 0; k < nchunks; ++k) s += partial[(size_t)k * n + i];
    const size_t fc = i / P, p = i % P;
    out[p * FC + fc] = s;
}

template <int C, int MODE>
void adjoint(const float* l, const float* m, const float* n1h, const float* n1l,
             const float* uvw, const float2* vis, const float* fsm,
             const float* usm, int cg, int ngroups, int use_flo, float chi,
             float clo, float* partial, int P, int R, int F,
             int rows_per_chunk, int nchunks, cudaStream_t stream) {
    const dim3 grid((P + PIX_BLOCK - 1) / PIX_BLOCK, ngroups, nchunks);
    dft_adjoint_kernel<C, MODE><<<grid, PIX_BLOCK, 0, stream>>>(
        l, m, n1h, n1l, uvw, vis, fsm, usm, cg, use_flo, chi, clo, partial,
        P, R, F, rows_per_chunk);
}

template <int C>
void adjoint_mode(int mode, const float* l, const float* m, const float* n1h,
                  const float* n1l, const float* uvw, const float2* vis,
                  const float* fsm, const float* usm, int cg, int ngroups,
                  int use_flo, float chi, float clo, float* partial, int P,
                  int R, int F, int rows_per_chunk, int nchunks,
                  cudaStream_t stream) {
#define ADJ(M) adjoint<C, M>(l, m, n1h, n1l, uvw, vis, fsm, usm, cg, ngroups, \
                             use_flo, chi, clo, partial, P, R, F,             \
                             rows_per_chunk, nchunks, stream)
    if (mode == DIRECT) ADJ(DIRECT);
    else if (mode == EXACT) ADJ(EXACT);
    else ADJ(RESIDUAL);
#undef ADJ
}

// ---------------------------------------------------------------- forward

template <int C, int MODE, bool IMAG>
__global__ void __launch_bounds__(ROW_BLOCK)
dft_forward_kernel(const float* __restrict__ l, const float* __restrict__ m,
                   const float* __restrict__ n1h, const float* __restrict__ n1l,
                   const float* __restrict__ uvw, const float* __restrict__ image,
                   const float* __restrict__ fsm, const float* __restrict__ usm,
                   int cg, int use_flo, float chi, float clo,
                   float2* __restrict__ out, int S, int R, int F) {
    constexpr int CGMAX = FWD_CAP / C;
    __shared__ Dir s_dir[SRC_TILE];
    __shared__ float2 s_img[SRC_TILE][CGMAX * C];

    const int r = blockIdx.x * ROW_BLOCK + threadIdx.x;
    const int g = blockIdx.y;
    const bool active = r < R;
    const int ncg = cg * C;

    float chh, chl;
    split(chi, chh, chl);
    Row q;
    if (active) {
        q = make_row(uvw, r);
    } else {
        q.u = q.uh = q.ul = q.v = q.vh = q.vl = q.w = q.wh = q.wl = 0.0f;
    }
    Group<CGMAX> grp;
    grp.load(fsm, usm, g, cg);

    float acc_re[CGMAX][C], acc_im[CGMAX][C];
#pragma unroll
    for (int f = 0; f < CGMAX; ++f)
#pragma unroll
        for (int c = 0; c < C; ++c) acc_re[f][c] = acc_im[f][c] = 0.0f;

    for (int s0 = 0; s0 < S; s0 += SRC_TILE) {
        const int ns = min(SRC_TILE, S - s0);
        __syncthreads();  // the previous tile has been consumed
        if (threadIdx.x < ns) {
            const int s = s0 + threadIdx.x;
            s_dir[threadIdx.x] = make_dir(l[s], m[s], n1h[s], n1l[s]);
        }
        for (int i = threadIdx.x; i < ns * ncg; i += ROW_BLOCK) {
            const int ls = i / ncg, k = i % ncg;
            const size_t at = ((size_t)(s0 + ls) * F + (size_t)g * cg) * C + k;
            s_img[ls][k] = IMAG ? reinterpret_cast<const float2*>(image)[at]
                                : make_float2(image[at], 0.0f);
        }
        __syncthreads();
        if (!active) continue;

        for (int ls = 0; ls < ns; ++ls) {
            float dot, dlo;
            delay(s_dir[ls], q, chi, chh, chl, clo, dot, dlo);
            for_channels<MODE>(grp, cg, use_flo != 0, dot, dlo,
                               [&](int f, float kre, float kim) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float2 v = s_img[ls][f * C + c];
                    if (IMAG) {
                        acc_re[f][c] += kre * v.x - kim * v.y;
                        acc_im[f][c] += kim * v.x + kre * v.y;
                    } else {
                        acc_re[f][c] += kre * v.x;
                        acc_im[f][c] += kim * v.x;
                    }
                }
            });
        }
    }

    if (!active) return;
#pragma unroll
    for (int f = 0; f < CGMAX; ++f) {
        if (f >= cg) break;
        float2* op = out + ((size_t)r * F + (size_t)g * cg + f) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) op[c] = make_float2(acc_re[f][c], acc_im[f][c]);
    }
}

template <int C, int MODE>
void forward(bool imag, const float* l, const float* m, const float* n1h,
             const float* n1l, const float* uvw, const float* image,
             const float* fsm, const float* usm, int cg, int ngroups,
             int use_flo, float chi, float clo, float2* out, int S, int R,
             int F, cudaStream_t stream) {
    const dim3 grid((R + ROW_BLOCK - 1) / ROW_BLOCK, ngroups);
    if (imag)
        dft_forward_kernel<C, MODE, true><<<grid, ROW_BLOCK, 0, stream>>>(
            l, m, n1h, n1l, uvw, image, fsm, usm, cg, use_flo, chi, clo, out, S, R, F);
    else
        dft_forward_kernel<C, MODE, false><<<grid, ROW_BLOCK, 0, stream>>>(
            l, m, n1h, n1l, uvw, image, fsm, usm, cg, use_flo, chi, clo, out, S, R, F);
}

template <int C>
void forward_mode(int mode, bool imag, const float* l, const float* m,
                  const float* n1h, const float* n1l, const float* uvw,
                  const float* image, const float* fsm, const float* usm,
                  int cg, int ngroups, int use_flo, float chi, float clo,
                  float2* out, int S, int R, int F, cudaStream_t stream) {
#define FWD(M) forward<C, M>(imag, l, m, n1h, n1l, uvw, image, fsm, usm, cg, \
                             ngroups, use_flo, chi, clo, out, S, R, F, stream)
    if (mode == DIRECT) FWD(DIRECT);
    else if (mode == EXACT) FWD(EXACT);
    else FWD(RESIDUAL);
#undef FWD
}

}  // namespace

// l, m, n1h, n1l: (P,) float32 pixel directions, n-1 as a two-float pair.
// uvw: (R, 3) float32. vis: (R, F, C) complex64, flag-masked. fsm
// (ngroups, 4, cg) and usm (ngroups, 4, 2) float32: the host's channel-group
// tables; mode 0 direct, 1 exact, 2 residual. (chi, clo): sign/c as a
// two-float pair. partial: (nchunks, F, C, P) float32 scratch; out: (P, F, C)
// float32. Launches both passes on `stream`; returns cudaGetLastError().
extern "C" int dft_adjoint_launch(const float* l, const float* m,
                                  const float* n1h, const float* n1l,
                                  const float* uvw, const void* vis,
                                  const float* fsm, const float* usm, int cg,
                                  int ngroups, int mode, int use_flo,
                                  float chi, float clo, float* partial,
                                  float* out, int P, int R, int F, int C,
                                  int rows_per_chunk, int nchunks,
                                  void* stream) {
    if (P <= 0 || R <= 0 || F <= 0) return (int)cudaSuccess;
    if (mode < DIRECT || mode > RESIDUAL || cg * C > ADJ_CAP || cg * ngroups != F)
        return (int)cudaErrorInvalidValue;
    const float2* v = static_cast<const float2*>(vis);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: adjoint_mode<1>(mode, l, m, n1h, n1l, uvw, v, fsm, usm, cg, ngroups, use_flo, chi, clo, partial, P, R, F, rows_per_chunk, nchunks, st); break;
        case 2: adjoint_mode<2>(mode, l, m, n1h, n1l, uvw, v, fsm, usm, cg, ngroups, use_flo, chi, clo, partial, P, R, F, rows_per_chunk, nchunks, st); break;
        case 4: adjoint_mode<4>(mode, l, m, n1h, n1l, uvw, v, fsm, usm, cg, ngroups, use_flo, chi, clo, partial, P, R, F, rows_per_chunk, nchunks, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    const int err = (int)cudaGetLastError();
    if (err != (int)cudaSuccess) return err;
    const size_t n = (size_t)F * C * P;
    const int threads = 256;
    dft_adjoint_sum<<<(unsigned)((n + threads - 1) / threads), threads, 0, st>>>(
        partial, out, P, F * C, nchunks);
    return (int)cudaGetLastError();
}

// l, m, n1h, n1l: (S,) float32 source directions; uvw: (R, 3) float32.
// image: (S, F, C) complex64 when imag != 0, else (S, F, C) float32 (a
// real sky: the imaginary half of the product is skipped). Tables and
// (chi, clo) as for the adjoint. out: (R, F, C) complex64.
extern "C" int dft_forward_launch(const float* l, const float* m,
                                  const float* n1h, const float* n1l,
                                  const float* uvw, const void* image, int imag,
                                  const float* fsm, const float* usm, int cg,
                                  int ngroups, int mode, int use_flo,
                                  float chi, float clo, void* out, int S,
                                  int R, int F, int C, void* stream) {
    if (R <= 0 || F <= 0) return (int)cudaSuccess;
    if (mode < DIRECT || mode > RESIDUAL || cg * C > FWD_CAP || cg * ngroups != F)
        return (int)cudaErrorInvalidValue;
    const float* im = static_cast<const float*>(image);
    float2* o = static_cast<float2*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: forward_mode<1>(mode, imag != 0, l, m, n1h, n1l, uvw, im, fsm, usm, cg, ngroups, use_flo, chi, clo, o, S, R, F, st); break;
        case 2: forward_mode<2>(mode, imag != 0, l, m, n1h, n1l, uvw, im, fsm, usm, cg, ngroups, use_flo, chi, clo, o, S, R, F, st); break;
        case 4: forward_mode<4>(mode, imag != 0, l, m, n1h, n1l, uvw, im, fsm, usm, cg, ngroups, use_flo, chi, clo, o, S, R, F, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
