// Fused K x envelope x B source contraction of the RIME predict, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes.
//
//   V[r,f,c] = sum_s exp(i*phase(s,r,f)) * env(s,r,f) * B[s,f,c]
//
//   compensated: phase = 2*pi*frac((hi+lo)[s,r] * nu[f])  (two-float delay
//                in seconds, reduced mod one cycle at ~48-bit precision)
//   plain:       phase = dot[s,r] * nu[f]                 (radians)
//   envelope:    env   = exp(-((u1[s,r]*sf[f])^2 + (v1[s,r]*sf[f])^2)),
//                or 1 for point sources (u1 = v1 = NULL)
//
// Replaces both Pallas TPU kernels of africanus_tpu/ops/pallas_predict.py,
// which compute this same map on different TPU units:
//   predict_kb_pallas_srclane / _predict_srclane_kernel (sources on lanes,
//     MXU dot), and
//   predict_kb_pallas / _predict_kernel (row x chan tiles, VPU multiply-sum).
// It computes their map, not their schedule: no lane padding, no
// divisibility rules; any S, R and F, ragged edges masked here.
//
// What bounds it on an H100: FP32 instruction throughput. Every (s, r, f)
// term costs ~12 rounded f32 ops of two-float phase, a sincospi and an exp
// (both polynomial on the FP32 pipe, not the SFU approximations), and 4*C
// FMAs;
// at the MeerKAT-64 full-band chunk that is 3.3e9 terms against ~1 GB of
// output, so bytes are negligible (~0.3 ms of HBM time).
// What the design does about it: threads run along channels and each
// thread keeps ROWS rows x C correlations of accumulators in registers,
// so every per-source load of B[s,f,:] (coalesced across the warp) and
// every per-channel split of nu is reused ROWS times; the per-(source,row)
// scalars (the delay, its Dekker split, u1, v1) are computed once per
// block and staged in shared memory, where every thread reads them as a
// broadcast. Each block loops over ALL sources, so there is no cross-block
// reduction, no atomics, and the sum order is fixed (deterministic).
//
// Rounding hazards handled here:
//  - nvcc contracts a*b+c into an FMA by default (-fmad=true), which
//    silently turns Dekker's error-free two_prod into plain f32. The
//    two-float chain is written with __fmul_rn/__fadd_rn/__fsub_rn, which
//    are never contracted. (Only the envelope and the accumulation, where
//    an FMA only helps, are left to the compiler.)
//  - round-half-to-even as jnp.round / torch.round: rintf, not roundf.
//  - accurate transcendentals: sincospif/sincosf and expf (never built
//    with --use_fast_math, which would also flush denormals to zero).

#include <cuda_runtime.h>

namespace {

constexpr int CHAN_BLOCK = 128;  // threads per block, one channel each
constexpr int ROWS = 8;          // rows per block, accumulated in registers
constexpr int SRC_TILE = 32;     // sources staged in shared memory per pass

__device__ __forceinline__ void dekker_split(float a, float& hi, float& lo) {
    const float c = __fmul_rn(a, 4097.0f);
    hi = __fsub_rn(c, __fsub_rn(c, a));
    lo = __fsub_rn(a, hi);
}

template <int C, bool COMP, bool ENV>
__global__ void __launch_bounds__(CHAN_BLOCK)
predict_kb_kernel(const float* __restrict__ hi, const float* __restrict__ lo,
                  const float* __restrict__ u1, const float* __restrict__ v1,
                  const float* __restrict__ freq, const float* __restrict__ sf,
                  const float2* __restrict__ b, float2* __restrict__ out,
                  int S, int R, int F) {
    // per (source, row): {delay hi, split hi, split lo, delay lo}
    __shared__ float4 s_dly[SRC_TILE][ROWS];
    // per (source, row): {u1, v1}
    __shared__ float2 s_uv[SRC_TILE][ROWS];

    const int r0 = blockIdx.x * ROWS;
    const int f = blockIdx.y * CHAN_BLOCK + threadIdx.x;
    const bool active = f < F;

    const float nu = active ? freq[f] : 0.0f;
    const float snu = (ENV && active) ? sf[f] : 0.0f;
    float fh, fl;
    dekker_split(nu, fh, fl);

    float acc_re[ROWS][C];
    float acc_im[ROWS][C];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            acc_re[i][c] = 0.0f;
            acc_im[i][c] = 0.0f;
        }
    }

    for (int s0 = 0; s0 < S; s0 += SRC_TILE) {
        const int ns = min(SRC_TILE, S - s0);
        __syncthreads();  // the previous tile has been consumed
        for (int i = threadIdx.x; i < SRC_TILE * ROWS; i += CHAN_BLOCK) {
            const int ls = i / ROWS, lr = i % ROWS;
            const int r = r0 + lr;
            float h = 0.0f, l = 0.0f, u = 0.0f, v = 0.0f;
            if (ls < ns && r < R) {
                const size_t k = (size_t)(s0 + ls) * R + r;
                h = hi[k];
                if (COMP) l = lo[k];
                if (ENV) {
                    u = u1[k];
                    v = v1[k];
                }
            }
            float hh, hl;
            dekker_split(h, hh, hl);
            s_dly[ls][lr] = make_float4(h, hh, hl, l);
            s_uv[ls][lr] = make_float2(u, v);
        }
        __syncthreads();
        if (!active) continue;

        for (int ls = 0; ls < ns; ++ls) {
            const float2* bp = b + ((size_t)(s0 + ls) * F + f) * C;
            float2 bv[C];
#pragma unroll
            for (int c = 0; c < C; ++c) bv[c] = bp[c];

#pragma unroll
            for (int lr = 0; lr < ROWS; ++lr) {
                const float4 d = s_dly[ls][lr];
                float sn, cs;
                if (COMP) {
                    // two_prod(hi, nu) with hoisted splits, plus lo*nu
                    const float p = __fmul_rn(d.x, nu);
                    float e = __fsub_rn(__fmul_rn(d.y, fh), p);
                    e = __fadd_rn(e, __fmul_rn(d.y, fl));
                    e = __fadd_rn(e, __fmul_rn(d.z, fh));
                    e = __fadd_rn(e, __fmul_rn(d.z, fl));
                    e = __fadd_rn(e, __fmul_rn(d.w, nu));
                    // p - rint(p) is exact (Sterbenz); frac in [-0.5, 0.5]
                    const float frac = __fadd_rn(__fsub_rn(p, rintf(p)), e);
                    // sin/cos(2*pi*frac); 2*frac is exact
                    sincospif(2.0f * frac, &sn, &cs);
                } else {
                    sincosf(__fmul_rn(d.x, nu), &sn, &cs);
                }
                if (ENV) {
                    const float2 uv = s_uv[ls][lr];
                    const float fu = uv.x * snu;
                    const float fv = uv.y * snu;
                    const float env = expf(-(fu * fu + fv * fv));
                    sn *= env;
                    cs *= env;
                }
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    acc_re[lr][c] += cs * bv[c].x - sn * bv[c].y;
                    acc_im[lr][c] += cs * bv[c].y + sn * bv[c].x;
                }
            }
        }
    }

    if (!active) return;
#pragma unroll
    for (int lr = 0; lr < ROWS; ++lr) {
        const int r = r0 + lr;
        if (r >= R) break;
        float2* op = out + ((size_t)r * F + f) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) op[c] = make_float2(acc_re[lr][c], acc_im[lr][c]);
    }
}

template <int C, bool COMP, bool ENV>
void launch(const float* hi, const float* lo, const float* u1, const float* v1,
            const float* freq, const float* sf, const float2* b, float2* out,
            int S, int R, int F, cudaStream_t stream) {
    const dim3 grid((R + ROWS - 1) / ROWS, (F + CHAN_BLOCK - 1) / CHAN_BLOCK);
    predict_kb_kernel<C, COMP, ENV><<<grid, CHAN_BLOCK, 0, stream>>>(
        hi, lo, u1, v1, freq, sf, b, out, S, R, F);
}

template <int C>
void dispatch(const float* hi, const float* lo, const float* u1, const float* v1,
              const float* freq, const float* sf, const float2* b, float2* out,
              int S, int R, int F, cudaStream_t stream) {
    const bool comp = lo != nullptr, env = u1 != nullptr;
    if (comp && env)
        launch<C, true, true>(hi, lo, u1, v1, freq, sf, b, out, S, R, F, stream);
    else if (comp)
        launch<C, true, false>(hi, lo, u1, v1, freq, sf, b, out, S, R, F, stream);
    else if (env)
        launch<C, false, true>(hi, lo, u1, v1, freq, sf, b, out, S, R, F, stream);
    else
        launch<C, false, false>(hi, lo, u1, v1, freq, sf, b, out, S, R, F, stream);
}

}  // namespace

// hi, lo, u1, v1: (S, R) float32; lo == NULL selects the plain phase
// (hi is then the phase per Hz, radians), u1 == v1 == NULL point sources.
// freq, sf: (F,) float32. b: (S, F, C) complex64, out: (R, F, C) complex64,
// both interleaved re/im. Launches on `stream`; returns cudaGetLastError().
extern "C" int predict_kb_launch(const float* hi, const float* lo,
                                 const float* u1, const float* v1,
                                 const float* freq, const float* sf,
                                 const void* b, void* out,
                                 int S, int R, int F, int C, void* stream) {
    if (R <= 0 || F <= 0) return (int)cudaSuccess;
    const float2* bb = static_cast<const float2*>(b);
    float2* oo = static_cast<float2*>(out);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: dispatch<1>(hi, lo, u1, v1, freq, sf, bb, oo, S, R, F, st); break;
        case 2: dispatch<2>(hi, lo, u1, v1, freq, sf, bb, oo, S, R, F, st); break;
        case 4: dispatch<4>(hi, lo, u1, v1, freq, sf, bb, oo, S, R, F, st); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
