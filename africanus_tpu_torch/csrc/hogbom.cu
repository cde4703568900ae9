// Hogbom CLEAN's iteration loop as one kernel.
//
// It replaces no TPU kernel: the JAX package runs CLEAN as a
// lax.while_loop (africanus_tpu/deconv/hogbom/clean.py), which XLA keeps
// on the device. The port's loop of ~20 small torch ops an iteration left
// the host issuing ~1,000 kernels for a 50-iteration CLEAN; this kernel
// runs every iteration on the device in one launch, with no round trip to
// the host.
//
// What bounds it: latency. Each iteration is a peak search over the whole
// residual followed by one PSF-window subtraction, and the next peak
// depends on it: niter + 1 dependent steps of a few microseconds of work.
// So the residual stays on chip and each iteration pays one barrier:
//
// - where the npix x npix residual fits one block's shared memory, one
//   block of 1,024 threads holds it;
// - beyond that, a thread-block cluster of up to 16 blocks, each holding
//   a band of rows in its shared memory (the wrapper's layout() chooses the
//   count from npix and the dtype alone);
// - beyond the cluster's shared memory, the same scheme with the residual
//   in device memory.
//
// A thread owns the same pixels in every iteration (band pixel e = tid +
// k * 1024), so the residual, the clean image and their initial copy and
// zero-fill need no barrier. Each iteration, every warp reduces its
// (value, flat index) best by shuffles and writes it into every block of
// the cluster (distributed shared memory), double-buffered; after one
// barrier (__syncthreads, or the cluster's) every warp reduces those slots
// the same way, so every thread of every block holds the same peak and
// takes the same exit. The PSF window is read from device memory, where L2
// holds it.
//
// The kernel equals the plain loop (deconv/hogbom/clean.py,
// hogbom_clean_reference) value for value:
// - the peak is torch.argmax's: signed, NaN above everything, ties to the
//   lowest flat index;
// - thresh = T(frac) * |peak0|; a step is taken while |peak| > thresh;
// - step = T(gamma) * peak, rounded once; clean[p] = clean[p] + step;
// - residual = r - (step * w), a rounded product then a rounded difference
//   (__fmul_rn / __fsub_rn: nvcc would otherwise contract them into an FMA);
// - the loop stops once a step is not taken: a masked iteration of the
//   plain loop subtracts zero, which changes at most the sign of a zero.
// flags[k] is the plain loop's running flag of iteration k.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CTAS = 16;          // the largest (non-portable) cluster
constexpr int SMEM_LIMIT = 232448;    // shared memory a block may hold

__device__ __forceinline__ float lowest(float) { return __int_as_float((int)0xff800000); }
__device__ __forceinline__ double lowest(double) {
    return __longlong_as_double((long long)0xfff0000000000000ULL);
}
__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// (a, ai) comes before (b, bi) in torch.argmax's order
template <typename T>
__device__ __forceinline__ bool better(T a, int ai, T b, int bi) {
    const bool an = a != a, bn = b != b;
    if (an || bn) return an && (!bn || ai < bi);
    return a > b || (a == b && ai < bi);
}

template <typename T>
__device__ __forceinline__ void warp_best(T& v, int& i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const T ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
}

// The best (value, flat index) of every thread of the cluster, in every
// thread. slot_v / slot_i: [2][nctas * WARPS], used by parity.
template <typename T>
__device__ __forceinline__ void cluster_best(T& v, int& i, T* slot_v, int* slot_i,
                                             int parity, int nctas, int rank) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nslots = nctas * WARPS;
    T* sv = slot_v + parity * nslots;
    int* si = slot_i + parity * nslots;
    warp_best(v, i);
    if (nctas == 1) {
        if (lane == 0) { sv[warp] = v; si[warp] = i; }
        __syncthreads();
    } else {
        cg::cluster_group cluster = cg::this_cluster();
        if (lane < nctas) {  // lane r writes this warp's best into block r
            cluster.map_shared_rank(sv, lane)[rank * WARPS + warp] = v;
            cluster.map_shared_rank(si, lane)[rank * WARPS + warp] = i;
        }
        cluster.sync();
    }
    v = lowest(T());
    i = INT_MAX;
    for (int s = lane; s < nslots; s += 32)
        if (better(sv[s], si[s], v, i)) { v = sv[s]; i = si[s]; }
    warp_best(v, i);
}

// One cluster of gridDim.x blocks (or one block); block b holds rows
// [b * band_rows, min((b + 1) * band_rows, npix)) of the residual, in its
// shared memory where SMEM, else in `residual` itself.
template <typename T, bool SMEM>
__global__ void __launch_bounds__(THREADS, 1)
hogbom_kernel(const T* __restrict__ dirty, const T* __restrict__ psf,
              T* __restrict__ clean, T* __restrict__ residual,
              bool* __restrict__ flags, T gamma, T frac, int niter, int npix,
              int band_rows) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int nctas = gridDim.x, rank = blockIdx.x, tid = threadIdx.x;
    T* slot_v = reinterpret_cast<T*>(smem);
    int* slot_i = reinterpret_cast<int*>(slot_v + 2 * nctas * WARPS);
    const int row0 = rank * band_rows;
    const int rows = max(0, min(band_rows, npix - row0));
    const int first = row0 * npix, count = rows * npix;
    T* res = SMEM ? reinterpret_cast<T*>(slot_i + 2 * nctas * WARPS)
                  : residual + first;
    const long long pitch = 2LL * npix;

    if (nctas > 1) cg::this_cluster().sync();  // every block's shared memory is live

    T v = lowest(T());
    int p = INT_MAX;
    for (int e = tid; e < count; e += THREADS) {
        const T d = dirty[first + e];
        res[e] = d;
        clean[first + e] = T(0);
        if (better(d, first + e, v, p)) { v = d; p = first + e; }
    }
    int parity = 0;
    cluster_best(v, p, slot_v, slot_i, parity, nctas, rank);
    parity ^= 1;

    const T thresh = frac * absval(v);
    int taken = 0;
    for (int k = 0; k <= niter; ++k) {
        if (!(absval(v) > thresh)) break;
        ++taken;
        const T step = gamma * v;
        const int pr = p / npix, pc = p - pr * npix;
        // window pixel (i, j) is psf[npix - 1 - pr + i, npix - 1 - pc + j]
        const T* win = psf + (npix - 1 - pr) * pitch + (npix - 1 - pc);
        T nv = lowest(T());
        int np = INT_MAX;
        for (int e = tid; e < count; e += THREADS) {
            const int i = e / npix, j = e - i * npix;
            const T r = sub_rn(res[e], mul_rn(step, win[(row0 + i) * pitch + j]));
            res[e] = r;
            if (better(r, first + e, nv, np)) { nv = r; np = first + e; }
        }
        if (p >= first && p < first + count && (p - first) % THREADS == tid)
            clean[p] = clean[p] + step;  // this thread zero-filled it
        if (k == niter) break;
        v = nv;
        p = np;
        cluster_best(v, p, slot_v, slot_i, parity, nctas, rank);
        parity ^= 1;
    }

    if (rank == 0)
        for (int k = tid; k <= niter; k += THREADS) flags[k] = k < taken;
    if (SMEM)
        for (int e = tid; e < count; e += THREADS) residual[first + e] = res[e];
}

template <typename T, bool SMEM>
int allow() {
    auto* fn = hogbom_kernel<T, SMEM>;
    int err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        SMEM_LIMIT);
    return err ? err : (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <typename T, bool SMEM>
int launch(const void* dirty, const void* psf, void* clean, void* residual,
           bool* flags, double gamma, double frac, int niter, int npix, int ctas,
           int rows, size_t smem, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = ctas > 1 ? 1 : 0;
    return (int)cudaLaunchKernelEx(
        &cfg, hogbom_kernel<T, SMEM>, static_cast<const T*>(dirty),
        static_cast<const T*>(psf), static_cast<T*>(clean), static_cast<T*>(residual),
        flags, static_cast<T>(gamma), static_cast<T>(frac), niter, npix, rows);
}

}  // namespace

// Lets the kernels take up to SMEM_LIMIT bytes of dynamic shared memory and
// clusters of 16 blocks on the current device. Called once per device
// before the first launch, outside any CUDA-graph capture.
extern "C" int hogbom_init() {
    int err = allow<float, true>();
    err = err ? err : allow<float, false>();
    err = err ? err : allow<double, true>();
    return err ? err : allow<double, false>();
}

// dirty, clean, residual: (npix, npix) T; psf: (2 npix, 2 npix) T, its peak
// at (npix - 1, npix - 1); flags: (niter + 1,) bool, written where niter >= 0.
// ctas blocks of `rows` rows each (every block holds a row, the last one
// the rest), the residual in shared memory where in_smem, `smem` bytes of
// shared memory a block: the wrapper's layout(npix, sizeof(T)), checked
// here only against the card's limits.
extern "C" int hogbom_launch(const void* dirty, const void* psf, void* clean,
                             void* residual, void* flags, double gamma, double frac,
                             int niter, int npix, int ctas, int rows, int in_smem,
                             int smem, int is_double, void* stream) {
    if (npix < 1 || npix > 46340 || ctas < 1 || ctas > MAX_CTAS || rows < 1 ||
        (long long)rows * ctas < npix || (long long)rows * (ctas - 1) >= npix ||
        smem < 0 || smem > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    bool* f = static_cast<bool*>(flags);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_double)
        return in_smem ? launch<double, true>(dirty, psf, clean, residual, f, gamma, frac,
                                              niter, npix, ctas, rows, smem, st)
                       : launch<double, false>(dirty, psf, clean, residual, f, gamma, frac,
                                               niter, npix, ctas, rows, smem, st);
    return in_smem ? launch<float, true>(dirty, psf, clean, residual, f, gamma, frac,
                                         niter, npix, ctas, rows, smem, st)
                   : launch<float, false>(dirty, psf, clean, residual, f, gamma, frac,
                                          niter, npix, ctas, rows, smem, st);
}
