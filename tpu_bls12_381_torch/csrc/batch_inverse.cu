// Montgomery's batch inversion in three kernels, for Fr and Fq: the
// elementwise Montgomery inverse of x (K, n), inv(0) = 0, with one field
// inversion in all.
//
// They take the place of the JAX package's fields/pallas_ops.py kernels
// _build_mul_kernel and _build_sqr_kernel as vecops.batch_inverse runs them:
// there, and in the port before this source, the three phases are a chain
// of elementwise product launches (R products down the rows of an (R, 4096)
// tile, 2 x 12 log-depth lane scans, a Fermat ladder of some 570 products
// and squares on one lane, 2R products back up), thousands of launches on
// 4,096 lanes or on one.  Here each phase is one launch that keeps its chain
// in registers (batch_inverse.cuh has the lane bodies):
//  phase 1  (grid over L columns) the prefix products down each column;
//  phase 2  (one block) the L column products inverted: strided runs folded
//           by the threads, the run products scanned from both ends in
//           shared memory, one Fermat inverse of the total, the runs walked
//           back;
//  phase 3  (grid over L columns) the inverses, back up each column.
//
// What bounds them on an H100: three products an element (300 wide
// multiply-adds each for Fq, 136 for Fr) against 2 * K limbs the function
// must move (x read, the inverses written; this design moves 5 * K: x read
// twice, the prefixes written and read back); at 2^20 Fq elements the
// operations take about 0.11 ms.  Phase 2 is bound by its
// depth instead: 3 L / SCAN_THREADS dependent products a thread, log2 of
// SCAN_THREADS scan steps and the Fermat ladder's some 490 dependent
// products on one thread.  The tile (R, L) trades phase 1 and 3's depth R
// against phase 2's runs (tuning.py: CUDA_BATCH_INVERSE_LANES_LOG).
//
// Plain C interface for ctypes: device pointers to int32 limb planes,
// `stream` a cudaStream_t, the return value cudaGetLastError() after the
// launches (the first launch that fails stops the rest).

#include <cuda_runtime.h>

#include "batch_inverse.cuh"

#define THREADS 128
// Phase 2's block: the run products of both scans in shared memory, 2 * 12
// words a thread for Fq (24 KB at 256).
#define SCAN_THREADS 256

template <class F>
__global__ void __launch_bounds__(THREADS)
binv_prefix_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ pre,
                   uint32_t* __restrict__ col, size_t n, size_t L, int R) {
    size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    binv_prefix_lane<F>(x, pre, col, n, L, R, l);
}

template <class F>
__device__ __forceinline__ void sh_put(uint32_t* sh, unsigned t, const El<F>& v) {
    for (int w = 0; w < F::W; ++w) sh[w * SCAN_THREADS + t] = v.v[w];
}

template <class F>
__device__ __forceinline__ El<F> sh_get(const uint32_t* sh, unsigned t) {
    El<F> v;
    for (int w = 0; w < F::W; ++w) v.v[w] = sh[w * SCAN_THREADS + t];
    return v;
}

// One block of SCAN_THREADS: 1 / col[l] for the L columns into colinv.  The
// Hillis-Steele steps take both operands from shared memory, prefix and
// suffix side by side (two independent products a step).
template <class F>
__global__ void __launch_bounds__(SCAN_THREADS, 1)
binv_columns_kernel(const uint32_t* __restrict__ col, uint32_t* __restrict__ colinv,
                    size_t L) {
    __shared__ uint32_t pre[F::W * SCAN_THREADS];
    __shared__ uint32_t suf[F::W * SCAN_THREADS];
    __shared__ uint32_t total_inv[F::W];
    const unsigned t = threadIdx.x, T = SCAN_THREADS;
    El<F> v = binv_fold_run<F>(col, colinv, L, T, t);
    sh_put<F>(pre, t, v);
    sh_put<F>(suf, t, v);
    __syncthreads();
    ROLLED
    for (unsigned s = 1; s < T; s <<= 1) {
        El<F> a, b;
        if (t >= s) a = fp_mul_cc<F>(sh_get<F>(pre, t - s), sh_get<F>(pre, t));
        if (t + s < T) b = fp_mul_cc<F>(sh_get<F>(suf, t), sh_get<F>(suf, t + s));
        __syncthreads();
        if (t >= s) sh_put<F>(pre, t, a);
        if (t + s < T) sh_put<F>(suf, t, b);
        __syncthreads();
    }
    if (t == 0) {
        El<F> g = fp_inv_fermat<F>(sh_get<F>(pre, T - 1));
        for (int w = 0; w < F::W; ++w) total_inv[w] = g.v[w];
    }
    __syncthreads();
    El<F> iv;
    for (int w = 0; w < F::W; ++w) iv.v[w] = total_inv[w];
    // 1 / (run t's product) = 1/total * (the runs before t) * (the runs after)
    if (t > 0) iv = fp_mul_cc<F>(iv, sh_get<F>(pre, t - 1));
    if (t + 1 < T) iv = fp_mul_cc<F>(iv, sh_get<F>(suf, t + 1));
    binv_walk_run<F>(iv, col, colinv, L, T, t);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
binv_unwind_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ pre,
                   const uint32_t* __restrict__ colinv, uint32_t* __restrict__ out,
                   size_t n, size_t L, int R) {
    size_t l = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= L) return;
    binv_unwind_lane<F>(x, pre, colinv, out, n, L, R, l);
}

// x, out (K, n); scratch pre (K, (R-1)*L), col and colinv (K, L); R * L >= n.
template <class F>
static int launch_batch_inverse(const void* x, void* out, void* pre, void* col,
                                void* colinv, long long n, long long L, int R,
                                void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    if (L < 1 || R < 1 || (long long)R * L < n || L > (1LL << 31))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    unsigned blocks = (unsigned)((L + THREADS - 1) / THREADS);
    binv_prefix_kernel<F><<<blocks, THREADS, 0, st>>>(
        (const uint32_t*)x, (uint32_t*)pre, (uint32_t*)col, (size_t)n, (size_t)L, R);
    int err = (int)cudaGetLastError();
    if (err) return err;
    binv_columns_kernel<F><<<1, SCAN_THREADS, 0, st>>>(
        (const uint32_t*)col, (uint32_t*)colinv, (size_t)L);
    err = (int)cudaGetLastError();
    if (err) return err;
    binv_unwind_kernel<F><<<blocks, THREADS, 0, st>>>(
        (const uint32_t*)x, (const uint32_t*)pre, (const uint32_t*)colinv,
        (uint32_t*)out, (size_t)n, (size_t)L, R);
    return (int)cudaGetLastError();
}

extern "C" {

int fr_batch_inverse(const void* x, void* out, void* pre, void* col, void* colinv,
                     long long n, long long L, int R, void* stream) {
    return launch_batch_inverse<Fr>(x, out, pre, col, colinv, n, L, R, stream);
}

int fq_batch_inverse(const void* x, void* out, void* pre, void* col, void* colinv,
                     long long n, long long L, int R, void* stream) {
    return launch_batch_inverse<Fq>(x, out, pre, col, colinv, n, L, R, stream);
}

}  // extern "C"
