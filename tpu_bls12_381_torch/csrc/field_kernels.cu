// Elementwise Montgomery product and square over (K, N) limb planes.
//
// Takes the place of the JAX package's fields/pallas_ops.py kernels
// _build_mul_kernel (mont_mul) and _build_sqr_kernel (mont_sqr), for Fr
// (K = 16) and Fq (K = 24).  One thread owns one element; see field.cuh.
//
// What bounds them on an H100: an Fq product moves 3 * 24 * 4 = 288 bytes (a
// 16-bit limb takes a 32-bit slot in the stored layout) and does
// 2 * 12^2 + 12 = 300 wide multiply-adds.  At the card's peak rates the bytes
// take longer than the multiply-adds, so the memory binds, narrowly (the
// reckoning is in PERF.md).  Nothing here is tuned.
//
// Plain C interface for ctypes: pointers are device pointers to contiguous
// int32 planes, `stream` is a cudaStream_t, the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "field.cuh"

#define THREADS 128

template <class F>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    mont_mul_lane<F>(a, b, out, n, idx);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
mont_sqr_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out,
                size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    mont_sqr_lane<F>(a, out, n, idx);
}

static inline unsigned blocks_for(size_t n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

template <class F>
static int launch_mul(const void* a, const void* b, void* out, long long n,
                      void* stream) {
    if (n > 0) {
        mont_mul_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static int launch_sqr(const void* a, void* out, long long n, void* stream) {
    if (n > 0) {
        mont_sqr_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (uint32_t*)out, (size_t)n);
    }
    return (int)cudaGetLastError();
}

extern "C" {

int fr_mont_mul(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_mul<Fr>(a, b, out, n, stream);
}

int fq_mont_mul(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_mul<Fq>(a, b, out, n, stream);
}

int fr_mont_sqr(const void* a, void* out, long long n, void* stream) {
    return launch_sqr<Fr>(a, out, n, stream);
}

int fq_mont_sqr(const void* a, void* out, long long n, void* stream) {
    return launch_sqr<Fq>(a, out, n, stream);
}

}  // extern "C"
