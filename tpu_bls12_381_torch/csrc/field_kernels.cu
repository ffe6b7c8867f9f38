// Elementwise field kernels over (K, N) limb planes: Montgomery product and
// square, modular add and sub, and the radix-2 NTT butterfly.
//
// They take the place of the JAX package's fields/pallas_ops.py kernels
// _build_mul_kernel (mont_mul), _build_sqr_kernel (mont_sqr),
// _build_add_kernel (add), _build_sub_kernel (sub) and
// _build_butterfly_kernel (butterfly), for Fr (K = 16) and Fq (K = 24).  One
// thread owns one element (one pair, for the butterfly); see field.cuh.
//
// What bounds them on an H100: an Fq product moves 3 * 24 * 4 = 288 bytes (a
// 16-bit limb takes a 32-bit slot in the stored layout) and does
// 2 * 12^2 + 12 = 300 wide multiply-adds.  At the card's peak rates the bytes
// take longer than the multiply-adds, so the memory binds, narrowly.  add and
// sub move the same bytes for a handful of additions: the memory binds them
// outright.  The butterfly moves five elements for one product: the memory
// binds it three times over.  (The reckoning is in PERF.md.)  Nothing here is
// tuned.
//
// `butterfly` is the elementwise form of the TPU kernel: contiguous e, o, w
// of one shape in, hi and lo out.  The ladder's stages on the array where it
// lies, several a launch, are ntt_stages.cu's.
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

template <class F>
__global__ void __launch_bounds__(THREADS)
field_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    add_lane<F>(a, b, out, n, idx);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
field_sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    sub_lane<F>(a, b, out, n, idx);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
butterfly_kernel(const uint32_t* __restrict__ e, const uint32_t* __restrict__ o,
                 const uint32_t* __restrict__ w, uint32_t* __restrict__ hi,
                 uint32_t* __restrict__ lo, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    butterfly_lane<F>(e, o, w, hi, lo, n, idx);
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

template <class F>
static int launch_add(const void* a, const void* b, void* out, long long n,
                      void* stream) {
    if (n > 0) {
        field_add_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static int launch_sub(const void* a, const void* b, void* out, long long n,
                      void* stream) {
    if (n > 0) {
        field_sub_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static int launch_butterfly(const void* e, const void* o, const void* w,
                            void* hi, void* lo, long long n, void* stream) {
    if (n > 0) {
        butterfly_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)e, (const uint32_t*)o, (const uint32_t*)w,
            (uint32_t*)hi, (uint32_t*)lo, (size_t)n);
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

int fr_field_add(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_add<Fr>(a, b, out, n, stream);
}

int fq_field_add(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_add<Fq>(a, b, out, n, stream);
}

int fr_field_sub(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_sub<Fr>(a, b, out, n, stream);
}

int fq_field_sub(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_sub<Fq>(a, b, out, n, stream);
}

int fr_butterfly(const void* e, const void* o, const void* w, void* hi, void* lo,
                 long long n, void* stream) {
    return launch_butterfly<Fr>(e, o, w, hi, lo, n, stream);
}

int fq_butterfly(const void* e, const void* o, const void* w, void* hi, void* lo,
                 long long n, void* stream) {
    return launch_butterfly<Fq>(e, o, w, hi, lo, n, stream);
}

}  // extern "C"
