// Fused G2 projective doubling.
//
// Takes the place of the JAX package's curves/pallas_g2.py kernel
// _pdbl2_kernel.  One thread owns one lane (one doubling over Fq2, RCB16
// algorithm 9 with complex squaring); the formula is in g2.cuh.
//
// What bounds it on an H100: 6 Karatsuba products and 2 complex squares = 22
// Fq products of 300 wide multiply-adds each against 6 * 96 * 2 bytes a lane,
// so the integer pipe binds on wide launches; with few lanes a launch is
// bound by its latency.  Nothing is tuned.
//
// Plain C interface for ctypes: device pointers to int32 limb planes in the
// (24, 2, n) layout of g2.cuh, `stream` a cudaStream_t, return value
// cudaGetLastError() after the launch.  A source of its own, so that the
// three G2 kernels compile side by side.

#include <cuda_runtime.h>

#include "g2.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
pdbl2_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
             const uint32_t* __restrict__ Z1, uint32_t* __restrict__ X3,
             uint32_t* __restrict__ Y3, uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g2_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, idx);
}

extern "C" {

int g2_pdbl(const void* X1, const void* Y1, const void* Z1,
            void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        unsigned blocks = (unsigned)(((size_t)n + THREADS - 1) / THREADS);
        pdbl2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
