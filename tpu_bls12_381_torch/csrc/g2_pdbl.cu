// Fused G2 projective doubling, with a count `times`.
//
// Takes the place of the JAX package's curves/pallas_g2.py kernel
// _pdbl2_kernel.  One thread owns one lane (RCB16 algorithm 9 over Fq2 with
// complex squaring); the formula is in g2.cuh.
//
// What bounds it on an H100: 6 Karatsuba products and 2 complex squares = 22
// Fq products of 300 wide multiply-adds each a doubling, against 6 * 96 * 2
// bytes a lane, so the integer pipe binds on wide launches; with few lanes a
// launch is bound by its latency.  What the design does about it:
//  * every caller doubles a point many times in a row (the G2 MSM's triangle
//    combine and Horner ladder, 7 and 14 times on one lane; expand_bases, 140
//    times on 2^20 lanes at factor 2), which the JAX package runs as a
//    fori_loop of launches.  Here the thread loads its lane once, doubles
//    `times` times in registers and stores once: one launch a chain, 6 * 48
//    limbs moved for times * 22 products;
//  * the products are the carry-chain product of field_carry.cuh (two
//    mad.lo.cc / madc.hi.cc chains a row), as g1's pdbl;
//  * the doubling takes X * Y first, so X dies at the top (g2.cuh).
//
// Plain C interface for ctypes: device pointers to int32 limb planes in the
// (24, 2, n) layout of g2.cuh, `stream` a cudaStream_t, return value
// cudaGetLastError() after the launch.  A source of its own, so that the
// three G2 kernels compile side by side.

#include <cuda_runtime.h>

#include "g2.cuh"

#define THREADS 128

// One build, for two blocks an SM: 255 registers and 16 bytes of spill, as
// the build for one (the same cap); it measured 0.3 to 4% faster a doubling
// at 2^20 lanes and level over 140 (PERF.md).
__global__ void __launch_bounds__(THREADS, 2)
pdbl2_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
             const uint32_t* __restrict__ Z1, uint32_t* __restrict__ X3,
             uint32_t* __restrict__ Y3, uint32_t* __restrict__ Z3, size_t n,
             int times) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g2_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, idx, times);
}

extern "C" {

// `times` doublings of every lane (times >= 1).
int g2_pdbl(const void* X1, const void* Y1, const void* Z1,
            void* X3, void* Y3, void* Z3, long long n, int times, void* stream) {
    if (times < 1) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        unsigned blocks = (unsigned)(((size_t)n + THREADS - 1) / THREADS);
        pdbl2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n, times);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
