// Fused G2 projective addition.
//
// Takes the place of the JAX package's curves/pallas_g2.py kernel
// _padd2_kernel.  One thread owns one lane (one point addition over Fq2,
// RCB16 algorithm 7; the formula is in g2.cuh).  The same addition scanned
// along the last axis, the G2 MSM tail's lane scans, is padd2_scan
// (g2_padd_scan.cu).
//
// What bounds it on an H100: 12 Karatsuba products = 36 Fq products of 300
// wide multiply-adds each against 9 * 96 * 2 bytes a lane, so the integer
// pipe binds on wide launches; with few lanes a launch is bound by its
// latency.  It runs on the carry-chain product of field_carry.cuh (two
// mad.lo.cc / madc.hi.cc chains a row), with the addition's products taken
// X's three first, then Y's, then Z's, so that operands die early: a thread
// holding two 72-word points spills 880 / 1,060 bytes at 255 registers
// where the first form spilled 1,624 / 1,924 (PERF.md has the times).
//
// Plain C interface for ctypes: device pointers to int32 limb planes in the
// (24, 2, n) layout of g2.cuh, `stream` a cudaStream_t, return value
// cudaGetLastError() after the launch.  Each G2 source (g2_pmadd.cu,
// g2_padd.cu, g2_padd_scan.cu, g2_pdbl.cu) is apart, so that they compile
// side by side.

#include <cuda_runtime.h>

#include "g2.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS, 2)
padd2_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
             const uint32_t* __restrict__ Z1, const uint32_t* __restrict__ X2,
             const uint32_t* __restrict__ Y2, const uint32_t* __restrict__ Z2,
             uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
             uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g2_padd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, idx);
}

extern "C" {

int g2_padd(const void* X1, const void* Y1, const void* Z1,
            const void* X2, const void* Y2, const void* Z2,
            void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        unsigned blocks = (unsigned)(((size_t)n + THREADS - 1) / THREADS);
        padd2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (const uint32_t*)X2, (const uint32_t*)Y2, (const uint32_t*)Z2,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
