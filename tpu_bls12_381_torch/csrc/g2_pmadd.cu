// Fused G2 signed mixed add, with a row loop.
//
// Takes the place of the JAX package's curves/pallas_g2.py kernel
// _pmadd2_kernel.  One thread owns one lane (one point operation over Fq2);
// the formula is in g2.cuh.
//
// The kernel carries a row count R like the G1 kernel: per lane the MSM's
// bucket scan is a chain of R dependent mixed adds down the rows of an
// (R, 24, 2, L) tile, and a thread keeps the accumulator, walks its column's
// rows and writes every prefix row.  R = 1 with an accumulator passed in is
// the elementwise signed mixed add.  The sign is always an operand, as in the
// JAX kernel.
//
// What bounds it on an H100: a mixed add over Fq2 is 11 Karatsuba products
// = 33 Fq products of 300 wide multiply-adds each against 10 * 96 = 960
// bytes per lane and row, so the integer pipe binds.  An Fq2 point is 72
// words of state and Karatsuba keeps three products live, so at 255 registers
// a thread the kernel spills to local memory (the build prints how much);
// that is left as it is here.  Nothing is tuned.
//
// Plain C interface for ctypes: device pointers to int32 limb planes in the
// (24, 2, n) layout of g2.cuh, masks as one byte per lane, `stream` a
// cudaStream_t, return value cudaGetLastError() after the launch.  Each G2
// kernel has a source of its own (g2_pmadd.cu, g2_padd.cu, g2_pdbl.cu), so
// that the three compile side by side: they spill, and ptxas takes its time
// over each.

#include <cuda_runtime.h>

#include "g2.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
pmadd2_kernel(const uint32_t* __restrict__ accX, const uint32_t* __restrict__ accY,
              const uint32_t* __restrict__ accZ,
              const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
              size_t row_stride,
              const uint8_t* __restrict__ inf2, const uint8_t* __restrict__ sign,
              uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
              uint32_t* __restrict__ Z3, size_t L, int R) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= L) return;
    g2_pmadd_lane(accX, accY, accZ, x2, y2, row_stride, inf2, sign,
                  X3, Y3, Z3, L, R, idx);
}

extern "C" {

int g2_pmadd(const void* accX, const void* accY, const void* accZ,
             const void* x2, const void* y2, long long row_stride,
             const void* inf2, const void* sign,
             void* X3, void* Y3, void* Z3,
             long long L, int R, void* stream) {
    if (L > 0 && R > 0) {
        unsigned blocks = (unsigned)(((size_t)L + THREADS - 1) / THREADS);
        pmadd2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)accX, (const uint32_t*)accY, (const uint32_t*)accZ,
            (const uint32_t*)x2, (const uint32_t*)y2, (size_t)row_stride,
            (const uint8_t*)inf2, (const uint8_t*)sign,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)L, R);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
