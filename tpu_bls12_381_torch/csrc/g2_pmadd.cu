// Fused G2 signed mixed add, with a row loop.
//
// Takes the place of the JAX package's curves/pallas_g2.py kernel
// _pmadd2_kernel.  Two threads own one lane (one point operation over Fq2,
// each thread one component of every Fq2 value: g2_pair.cuh); the formula is
// g2.cuh's g2_proj_madd.
//
// The kernel carries a row count R like the G1 kernel: per lane the MSM's
// bucket scan is a chain of R dependent mixed adds down the rows of an
// (R, 24, 2, L) tile, and a pair keeps the accumulator, walks its column's
// rows and writes every prefix row.  R = 1 with an accumulator passed in is
// the elementwise signed mixed add.  The sign is always an operand, as in the
// JAX kernel.
//
// What bounds it on an H100: a mixed add over Fq2 is 11 Karatsuba products
// = 33 Fq products of 300 wide multiply-adds each against 10 * 96 = 960
// bytes per lane and row, so the integer pipe binds.  An Fq2 point is 72
// words, and the first form of this kernel (one thread a lane, field.cuh's
// product) spilled 2,164 / 2,044 bytes a thread at 255 registers and read 16
// times its bound.  What the design does about it (PERF.md has the builds
// tried and their times):
//  * the carry-chain product of field_carry.cuh, as every G1 scan kernel;
//  * two threads a lane (g2_pair.cuh): half the state a thread, each Fq2
//    product two Fq products a thread after one exchange of operands, so a
//    lane's add is 22 products deep where one thread's is 33;
//  * the products ordered so that X, Y and the operand die before mul12(Z),
//    and the last six taken around their cycle;
//  * a row whose point is the identity skips the add (a branch, where the
//    JAX kernel selects), so the accumulator need not stay live beside the
//    formula.
// 255 registers, 228 / 244 bytes of spill; the MSM's G2 tile
// (tuning.py: msm_g2_lane_tile_log_min) is 2^14 lanes: 256 blocks of 64
// pairs, two blocks an SM.
//
// Plain C interface for ctypes: device pointers to int32 limb planes in the
// (24, 2, n) layout of g2.cuh, masks as one byte per lane, `stream` a
// cudaStream_t, return value cudaGetLastError() after the launch.  Each G2
// source (g2_pmadd.cu, g2_padd.cu, g2_padd_scan.cu, g2_pdbl.cu) is apart, so
// that they compile side by side.

#include <cuda_runtime.h>

#include "g2_pair.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS, 2)
pmadd2_kernel(const uint32_t* __restrict__ accX, const uint32_t* __restrict__ accY,
              const uint32_t* __restrict__ accZ,
              const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
              size_t row_stride,
              const uint8_t* __restrict__ inf2, const uint8_t* __restrict__ sign,
              uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
              uint32_t* __restrict__ Z3, size_t L, int R) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    // Every thread of a warp runs to the end: each row's ballot names the
    // pairs that add, and a shuffle needs its partner.
    const bool odd = (threadIdx.x & 1) != 0;
    const bool live = idx / 2 < L;
    g2_pmadd_pair_lane(accX, accY, accZ, x2, y2, row_stride, inf2, sign, X3, Y3, Z3,
                       L, R, live ? idx / 2 : 0, live, [odd](bool take) {
                           return pair_ctx{__ballot_sync(0xffffffffu, take), odd};
                       });
}

extern "C" {

int g2_pmadd(const void* accX, const void* accY, const void* accZ,
             const void* x2, const void* y2, long long row_stride,
             const void* inf2, const void* sign,
             void* X3, void* Y3, void* Z3,
             long long L, int R, void* stream) {
    if (L > 0 && R > 0) {
        unsigned blocks = (unsigned)(((size_t)L * 2 + THREADS - 1) / THREADS);
        pmadd2_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)accX, (const uint32_t*)accY, (const uint32_t*)accZ,
            (const uint32_t*)x2, (const uint32_t*)y2, (size_t)row_stride,
            (const uint8_t*)inf2, (const uint8_t*)sign,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)L, R);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
