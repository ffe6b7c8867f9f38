// Fused G1 Jacobian group-law kernels: the double-and-add ladder, mixed add,
// add, double.
//
// They take the place of the JAX package's curves/pallas_g1.py kernels
// _dbl_kernel and _madd_kernel as curves/points.py's scalar_mul runs them
// (jac_ladder: one launch for the whole ladder, where the JAX package
// launches both once a bit), _madd_kernel, _add_kernel and _dbl_kernel.  One
// thread owns one lane; the formulas and the constant-time selections are in
// g1_jac.cuh.  Their callers are the routers of curves/points.py: scalar_mul
// (jac_ladder, hence is_in_subgroup), sum_reduce (one jadd a round), and the
// elementwise jac_add_affine_fast and jac_double_fast (madd, jdbl).
//
// What bounds them on an H100: a doubling is 2 products and 5 squares against
// 6 * 24 limbs a lane, the mixed add's sum 7 products and 4 squares against
// 8 * 24 limbs and a mask byte, the add's 11 products and 5 squares against
// 9 * 24 limbs, the doublings that P == A or P == Q lanes need 2M + 5S more.
// A product is 300 wide multiply-adds and a square 234, so the integer pipe
// binds on wide launches; with few lanes (the last rounds of sum_reduce) a
// launch is bound by its latency.  The ladder moves 2 * 24 limbs, a mask byte
// and the scalar in and 3 * 24 limbs out for num_bits doublings and an add a
// set bit.  What the design does about it:
//  * every kernel runs on the carry-chain product of field_carry.cuh (two
//    mad.lo.cc / madc.hi.cc chains a row), its squares as products a*a;
//  * madd and jadd compute the doubling only in a warp where a lane has
//    P == A (P == Q).  No lane of a real SRS meets it on the is_in_subgroup
//    ladder (the accumulator there is 2 * prefix * A; a member's last step
//    meets P == -A, the identity selection, which needs no doubling), nor in
//    sum_reduce where the points are distinct.  The values are those of the
//    doubling computed everywhere (g1_jac.cuh).
//  * jac_ladder keeps the accumulator in registers for all num_bits steps
//    (the routed loop it replaces wrote it to device memory and read it
//    back some three times a bit, 302 MB each time at 2^20 lanes, in 2
//    launches and 3 selects) and adds only in a warp where a lane's
//    bit is set (121 of the 255 bits of r are zero, so is_in_subgroup,
//    whose scalar is the same in every lane, skips 121 adds).  A and the
//    scalar are read once (the scalar a limb every 16 bits).
// Registers (ptxas, no spill in any): jac_ladder 248 (x and y held for all
// steps; a build that reads them again at each add took 234 and read the
// same time in turns on an H100, within 1.5%, so it was not kept), jadd 252
// (255 and 116 bytes of spill on field.cuh's product), jdbl 111, madd 254;
// madd's build with the doubling in every lane (255 registers, 52 bytes of
// spill; chip_smoke.py's chain_sweep times the two) takes about 1.4 times as
// long (PERF.md).
//
// Plain C interface for ctypes: device pointers to int32 limb planes, the mask
// as one byte per lane, `stream` a cudaStream_t, return value
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "g1_jac.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
jdbl_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
            const uint32_t* __restrict__ Z1, uint32_t* __restrict__ X3,
            uint32_t* __restrict__ Y3, uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_jdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, idx);
}

__global__ void __launch_bounds__(THREADS)
madd_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
            const uint32_t* __restrict__ Z1, const uint32_t* __restrict__ x2,
            const uint32_t* __restrict__ y2, const uint8_t* __restrict__ inf2,
            uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
            uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_madd_lane(X1, Y1, Z1, x2, y2, inf2, X3, Y3, Z3, n, idx);
}

__global__ void __launch_bounds__(THREADS)
jadd_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
            const uint32_t* __restrict__ Z1, const uint32_t* __restrict__ X2,
            const uint32_t* __restrict__ Y2, const uint32_t* __restrict__ Z2,
            uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
            uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_jadd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, idx);
}

__global__ void __launch_bounds__(THREADS)
jac_ladder_kernel(const uint32_t* __restrict__ scalars, size_t s_plane, size_t s_lane,
                  const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
                  const uint8_t* __restrict__ inf2, uint32_t* __restrict__ X3,
                  uint32_t* __restrict__ Y3, uint32_t* __restrict__ Z3, size_t n,
                  int num_bits) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_jac_ladder_lane(scalars, s_plane, s_lane, x2, y2, inf2, X3, Y3, Z3, n, idx,
                       num_bits);
}

static inline unsigned blocks_for(size_t n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

extern "C" {

int g1_jdbl(const void* X1, const void* Y1, const void* Z1,
            void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        jdbl_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

int g1_madd(const void* X1, const void* Y1, const void* Z1,
            const void* x2, const void* y2, const void* inf2,
            void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        madd_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (const uint32_t*)x2, (const uint32_t*)y2, (const uint8_t*)inf2,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

int g1_jadd(const void* X1, const void* Y1, const void* Z1,
            const void* X2, const void* Y2, const void* Z2,
            void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        jadd_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (const uint32_t*)X2, (const uint32_t*)Y2, (const uint32_t*)Z2,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

int g1_jac_ladder(const void* scalars, long long s_plane, long long s_lane,
                  const void* x2, const void* y2, const void* inf2,
                  void* X3, void* Y3, void* Z3, long long n, int num_bits,
                  void* stream) {
    if (n > 0) {
        jac_ladder_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)scalars, (size_t)s_plane, (size_t)s_lane,
            (const uint32_t*)x2, (const uint32_t*)y2, (const uint8_t*)inf2,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n, num_bits);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
