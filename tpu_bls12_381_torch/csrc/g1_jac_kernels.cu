// Fused G1 Jacobian group-law kernels: mixed add, add, double.
//
// They take the place of the JAX package's curves/pallas_g1.py kernels
// _madd_kernel, _add_kernel and _dbl_kernel.  One thread owns one lane (one
// point operation); the formulas and the constant-time selections are in
// g1_jac.cuh.  Their callers are the routers of curves/points.py:
// scalar_mul (a doubling and a mixed add a bit, hence is_in_subgroup) and
// sum_reduce (one add a round).
//
// What bounds them on an H100: a doubling is 2 products and 5 squares against
// 6 * 24 limbs a lane; the mixed add's sum is 7 products and 4 squares against
// 8 * 24 limbs and a mask byte, the add computes its sum and the doubling in
// every lane (13 products, 10 squares against 9 * 24 limbs).  A product is 300
// wide multiply-adds and a square 234, so the integer pipe binds on wide
// launches; with few lanes (the last rounds of sum_reduce) a launch is bound
// by its latency.  What madd's design does about it (jdbl and jadd are as
// first written):
//  * it runs on the carry-chain product of field_carry.cuh (two
//    mad.lo.cc / madc.hi.cc chains a row), its squares as products a*a;
//  * it computes the doubling (2M + 5S) only in a warp where a lane has
//    P == A, which no lane of a real SRS has on the is_in_subgroup ladder
//    (the accumulator there is 2 * prefix * A; a member's last step meets
//    P == -A, the identity selection, which needs no doubling).  The values
//    are those of the doubling computed everywhere (g1_jac.cuh).
// madd takes 254 registers.  Its build with the doubling in every lane (255
// registers, 52 bytes of spill; chip_smoke.py's chain_sweep times the two)
// takes about 1.57 times as long on an H100; builds for three blocks an SM
// and builds without the doubling at all read within 5% of the kept one
// (PERF.md): what is left of its time is the sum's.
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

}  // extern "C"
