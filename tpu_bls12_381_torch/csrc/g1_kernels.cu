// Fused G1 group-law kernels: signed mixed add (with a row loop), mixed add,
// add, double.
//
// They take the place of the JAX package's curves/pallas_g1.py kernels
// _pmadd_signed_kernel, _pmadd_kernel, _padd_kernel and _pdbl_kernel.  One thread owns one
// lane (one point operation); the formulas are in g1.cuh.
//
// pmadd_signed carries a row count R.  The MSM's bucket scan is, per lane, a
// chain of R dependent mixed adds down the rows of an (R, 24, L) tile.  The
// JAX package runs it as R sequential launches; here the thread keeps the
// accumulator in registers, walks its column's R rows and writes every
// prefix row (the last row is the column total).  R = 1 with an accumulator
// passed in is the elementwise signed mixed add.
//
// What bounds them on an H100: a mixed add reads 2 and writes 3 coordinates
// (5 * 96 = 480 bytes per lane and row in the looped form) and does 11 Fq
// products of 300 wide multiply-adds each, so the integer pipe binds (the
// reckoning is in PERF.md).  With few lanes (the stitch, triangle and Horner
// calls run on 1 to 2^15 lanes) a launch is bound by its latency instead.
// Nothing here is tuned.
//
// Plain C interface for ctypes: device pointers to int32 limb planes, masks
// as one byte per lane, `stream` a cudaStream_t, return value
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "g1.cuh"

#define THREADS 128

// One thread per lane; the lane bodies (and the meaning of the arguments) are
// in g1.cuh.
__global__ void __launch_bounds__(THREADS)
pmadd_signed_kernel(const uint32_t* __restrict__ accX, const uint32_t* __restrict__ accY,
                    const uint32_t* __restrict__ accZ,
                    const uint32_t* __restrict__ x2, const uint32_t* __restrict__ y2,
                    size_t row_stride,
                    const uint8_t* __restrict__ inf2, const uint8_t* __restrict__ sign,
                    uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
                    uint32_t* __restrict__ Z3, size_t L, int R) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= L) return;
    g1_pmadd_signed_lane(accX, accY, accZ, x2, y2, row_stride, inf2, sign,
                         X3, Y3, Z3, L, R, idx);
}

// The mixed add without the sign (the joint double-and-add of
// curves/glv.py::scalar_mul_glv is its one caller): 11 Fq products against
// 5 * 24 limbs read and 3 * 24 written, so the integer pipe binds as above.
__global__ void __launch_bounds__(THREADS)
pmadd_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
             const uint32_t* __restrict__ Z1, const uint32_t* __restrict__ x2,
             const uint32_t* __restrict__ y2, const uint8_t* __restrict__ inf2,
             uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
             uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_pmadd_lane(X1, Y1, Z1, x2, y2, inf2, X3, Y3, Z3, n, idx);
}

__global__ void __launch_bounds__(THREADS)
padd_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
            const uint32_t* __restrict__ Z1, const uint32_t* __restrict__ X2,
            const uint32_t* __restrict__ Y2, const uint32_t* __restrict__ Z2,
            uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
            uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_padd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, idx);
}

__global__ void __launch_bounds__(THREADS)
pdbl_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
            const uint32_t* __restrict__ Z1, uint32_t* __restrict__ X3,
            uint32_t* __restrict__ Y3, uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, idx);
}

static inline unsigned blocks_for(size_t n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

extern "C" {

int g1_pmadd_signed(const void* accX, const void* accY, const void* accZ,
                    const void* x2, const void* y2, long long row_stride,
                    const void* inf2, const void* sign,
                    void* X3, void* Y3, void* Z3,
                    long long L, int R, void* stream) {
    if (L > 0 && R > 0) {
        pmadd_signed_kernel<<<blocks_for((size_t)L), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)accX, (const uint32_t*)accY, (const uint32_t*)accZ,
            (const uint32_t*)x2, (const uint32_t*)y2, (size_t)row_stride,
            (const uint8_t*)inf2, (const uint8_t*)sign,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)L, R);
    }
    return (int)cudaGetLastError();
}

int g1_pmadd(const void* X1, const void* Y1, const void* Z1,
             const void* x2, const void* y2, const void* inf2,
             void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        pmadd_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (const uint32_t*)x2, (const uint32_t*)y2, (const uint8_t*)inf2,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

int g1_padd(const void* X1, const void* Y1, const void* Z1,
            const void* X2, const void* Y2, const void* Z2,
            void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        padd_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (const uint32_t*)X2, (const uint32_t*)Y2, (const uint32_t*)Z2,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

int g1_pdbl(const void* X1, const void* Y1, const void* Z1,
            void* X3, void* Y3, void* Z3, long long n, void* stream) {
    if (n > 0) {
        pdbl_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
