// The lane scan: complete additions scanned along the last axis of `rows`
// rows of L lanes, coordinates (*elem, rows, L), for one point type C
// (G1Curve of g1.cuh: padd_scan in g1_kernels.cu; G2Curve of g2.cuh:
// padd2_scan in g2_padd_scan.cu).  C gives the point P, identity, add, load
// and store in its layout (planes n slots apart), and put / get of a point
// into C::WORDS shared-memory planes of T words.
//
// Logical lane i of a row is physical lane i, or L - 1 - i for a suffix
// scan.  Thread t of block k owns the run of `run` logical lanes from
// (k * T + t) * run.  Three passes:
//  up     each thread folds its run; the block scans the run totals
//         (inclusive, in shared memory) and writes them to V (rows, nblk*T);
//  carry  one block a row scans the block totals V[., k*T + T - 1] the same
//         way (runs of run2) into exclusive block carries C (rows, nblk), and
//         the row's total;
//  down   each thread starts from C[k] + V[k*T + t - 1] (the identity for
//         t = 0) and walks its run again, writing every lane.
// A fold or a walk adds only what exists (lanes below L, blocks below nblk);
// a run with nothing in it is the identity.
// Every sum is the same association in curves/cuda_g1.py::lane_scan_plain.
// The serial bodies come first; the block scan and the kernels follow for
// the card (host_check.cpp runs the block scans as loops).

#pragma once

#include "field.cuh"

// The fold of a thread's run, in the up pass (lanes) and in the carry pass
// (block totals): `count` points from slot p0 of planes n slots apart, `step`
// slots apart (step 0xffffffff walks down), added in order; the identity for
// a run past the end (count 0).  32-bit slots: the wrapper keeps
// rows * nblk * T and rows * L below 2^31.
template <class C>
DEV typename C::P scan_fold(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                            uint32_t n, uint32_t p0, uint32_t step, uint32_t count) {
    if (count == 0) return C::identity();
    typename C::P acc = C::load(X, Y, Z, n, p0);
    uint32_t p = p0;
    ROLLED
    for (uint32_t j = 1; j < count; ++j) {
        p += step;
        acc = C::add(acc, C::load(X, Y, Z, n, p));
    }
    return acc;
}

// The up pass's run of thread t of block k: lanes i0 = (k*T + t)*run on.
template <class C>
DEV typename C::P scan_fold_lanes(const uint32_t* X, const uint32_t* Y,
                                  const uint32_t* Z, uint32_t L, uint32_t rows,
                                  uint32_t b, uint32_t i0, uint32_t run, bool reverse) {
    uint32_t count = i0 < L ? (L - i0 < run ? L - i0 : run) : 0u;
    return scan_fold<C>(X, Y, Z, rows * L, b * L + (reverse ? L - 1u - i0 : i0),
                        reverse ? 0xffffffffu : 1u, count);
}

// The carry pass's run of thread t: block totals q0 = t*run2 on, which lie
// at V[., q*T + T - 1].
template <class C>
DEV typename C::P scan_fold_totals(const uint32_t* VX, const uint32_t* VY,
                                   const uint32_t* VZ, uint32_t rows, uint32_t nblk,
                                   uint32_t T, uint32_t b, uint32_t q0, uint32_t run2) {
    uint32_t count = q0 < nblk ? (nblk - q0 < run2 ? nblk - q0 : run2) : 0u;
    return scan_fold<C>(VX, VY, VZ, rows * nblk * T, (b * nblk + q0) * T + T - 1u, T,
                        count);
}

// The down pass's walk of one run from its carry-in `acc`.
template <class C>
DEV void scan_walk(typename C::P acc, const uint32_t* X, const uint32_t* Y,
                   const uint32_t* Z, uint32_t* OX, uint32_t* OY, uint32_t* OZ,
                   size_t L, size_t n, size_t b, size_t i0, int run, bool reverse,
                   bool exclusive) {
    ROLLED
    for (int j = 0; j < run; ++j) {
        size_t i = i0 + j;
        if (i >= L) break;
        size_t p = b * L + (reverse ? L - 1 - i : i);
        typename C::P x = C::load(X, Y, Z, n, p);
        if (exclusive) C::store(OX, OY, OZ, n, p, acc);
        acc = C::add(acc, x);
        if (!exclusive) C::store(OX, OY, OZ, n, p, acc);
    }
}

// The carry pass's walk: the exclusive carry of every block of the run.
template <class C>
DEV void scan_carry_walk(typename C::P acc, const uint32_t* VX, const uint32_t* VY,
                         const uint32_t* VZ, uint32_t* CX, uint32_t* CY, uint32_t* CZ,
                         size_t rows, size_t nblk, size_t T, size_t b, size_t q0,
                         int run2) {
    ROLLED
    for (int j = 0; j < run2; ++j) {
        size_t q = q0 + j;
        if (q >= nblk) break;
        C::store(CX, CY, CZ, rows * nblk, b * nblk + q, acc);
        acc = C::add(acc,
                     C::load(VX, VY, VZ, rows * nblk * T, (b * nblk + q) * T + T - 1));
    }
}

// The down pass's carry-in of thread t of block k.
template <class C>
DEV typename C::P scan_carry_in(const uint32_t* VX, const uint32_t* VY,
                                const uint32_t* VZ, const uint32_t* CX,
                                const uint32_t* CY, const uint32_t* CZ, size_t rows,
                                size_t nblk, size_t T, size_t b, size_t k, size_t t) {
    typename C::P before =
        t > 0 ? C::load(VX, VY, VZ, rows * nblk * T, (b * nblk + k) * T + t - 1)
              : C::identity();
    return C::add(C::load(CX, CY, CZ, rows * nblk, b * nblk + k), before);
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

// The lane scan's most threads a block (C::WORDS words a point of shared
// memory each: 18 KB at 128 for G1, 36 KB for G2, under the 48 KB that a
// launch takes without opting in).
#define SCAN_MAX_THREADS 128

// Inclusive Hillis-Steele scan of the block's values v (one a thread, log2 T
// steps); sh holds the inclusive sums on return.  Both operands of a step's
// add are read from sh, so no point stays in registers across the
// barriers.
template <class C>
__device__ typename C::P block_scan(uint32_t* sh, const typename C::P& v) {
    const unsigned T = blockDim.x, t = threadIdx.x;
    C::put(sh, T, t, v);
    __syncthreads();
    ROLLED
    for (unsigned s = 1; s < T; s <<= 1) {
        typename C::P sum;
        if (t >= s) sum = C::add(C::get(sh, T, t - s), C::get(sh, T, t));
        __syncthreads();
        if (t >= s) C::put(sh, T, t, sum);
        __syncthreads();
    }
    return C::get(sh, T, t);
}

// grid (nblk, rows), block T: the run totals' inclusive block scan into V.
template <class C>
__global__ void __launch_bounds__(SCAN_MAX_THREADS)
padd_scan_up_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y,
                    const uint32_t* __restrict__ Z, uint32_t* __restrict__ VX,
                    uint32_t* __restrict__ VY, uint32_t* __restrict__ VZ, size_t L,
                    int run, int reverse) {
    extern __shared__ uint32_t sh[];
    const size_t T = blockDim.x, t = threadIdx.x, k = blockIdx.x, b = blockIdx.y;
    const size_t rows = gridDim.y, nblk = gridDim.x;
    typename C::P v = block_scan<C>(
        sh, scan_fold_lanes<C>(X, Y, Z, (uint32_t)L, (uint32_t)rows, (uint32_t)b,
                               (uint32_t)((k * T + t) * run), (uint32_t)run, reverse != 0));
    C::store(VX, VY, VZ, rows * nblk * T, (b * nblk + k) * T + t, v);
}

// grid (1, rows), block T2: the block totals' exclusive carries into C and,
// where SX is given, each row's total into S (rows).
template <class C>
__global__ void __launch_bounds__(SCAN_MAX_THREADS)
padd_scan_carry_kernel(const uint32_t* __restrict__ VX, const uint32_t* __restrict__ VY,
                       const uint32_t* __restrict__ VZ, uint32_t* __restrict__ CX,
                       uint32_t* __restrict__ CY, uint32_t* __restrict__ CZ,
                       uint32_t* __restrict__ SX, uint32_t* __restrict__ SY,
                       uint32_t* __restrict__ SZ, size_t nblk, size_t T1, int run2) {
    extern __shared__ uint32_t sh[];
    const size_t t = threadIdx.x, b = blockIdx.y, rows = gridDim.y;
    typename C::P w = block_scan<C>(
        sh, scan_fold_totals<C>(VX, VY, VZ, (uint32_t)rows, (uint32_t)nblk, (uint32_t)T1,
                                (uint32_t)b, (uint32_t)(t * run2), (uint32_t)run2));
    if (SX != nullptr && t == blockDim.x - 1) C::store(SX, SY, SZ, rows, b, w);
    typename C::P acc = t > 0 ? C::get(sh, blockDim.x, t - 1) : C::identity();
    scan_carry_walk<C>(acc, VX, VY, VZ, CX, CY, CZ, rows, nblk, T1, b, t * run2, run2);
}

// grid (nblk, rows), block T: every lane from its thread's carry-in.
template <class C>
__global__ void __launch_bounds__(SCAN_MAX_THREADS)
padd_scan_down_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y,
                      const uint32_t* __restrict__ Z, const uint32_t* __restrict__ VX,
                      const uint32_t* __restrict__ VY, const uint32_t* __restrict__ VZ,
                      const uint32_t* __restrict__ CX, const uint32_t* __restrict__ CY,
                      const uint32_t* __restrict__ CZ, uint32_t* __restrict__ OX,
                      uint32_t* __restrict__ OY, uint32_t* __restrict__ OZ, size_t L,
                      int run, int reverse, int exclusive) {
    const size_t T = blockDim.x, t = threadIdx.x, k = blockIdx.x, b = blockIdx.y;
    const size_t rows = gridDim.y, nblk = gridDim.x;
    typename C::P acc = scan_carry_in<C>(VX, VY, VZ, CX, CY, CZ, rows, nblk, T, b, k, t);
    scan_walk<C>(acc, X, Y, Z, OX, OY, OZ, L, rows * L, b, (k * T + t) * run, run,
                 reverse != 0, exclusive != 0);
}

// The lane scan of (*elem, rows, L) coordinates X, Y, Z.  Scan mode: writes
// OX, OY, OZ (same shape), 3 launches.  Total mode (OX null): writes the
// row totals SX, SY, SZ (*elem, rows), 2 launches.  Scratch: V (*elem, rows,
// nblk*threads) and C (*elem, rows, nblk), nblk = ceil(L / (run * threads));
// threads and threads2 (the carry pass's) are powers of two up to
// SCAN_MAX_THREADS, run2 = ceil(nblk / threads2).  Returns
// cudaGetLastError() after the launches.
template <class C>
int padd_scan_launch(const void* X, const void* Y, const void* Z,
                     void* OX, void* OY, void* OZ, void* SX, void* SY, void* SZ,
                     void* VX, void* VY, void* VZ, void* CX, void* CY, void* CZ,
                     long long rows, long long L, int run, int threads, int threads2,
                     int reverse, int exclusive, void* stream) {
    if (rows <= 0 || L <= 0) return (int)cudaSuccess;
    if (run < 1 || threads < 1 || threads > SCAN_MAX_THREADS || threads2 < 1 ||
        threads2 > SCAN_MAX_THREADS || rows > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    size_t per_block = (size_t)run * threads;
    size_t nblk = ((size_t)L + per_block - 1) / per_block;
    if ((size_t)rows * nblk * per_block >= ((size_t)1 << 31))   // 32-bit slots
        return (int)cudaErrorInvalidValue;
    int run2 = (int)((nblk + threads2 - 1) / threads2);
    size_t sh1 = C::WORDS * sizeof(uint32_t) * threads;
    size_t sh2 = C::WORDS * sizeof(uint32_t) * threads2;
    dim3 grid((unsigned)nblk, (unsigned)rows);
    padd_scan_up_kernel<C><<<grid, threads, sh1, st>>>(
        (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z,
        (uint32_t*)VX, (uint32_t*)VY, (uint32_t*)VZ, (size_t)L, run, reverse);
    int err = (int)cudaGetLastError();
    if (err) return err;
    padd_scan_carry_kernel<C><<<dim3(1, (unsigned)rows), threads2, sh2, st>>>(
        (const uint32_t*)VX, (const uint32_t*)VY, (const uint32_t*)VZ,
        (uint32_t*)CX, (uint32_t*)CY, (uint32_t*)CZ,
        (uint32_t*)SX, (uint32_t*)SY, (uint32_t*)SZ, nblk, (size_t)threads, run2);
    err = (int)cudaGetLastError();
    if (err || OX == nullptr) return err;
    padd_scan_down_kernel<C><<<grid, threads, 0, st>>>(
        (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z,
        (const uint32_t*)VX, (const uint32_t*)VY, (const uint32_t*)VZ,
        (const uint32_t*)CX, (const uint32_t*)CY, (const uint32_t*)CZ,
        (uint32_t*)OX, (uint32_t*)OY, (uint32_t*)OZ, (size_t)L, run, reverse, exclusive);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
