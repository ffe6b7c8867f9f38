// Fused G1 group-law kernels: signed mixed add (with a row loop), mixed add,
// add, double, and the lane scan of adds.
//
// They take the place of the JAX package's curves/pallas_g1.py kernels
// _pmadd_signed_kernel, _pmadd_kernel, _padd_kernel and _pdbl_kernel.  One
// thread owns one lane (one point operation); the formulas are in g1.cuh.
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
// reckoning is in PERF.md).  What the design does about it:
//  * pmadd_signed, padd, padd_scan and pdbl take the carry-chain product of
//    field_carry.cuh: two independent mad.lo.cc / madc.hi.cc chains a row
//    instead of one 64-bit multiply-add chain, fewer instructions a product
//    and two streams for the scheduler.  pmadd keeps field.cuh's.
//  * Occupancy: a thread walks R dependent adds, so the card needs enough
//    warps in flight to hide the chain's latency.  At one 128-thread block an
//    SM (2^14 lanes on 132 SMs) each scheduler had one warp; the MSM's G1
//    tile is now 2^15 lanes (tuning.py: msm_g1_lane_tile_log_min), two
//    blocks an SM at 248 registers.  Three blocks an SM, and loading row
//    r + 1 during row r, spill and were not kept (PERF.md has their times).
//  * padd runs two blocks an SM (212 registers, no spill).
//  * pdbl carries a count `times`, as pmadd_signed carries R: every caller
//    doubles a point many times in a row (the MSM's triangle combine and
//    Horner ladder, 7 or 15 times on one lane; expand_bases, 48 to 80 times
//    on 2^20 lanes), which the JAX package runs as a fori_loop of launches.
//    Here the thread loads its lane once, doubles `times` times in
//    registers and stores once: one launch a chain, 6 * 24 limbs moved for
//    times * (6M + 2S).
//  * padd_scan replaces the log2(L) Hillis-Steele steps of the MSM's tail
//    (each a padd over all L lanes plus rolls and selects) with a
//    reduce-then-scan: a thread folds a run of lanes in registers, a block
//    scans its run totals in shared memory, one small pass scans the block
//    totals, and a last pass walks the runs again from their carries: about
//    2L + (L/run) log2(T) adds in 3 launches (2 for a total), whatever L is.
//    On few lanes it is bound by the depth of dependent adds, not the pipe.
//
// Plain C interface for ctypes: device pointers to int32 limb planes, masks
// as one byte per lane, `stream` a cudaStream_t, return value
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "g1.cuh"

#define THREADS 128
// The lane scan's most threads a block (3 * 12 words a point of shared
// memory each: 18 KB at 128).
#define SCAN_MAX_THREADS 128

// One thread per lane; the lane bodies (and the meaning of the arguments) are
// in g1.cuh.  Built for one block an SM, ptxas takes 248 registers (two
// blocks still fit); a build at 181 registers measured 9% slower (PERF.md).
__global__ void __launch_bounds__(THREADS, 1)
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

// Two blocks an SM: 212 registers and no spill.  More blocks (a cap of 168
// or 128 registers) spill and measured slower (PERF.md).
__global__ void __launch_bounds__(THREADS, 2)
padd_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
            const uint32_t* __restrict__ Z1, const uint32_t* __restrict__ X2,
            const uint32_t* __restrict__ Y2, const uint32_t* __restrict__ Z2,
            uint32_t* __restrict__ X3, uint32_t* __restrict__ Y3,
            uint32_t* __restrict__ Z3, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_padd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, idx);
}

// The doubling chain, built for three blocks an SM: 168 registers, no spill.
// Builds for at least one and two blocks an SM (165 registers each) ran
// 2.5 to 3.6% slower at the upload's shape on an H100 (PERF.md).
__global__ void __launch_bounds__(THREADS, 3)
pdbl_kernel(const uint32_t* __restrict__ X1, const uint32_t* __restrict__ Y1,
            const uint32_t* __restrict__ Z1, uint32_t* __restrict__ X3,
            uint32_t* __restrict__ Y3, uint32_t* __restrict__ Z3, size_t n,
            int times) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, idx, times);
}

// ---------------------------------------------------------------------------
// padd_scan: the three passes of g1.cuh's lane scan.  A block's run totals
// are scanned in shared memory by Hillis-Steele steps (log2 T of them), held
// as 36 planes of T words so that the threads of a warp touch neighbouring
// banks.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void sh_put(uint32_t* sh, unsigned T, unsigned t,
                                       const G1Proj& P) {
    for (int w = 0; w < 12; ++w) {
        sh[w * T + t] = P.X.v[w];
        sh[(12 + w) * T + t] = P.Y.v[w];
        sh[(24 + w) * T + t] = P.Z.v[w];
    }
}

__device__ __forceinline__ G1Proj sh_get(const uint32_t* sh, unsigned T, unsigned t) {
    G1Proj P;
    for (int w = 0; w < 12; ++w) {
        P.X.v[w] = sh[w * T + t];
        P.Y.v[w] = sh[(12 + w) * T + t];
        P.Z.v[w] = sh[(24 + w) * T + t];
    }
    return P;
}

// Inclusive scan of the block's values v (one a thread); sh holds the
// inclusive sums on return.  Both operands of a step's add are read from
// sh, so no point stays in registers across the barriers.
__device__ G1Proj block_scan(uint32_t* sh, const G1Proj& v) {
    const unsigned T = blockDim.x, t = threadIdx.x;
    sh_put(sh, T, t, v);
    __syncthreads();
    ROLLED
    for (unsigned s = 1; s < T; s <<= 1) {
        G1Proj sum;
        if (t >= s) sum = g1_proj_add(sh_get(sh, T, t - s), sh_get(sh, T, t));
        __syncthreads();
        if (t >= s) sh_put(sh, T, t, sum);
        __syncthreads();
    }
    return sh_get(sh, T, t);
}

// grid (nblk, rows), block T: the run totals' inclusive block scan into V.
__global__ void __launch_bounds__(SCAN_MAX_THREADS)
padd_scan_up_kernel(const uint32_t* __restrict__ X, const uint32_t* __restrict__ Y,
                    const uint32_t* __restrict__ Z, uint32_t* __restrict__ VX,
                    uint32_t* __restrict__ VY, uint32_t* __restrict__ VZ, size_t L,
                    int run, int reverse) {
    extern __shared__ uint32_t sh[];
    const size_t T = blockDim.x, t = threadIdx.x, k = blockIdx.x, b = blockIdx.y;
    const size_t rows = gridDim.y, nblk = gridDim.x;
    G1Proj v = block_scan(
        sh, g1_scan_fold_lanes(X, Y, Z, (uint32_t)L, (uint32_t)rows, (uint32_t)b,
                               (uint32_t)((k * T + t) * run), (uint32_t)run, reverse != 0));
    g1_store(VX, VY, VZ, rows * nblk * T, (b * nblk + k) * T + t, v);
}

// grid (1, rows), block T2: the block totals' exclusive carries into C and,
// where SX is given, each row's total into S (rows).
__global__ void __launch_bounds__(SCAN_MAX_THREADS)
padd_scan_carry_kernel(const uint32_t* __restrict__ VX, const uint32_t* __restrict__ VY,
                       const uint32_t* __restrict__ VZ, uint32_t* __restrict__ CX,
                       uint32_t* __restrict__ CY, uint32_t* __restrict__ CZ,
                       uint32_t* __restrict__ SX, uint32_t* __restrict__ SY,
                       uint32_t* __restrict__ SZ, size_t nblk, size_t T1, int run2) {
    extern __shared__ uint32_t sh[];
    const size_t t = threadIdx.x, b = blockIdx.y, rows = gridDim.y;
    G1Proj w = block_scan(sh, g1_scan_fold_totals(VX, VY, VZ, (uint32_t)rows,
                                                  (uint32_t)nblk, (uint32_t)T1,
                                                  (uint32_t)b, (uint32_t)(t * run2),
                                                  (uint32_t)run2));
    if (SX != nullptr && t == blockDim.x - 1) g1_store(SX, SY, SZ, rows, b, w);
    G1Proj acc = t > 0 ? sh_get(sh, blockDim.x, t - 1) : g1_identity();
    g1_scan_carry_walk(acc, VX, VY, VZ, CX, CY, CZ, rows, nblk, T1, b, t * run2, run2);
}

// grid (nblk, rows), block T: every lane from its thread's carry-in.
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
    G1Proj acc = g1_scan_carry_in(VX, VY, VZ, CX, CY, CZ, rows, nblk, T, b, k, t);
    g1_scan_walk(acc, X, Y, Z, OX, OY, OZ, L, rows * L, b, (k * T + t) * run, run,
                 reverse != 0, exclusive != 0);
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

// `times` doublings of every lane (times >= 1).
int g1_pdbl(const void* X1, const void* Y1, const void* Z1,
            void* X3, void* Y3, void* Z3, long long n, int times, void* stream) {
    if (times < 1) return (int)cudaErrorInvalidValue;
    if (n > 0) {
        pdbl_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)X1, (const uint32_t*)Y1, (const uint32_t*)Z1,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n, times);
    }
    return (int)cudaGetLastError();
}

// The lane scan of (24, rows, L) coordinates X, Y, Z.  Scan mode: writes
// OX, OY, OZ (same shape), 3 launches.  Total mode (OX null): writes the
// row totals SX, SY, SZ (24, rows), 2 launches.  Scratch: V (24, rows,
// nblk*threads) and C (24, rows, nblk), nblk = ceil(L / (run * threads));
// threads and threads2 (the carry pass's) are powers of two up to
// SCAN_MAX_THREADS, run2 = ceil(nblk / threads2).
int g1_padd_scan(const void* X, const void* Y, const void* Z,
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
    size_t sh1 = 36 * sizeof(uint32_t) * threads, sh2 = 36 * sizeof(uint32_t) * threads2;
    dim3 grid((unsigned)nblk, (unsigned)rows);
    padd_scan_up_kernel<<<grid, threads, sh1, st>>>(
        (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z,
        (uint32_t*)VX, (uint32_t*)VY, (uint32_t*)VZ, (size_t)L, run, reverse);
    int err = (int)cudaGetLastError();
    if (err) return err;
    padd_scan_carry_kernel<<<dim3(1, (unsigned)rows), threads2, sh2, st>>>(
        (const uint32_t*)VX, (const uint32_t*)VY, (const uint32_t*)VZ,
        (uint32_t*)CX, (uint32_t*)CY, (uint32_t*)CZ,
        (uint32_t*)SX, (uint32_t*)SY, (uint32_t*)SZ, nblk, (size_t)threads, run2);
    err = (int)cudaGetLastError();
    if (err || OX == nullptr) return err;
    padd_scan_down_kernel<<<grid, threads, 0, st>>>(
        (const uint32_t*)X, (const uint32_t*)Y, (const uint32_t*)Z,
        (const uint32_t*)VX, (const uint32_t*)VY, (const uint32_t*)VZ,
        (const uint32_t*)CX, (const uint32_t*)CY, (const uint32_t*)CZ,
        (uint32_t*)OX, (uint32_t*)OY, (uint32_t*)OZ, (size_t)L, run, reverse, exclusive);
    return (int)cudaGetLastError();
}

}  // extern "C"
