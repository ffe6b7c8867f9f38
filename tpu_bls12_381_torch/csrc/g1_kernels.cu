// Fused G1 group-law kernels: signed mixed add (with a row loop), mixed add,
// add, double, the lane scan of adds, and the GLV ladder.
//
// They take the place of the JAX package's curves/pallas_g1.py kernels
// _pmadd_signed_kernel, _pmadd_kernel, _padd_kernel and _pdbl_kernel, and
// glv_ladder that of _pdbl_kernel and _pmadd_kernel as curves/glv.py's
// scalar_mul_glv runs them (a fori_loop whose body launches one doubling and
// two mixed adds).  One thread owns one lane; the formulas and the lane
// bodies are in g1.cuh.
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
//  * every kernel takes the carry-chain product of field_carry.cuh: two
//    independent mad.lo.cc / madc.hi.cc chains a row instead of one 64-bit
//    multiply-add chain, fewer instructions a product and two streams for
//    the scheduler.
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
//    The passes are lane_scan.cuh's, shared with G2's padd2_scan.
//  * glv_ladder: scalar_mul_glv's loop was some 400 launches (a pdbl and two
//    pmadd a bit) and three selects of torch ops a bit, each writing the
//    accumulator to device memory and reading it back, so on 4096 lanes the
//    host and the launches bound it, not the card.  glv_ladder runs all
//    num_bits steps in one launch with the accumulator in registers: per
//    lane 5 * 24 limbs, the mask byte and the scalars' limbs in, 3 * 24 out,
//    for num_bits * (6M + 2S + 22M).  That is operation-bound at any width;
//    on 4096 lanes (32 blocks for 132 SMs) one thread's chain of dependent
//    products sets the time.  Each select is the mixed add's own
//    pass-through mask (one fp_cmov a coordinate, not a second one after
//    the add).  x, y and beta x are loaded once and held: every build
//    spills at the 255-register cap, and this one least but one and
//    fastest; the build that reads them at each add (from L1 and L2), with
//    the selects apart or not, spills three to four times as much and ran
//    6 to 12% slower on an H100 (curves/sweeps.py --builds; PERF.md).
//    It is constant time: both adds run in every lane at every bit and the
//    selects are masks, with no branch on a scalar bit.  jac_ladder skips the
//    add in a warp where no lane has the bit, which is right for its public
//    scalar (is_in_subgroup's r); here the scalars are per lane and may be
//    secret, and with random per-lane bits a warp of 32 lanes would skip
//    only with probability 2^-32 anyway.
//
// Plain C interface for ctypes: device pointers to int32 limb planes, masks
// as one byte per lane, `stream` a cudaStream_t, return value
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "g1.cuh"
#include "lane_scan.cuh"

#define THREADS 128

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

// The mixed add without the sign (the routed loop of
// curves/glv.py::_glv_steps is its one caller; scalar_mul_glv on the card
// runs glv_ladder instead): 11 Fq products against 5 * 24 limbs read and
// 3 * 24 written, so the integer pipe binds as above.  190 registers, no
// spill.
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

// The joint GLV ladder: num_bits steps of a doubling and two selected mixed
// adds a lane, the accumulator in registers (g1_glv_ladder_lane).  ptxas: 255
// registers and 104 / 92 bytes of spill stores / loads (the builds not kept:
// 72 to 384).
__global__ void __launch_bounds__(THREADS)
glv_ladder_kernel(const uint32_t* __restrict__ k1, const uint32_t* __restrict__ k2,
                  int k2_limbs, const uint32_t* __restrict__ x2,
                  const uint32_t* __restrict__ y2, const uint32_t* __restrict__ phi_x2,
                  const uint8_t* __restrict__ inf2, uint32_t* __restrict__ X3,
                  uint32_t* __restrict__ Y3, uint32_t* __restrict__ Z3, size_t n,
                  int num_bits) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    g1_glv_ladder_lane(k1, k2, k2_limbs, x2, y2, phi_x2, inf2, X3, Y3, Z3, n, idx,
                       num_bits);
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

// k1 * A + k2 * phi(A) lane by lane over the low num_bits bits (1 to 256):
// k1 (16, n) and k2 (k2_limbs, n) limb planes, A = (x2, y2, inf2) and phi(A)'s
// x phi_x2 as (24, n) planes and a mask byte a lane; X3, Y3, Z3 projective.
int g1_glv_ladder(const void* k1, const void* k2, int k2_limbs, const void* x2,
                  const void* y2, const void* phi_x2, const void* inf2,
                  void* X3, void* Y3, void* Z3, long long n, int num_bits,
                  void* stream) {
    if (num_bits < 1 || num_bits > 256 || k2_limbs < 1 || k2_limbs > 16)
        return (int)cudaErrorInvalidValue;
    if (n > 0) {
        glv_ladder_kernel<<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)k1, (const uint32_t*)k2, k2_limbs, (const uint32_t*)x2,
            (const uint32_t*)y2, (const uint32_t*)phi_x2, (const uint8_t*)inf2,
            (uint32_t*)X3, (uint32_t*)Y3, (uint32_t*)Z3, (size_t)n, num_bits);
    }
    return (int)cudaGetLastError();
}

// The lane scan of (24, rows, L) coordinates: lane_scan.cuh's
// padd_scan_launch for G1 (its arguments and scratch are described there).
int g1_padd_scan(const void* X, const void* Y, const void* Z,
                 void* OX, void* OY, void* OZ, void* SX, void* SY, void* SZ,
                 void* VX, void* VY, void* VZ, void* CX, void* CY, void* CZ,
                 long long rows, long long L, int run, int threads, int threads2,
                 int reverse, int exclusive, void* stream) {
    return padd_scan_launch<G1Curve>(X, Y, Z, OX, OY, OZ, SX, SY, SZ, VX, VY, VZ,
                                     CX, CY, CZ, rows, L, run, threads, threads2,
                                     reverse, exclusive, stream);
}

}  // extern "C"
