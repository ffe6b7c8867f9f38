// The lane scan of G2 additions: padd2_scan.
//
// The G2 MSM tail's lane scans (the stitch, the triangle's sums), which the
// JAX package runs as log2(L) Hillis-Steele steps of curves/pallas_g2.py's
// _padd2_kernel (g2_padd.cu's padd2 here).  It is lane_scan.cuh's
// reduce-then-scan on G2 points (G2Curve in g2.cuh), as g1_kernels.cu's
// padd_scan is on G1 points: a thread folds a run of lanes in registers, a
// block scans its run totals in shared memory (72 planes of T words: 36 KB
// at T = 128, under the 48 KB a launch takes without opting in), one small
// pass scans the block totals, a last pass walks the runs again: 3 launches
// (2 for a total) where the Hillis-Steele steps launched log2(L) additions
// and their rolls and selects.  On few lanes it is bound by the depth of
// dependent adds, a G2 add (36 Fq products on the carry-chain product) about
// three times a G1 one.
//
// Plain C interface for ctypes, as g2_padd.cu's; a source of its own so that
// it compiles beside the other G2 sources.

#include <cuda_runtime.h>

#include "g2.cuh"
#include "lane_scan.cuh"

extern "C" {

// The lane scan of (24, 2, rows, L) coordinates: lane_scan.cuh's
// padd_scan_launch for G2, with g1_padd_scan's arguments (scratch V
// (24, 2, rows, nblk*threads) and C (24, 2, rows, nblk)).
int g2_padd_scan(const void* X, const void* Y, const void* Z,
                 void* OX, void* OY, void* OZ, void* SX, void* SY, void* SZ,
                 void* VX, void* VY, void* VZ, void* CX, void* CY, void* CZ,
                 long long rows, long long L, int run, int threads, int threads2,
                 int reverse, int exclusive, void* stream) {
    return padd_scan_launch<G2Curve>(X, Y, Z, OX, OY, OZ, SX, SY, SZ, VX, VY, VZ,
                                     CX, CY, CZ, rows, L, run, threads, threads2,
                                     reverse, exclusive, stream);
}

}  // extern "C"
