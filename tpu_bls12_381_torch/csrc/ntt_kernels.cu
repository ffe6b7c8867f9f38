// The fused NTT tile kernel: all log2(m) stages of a size-m radix-2 DIT NTT
// on each row of a (16, B, m) array of Fr elements (rows bit-reversed as the
// ladder hands them over, or in natural order as the columns of the array
// where it lies; natural rows out), then
// optionally times a table `w` (16, Bw, m), row r taking row r mod Bw, then
// optionally times one scalar (16,).
//
// Takes the place of the JAX package's ntt/pallas_ntt.py kernel
// (_ntt_tile_kernel_factory, called from _ntt_tile_call); ntt.cuh says how it
// was thought through again: register radix groups (four values a thread,
// two stages a round, at rows of 2^11; eight, three stages, at 2^12), a
// barrier between rounds, the carry-chain product, the bit reversal folded
// into the load.
// A block holds a slab of 2^11 elements (2^12 for rows of 2^12) in dynamic
// shared memory, 32 bytes an element: 64 KB or 128 KB, above the 48 KB a
// block gets without asking, so the launcher opts in with
// cudaFuncSetAttribute.
//
// What bounds it on an H100: a pass over (16, 2^11, 2^11) with `w` moves
// three elements per element of the array and does 11 / 2 + 1 products on
// each: the multiply-adds take about four times as long as the bytes, so the
// operations bind by that reckoning (PERF.md), and a butterfly's other
// instructions come on top of its multiply-adds (ntt.cuh says what was
// counted).
//
// Plain C interface for ctypes, as field_kernels.cu.

#include <cuda_runtime.h>

#include <stdint.h>

#include "ntt.cuh"

extern __shared__ uint32_t tile_sh[];

// Rows of 2^11: 512 threads of four values, one block an SM by registers;
// rows of 2^12: 512 threads of eight (tile_eb), one block an SM by shared
// memory.  128 registers a thread either way.
template <int SB>
__global__ void __launch_bounds__(ntt_threads(SB, tile_eb(SB)), 1)
ntt_tile_kernel(TileArgs a) {
    constexpr int EB = tile_eb(SB);
    size_t row0 = (size_t)blockIdx.x << (SB - a.log_m);
    tile_round_first<EB>(a, row0, threadIdx.x, tile_sh);
    for (int s0 = EB; s0 < a.log_m; s0 += EB) {
        __syncthreads();
        tile_round<EB>(a, row0, threadIdx.x, s0, tile_sh);
    }
}

template <int SB>
static int launch_tile(const TileArgs& a, void* stream) {
    size_t bytes = ((size_t)1 << SB) * NTT_ELEM_BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        ntt_tile_kernel<SB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    size_t per = tile_rows_per_block(a.log_m);
    unsigned blocks = (unsigned)((a.rows + per - 1) / per);
    ntt_tile_kernel<SB><<<blocks, ntt_threads(SB, tile_eb(SB)), bytes,
                          (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

template <int SB>
static int tile_blocks_per_sm() {
    int blocks = -1;
    size_t bytes = ((size_t)1 << SB) * NTT_ELEM_BYTES;
    cudaFuncSetAttribute(ntt_tile_kernel<SB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ntt_tile_kernel<SB>,
                                                  ntt_threads(SB, tile_eb(SB)), bytes);
    return blocks;
}

extern "C" {

// x, out: (16, rows, 2^log_m); tw: (16, 2^(log_m-1)); w: (16, w_rows, 2^log_m)
// or null; scale: (16,) or null.  1 <= log_m <= 12 (the caller checks the
// row against the device's shared memory).  cols_log -1: x's rows, in
// bit-reversed order; cols_log >= 0: x is (16, B, 2^log_m, 2^cols_log) and
// row b 2^cols_log + j is its column j of block b in natural order, or
// column brev(j) with brev_cols.
int fr_ntt_tile(const void* x, const void* tw, const void* w, const void* scale,
                void* out, long long rows, long long w_rows, int log_m,
                int cols_log, int brev_cols, void* stream) {
    if (rows <= 0) return (int)cudaGetLastError();
    if (log_m < 1 || log_m > NTT_SLAB_BITS + 1) return (int)cudaErrorInvalidValue;
    TileArgs a;
    a.x = (const uint32_t*)x;
    a.tw = (const uint32_t*)tw;
    a.w = (const uint32_t*)w;
    a.scale = (const uint32_t*)scale;
    a.out = (uint32_t*)out;
    a.rows = (size_t)rows;
    a.w_rows = (size_t)w_rows;
    a.log_m = log_m;
    a.sb = tile_slab_bits(log_m);
    a.vec_in = ((uintptr_t)x % 16) == 0;
    a.cols_log = cols_log;
    a.brev_cols = brev_cols;
    if (cols_log >= 0 && rows % ((long long)1 << cols_log)) return (int)cudaErrorInvalidValue;
    return a.sb == NTT_SLAB_BITS ? launch_tile<NTT_SLAB_BITS>(a, stream)
                                 : launch_tile<NTT_SLAB_BITS + 1>(a, stream);
}

// Blocks of the tile kernel an SM holds at once for rows of 2^log_m (the
// occupancy calculator's answer, for chip_smoke.py), or -1.
int fr_ntt_tile_blocks_per_sm(int log_m) {
    return tile_slab_bits(log_m) == NTT_SLAB_BITS ? tile_blocks_per_sm<NTT_SLAB_BITS>()
                                                  : tile_blocks_per_sm<NTT_SLAB_BITS + 1>();
}

}  // extern "C"
