// The fused NTT tile kernel: all log2(m) stages of a size-m radix-2 DIT NTT
// on each row of a (16, B, m) array of Fr elements (bit-reversed rows in,
// natural rows out), then optionally times a table `w` (16, Bw, m), row r
// taking row r mod Bw, then optionally times one scalar (16,).
//
// Takes the place of the JAX package's ntt/pallas_ntt.py kernel
// (_ntt_tile_kernel_factory, called from _ntt_tile_call); ntt.cuh says how it
// was thought through again.  A block of TILE_THREADS threads holds its rows
// in dynamic shared memory, 32 bytes an element: 64 KB for a row of 2^11,
// 128 KB for 2^12, which is above the 48 KB a block gets without asking, so
// the launcher opts in with cudaFuncSetAttribute.
//
// What bounds it on an H100: a pass over (16, 2^11, 2^11) with `w` moves
// three elements per element of the array and does 11 / 2 + 1 products on
// each: the multiply-adds take about four times as long as the bytes, so the
// integer pipe binds (PERF.md has the reckoning).  Not tuned: stage 1
// multiplies by w^0 = 1 like every other stage, and at half < 32 the pairs of
// a warp fall two to a bank.
//
// Plain C interface for ctypes, as field_kernels.cu.

#include <cuda_runtime.h>

#include "ntt.cuh"

extern __shared__ uint32_t tile_sh[];

__global__ void __launch_bounds__(TILE_THREADS)
ntt_tile_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ w, const uint32_t* __restrict__ scale,
                uint32_t* __restrict__ out, size_t total, size_t w_rows,
                int log_m, uint32_t cap) {
    size_t base = (size_t)blockIdx.x * cap;
    for (uint32_t e = threadIdx.x; e < cap; e += TILE_THREADS)
        tile_load(x, total, base, tile_sh, cap, e);
    __syncthreads();
    // Every pair of a stage is read and written by one thread only, so a
    // stage runs in place; the barrier stands between stages.
    for (int s = 1; s <= log_m; ++s) {
        for (uint32_t q = threadIdx.x; q < cap / 2; q += TILE_THREADS)
            tile_butterfly(tile_sh, cap, tw, log_m, s, q);
        __syncthreads();
    }
    fr sc;
    if (scale != nullptr) sc = fp_load<Fr>(scale, 1, 0);
    for (uint32_t e = threadIdx.x; e < cap; e += TILE_THREADS)
        tile_store(tile_sh, cap, e, base, total, log_m, w, w_rows,
                   scale != nullptr ? &sc : nullptr, out);
}

extern "C" {

// x, out: (16, rows, 2^log_m); tw: (16, 2^(log_m-1)); w: (16, w_rows, 2^log_m)
// or null; scale: (16,) or null.  1 <= log_m, and a row must fit a block's
// shared memory (the caller checks that against the device's limit).
int fr_ntt_tile(const void* x, const void* tw, const void* w, const void* scale,
                void* out, long long rows, long long w_rows, int log_m,
                void* stream) {
    if (rows <= 0) return (int)cudaGetLastError();
    uint32_t cap = tile_rows_per_block(log_m) << log_m;
    size_t bytes = (size_t)cap * TILE_ELEM_BYTES;
    if (bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            ntt_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    size_t total = (size_t)rows << log_m;
    unsigned blocks = (unsigned)((total + cap - 1) / cap);
    ntt_tile_kernel<<<blocks, TILE_THREADS, bytes, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)tw, (const uint32_t*)w,
        (const uint32_t*)scale, (uint32_t*)out, total, (size_t)w_rows, log_m, cap);
    return (int)cudaGetLastError();
}

}  // extern "C"
