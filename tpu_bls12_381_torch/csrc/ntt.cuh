// The fused NTT tile: every stage of a size-m radix-2 DIT NTT on the rows of
// a (16, B, m) array of Fr elements, in shared memory.
//
// It takes the place of the JAX package's ntt/pallas_ntt.py tile kernel
// (_ntt_tile_kernel_factory / _ntt_tile_call), thought through again for a
// GPU block.  The TPU kernel pairs lanes by rolls and masked selects over a
// prepacked (stages, 16, m) twiddle table, because its compiler cannot index;
// a GPU thread can, so here
//
//  * a block owns `tile_rows_per_block` whole rows.  Rows lie one after the
//    other in every limb plane, so the block's elements are one contiguous
//    run of each plane and its loads and stores coalesce as they are;
//  * an element is packed into 8 words of 32 bits and kept in shared memory
//    word-major (word w of element e at sh[w * cap + e]), so the threads of a
//    warp, on neighbouring elements, fall on neighbouring banks;
//  * at stage s a thread takes pairs (i0, i0 + half), half = 2^(s-1), and
//    reads the twiddle w_m^(j * m / 2^s) straight from the domain's (16, m/2)
//    table by stride: no per-stage table is packed;
//  * after the last stage an element is multiplied by its entry of the
//    optional table `w` (row r takes row r mod w_rows: a table of one period
//    serves a batch) and by the optional scalar, and stored in natural order.
//
// Rows come in bit-reversed, as the ladder's do.  The functions below are
// what one thread does for one element or one pair; they compile as plain
// C++ too, and host_check.cpp runs them in serial loops.

#pragma once

#include "field.cuh"

#ifdef __CUDACC__
#define HOSTDEV __host__ __device__ __forceinline__
#else
#define HOSTDEV inline
#endif

#define TILE_THREADS 256
#define TILE_ELEM_BYTES 32   // one Fr element in shared memory

typedef El<Fr> fr;

// Whole rows a block holds: enough short rows to give every thread a pair
// (2 * TILE_THREADS elements), one row from there on.
HOSTDEV uint32_t tile_rows_per_block(int log_m) {
    uint32_t r = (uint32_t)(2 * TILE_THREADS) >> log_m;
    return r > 0u ? r : 1u;
}

DEV fr tile_get(const uint32_t* sh, uint32_t cap, uint32_t e) {
    fr r;
    UNROLL
    for (int j = 0; j < Fr::W; ++j) r.v[j] = sh[(uint32_t)j * cap + e];
    return r;
}

DEV void tile_put(uint32_t* sh, uint32_t cap, uint32_t e, const fr& a) {
    UNROLL
    for (int j = 0; j < Fr::W; ++j) sh[(uint32_t)j * cap + e] = a.v[j];
}

// Element e of the block that starts at element `base` of the (16, total)
// planes -> shared memory; past the end of the array, zero.
DEV void tile_load(const uint32_t* x, size_t total, size_t base, uint32_t* sh,
                   uint32_t cap, uint32_t e) {
    size_t idx = base + e;
    tile_put(sh, cap, e, idx < total ? fp_load<Fr>(x, total, idx) : fp_zero<Fr>());
}

// Pair q of the block at stage s (1 .. log_m).  q counts the block's pairs
// row by row, m/2 to a row.  Within the row, pair = g * half + j joins
// elements g * 2 * half + j and that plus half, with twiddle
// w_m^(j * m / 2^s) = tw[j << (log_m - s)].
DEV void tile_butterfly(uint32_t* sh, uint32_t cap, const uint32_t* tw,
                        int log_m, int s, uint32_t q) {
    uint32_t pairs = 1u << (log_m - 1);
    uint32_t row = q >> (log_m - 1), pair = q & (pairs - 1u);
    uint32_t half = 1u << (s - 1);
    uint32_t j = pair & (half - 1u);
    uint32_t i0 = (row << log_m) + ((pair - j) << 1) + j;
    fr h, l;
    fp_butterfly<Fr>(tile_get(sh, cap, i0), tile_get(sh, cap, i0 + half),
                     fp_load<Fr>(tw, pairs, (size_t)j << (log_m - s)), h, l);
    tile_put(sh, cap, i0, h);
    tile_put(sh, cap, i0 + half, l);
}

// Element e of the block -> out, times its entry of `w` (may be null; w has
// w_rows rows of m, and row r of the array takes row r mod w_rows) and times
// *scale (may be null).
DEV void tile_store(const uint32_t* sh, uint32_t cap, uint32_t e, size_t base,
                    size_t total, int log_m, const uint32_t* w, size_t w_rows,
                    const fr* scale, uint32_t* out) {
    size_t idx = base + e;
    if (idx >= total) return;
    fr v = tile_get(sh, cap, e);
    if (w != nullptr) {
        size_t row = idx >> log_m, col = idx & (((size_t)1 << log_m) - 1);
        v = fp_mul<Fr>(v, fp_load<Fr>(w, w_rows << log_m,
                                      ((row % w_rows) << log_m) + col));
    }
    if (scale != nullptr) v = fp_mul<Fr>(v, *scale);
    fp_store<Fr>(out, total, idx, v);
}
