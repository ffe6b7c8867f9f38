// The NTT's device code: register radix groups over a block's slab of Fr
// elements, for the fused tile (ntt_kernels.cu) and the ladder's high stages
// (ntt_stages.cu).
//
// Both take the place of TPU kernels thought through again for an H100: the
// tile of the JAX package's ntt/pallas_ntt.py (_ntt_tile_kernel_factory /
// _ntt_tile_call), which pairs lanes by rolls and masked selects over a
// prepacked (stages, 16, m) twiddle table because its compiler cannot index,
// and the butterfly of fields/pallas_ops.py (_build_butterfly_kernel), which
// the JAX ladder calls once a stage.  Here:
//
//  * a block of threads owns a slab of 2^sb elements (sb = 11, or 12 for the
//    tile's rows of 2^12); each thread holds 2^EB of them in registers and
//    runs up to EB radix-2 stages on them (a round) with no exchange, then
//    the block exchanges them through shared memory behind one barrier.  EB
//    is 2 (512 threads of at most 128 registers, 16 warps an SM) for slabs
//    of 2^11, and 3 for 2^12, where four values a thread would mean 1,024
//    threads of 64 registers (ntt/sweeps.py times the builds not kept;
//    PERF.md).
//    A size-2^11 NTT is then 6 rounds and 5 exchanges, where it was 11
//    shared-memory stages with a barrier each;
//  * in a round, the element bits of the slab position (EB neighbouring bits
//    [e0, e0 + EB)) index the thread's values; the round's stages are some
//    of those bits, the others independent pairs.  The 32 lanes of a warp
//    take 5 neighbouring bits that are not element bits, and the warp's index
//    the rest (ntt_round_q0);
//  * shared memory holds an element as 8 words, word-major, at a position
//    XOR-swizzled in its low 5 bits by the bits above (ntt_swz): bit i of a
//    position lands in bank bit i mod 5, so every 5 neighbouring position
//    bits a warp spans hit 32 different banks;
//  * a stage multiplies with the carry-chain product (field_carry.cuh) and,
//    four values a thread, adds and subtracts on the carry flag too; the
//    tile's first round knows its twiddles (w_(2^EB) powers) and skips the
//    product by w^0 = 1; every other twiddle is read from device memory once
//    for the pairs that share it, not once a pair a stage.
//
// On an H100 a butterfly is 432 SASS instructions (368 of them the
// product's, 40 the sum and difference), and the card runs 4.2e10
// butterflies a second on registers alone (ntt/sweeps.py's butterfly_sass
// line): 0.050 ms a stage at 2^22.  The kernels read 1.5 to 2.5 times that;
// the loads and stores, the exchanges, the twiddles, the addresses and the
// stages kernel's spills take the rest (PERF.md, PR 11).
//
// The functions below are what one thread does in one round; they compile as
// plain C++ too, and host_check.cpp runs them thread by thread, round by
// round (a round's threads touch disjoint positions, so that order is the
// block's).

#pragma once

#include "field_carry.cuh"

#ifdef __CUDACC__
#define HOSTDEV __host__ __device__ __forceinline__
#else
#define HOSTDEV inline
#endif

#define NTT_SLAB_BITS 11     // a block's slab: 2^11 elements
#define NTT_ELEM_BYTES 32    // one Fr element in shared memory
#define NTT_MAX_STAGES 6     // stages of one butterfly_stages launch
#define NTT_STAGES_EB 2      // element bits of the stages kernel's rounds

// Element bits of the tile's rounds for a slab of 2^sb, and threads a block.
HOSTDEV constexpr int tile_eb(int sb) { return sb == NTT_SLAB_BITS ? 2 : 3; }
HOSTDEV constexpr int ntt_threads(int sb, int eb) { return 1 << (sb - eb); }

typedef El<Fr> fr;

// ---------------------------------------------------------------------------
// Bits
// ---------------------------------------------------------------------------

// The low `bits` bits of v in reverse order.
HOSTDEV uint32_t ntt_brev(uint32_t v, int bits) {
    if (bits <= 0) return 0u;
#ifdef __CUDA_ARCH__
    return __brev(v) >> (32 - bits);
#else
    uint32_t r = 0u;
    for (int i = 0; i < bits; ++i) r |= ((v >> i) & 1u) << (bits - 1 - i);
    return r;
#endif
}

// The low bits of v placed on the set bits of mask, lowest first.
HOSTDEV uint32_t ntt_deposit(uint32_t v, uint32_t mask) {
    uint32_t r = 0u;
    for (uint32_t b = 1u; mask != 0u; b <<= 1) {
        uint32_t low = mask & (0u - mask);
        if (v & b) r |= low;
        mask ^= low;
    }
    return r;
}

// Shared-memory position of slab position q: bit i of q goes to bank bit
// i mod 5 (slabs of at most 2^15).
HOSTDEV uint32_t ntt_swz(uint32_t q) { return q ^ (((q >> 5) ^ (q >> 10)) & 31u); }

// The lanes' slab bits in a round whose elements take bits [e0, e0 + eb) of
// a slab of 2^sb (sb >= 5 + eb): bits 0..4 where they are free, else the 5
// bits right above the element bits, else the lowest 5 free bits (then two
// lanes may share a bank, as the stages kernel's lanes may for a half below
// 32, which the ladder never gives it).
HOSTDEV uint32_t ntt_lane_mask(int e0, int sb, int eb) {
    if (e0 >= 5) return 31u;
    if (e0 + eb + 5 <= sb) return 31u << (e0 + eb);
    uint32_t free_bits = ((1u << sb) - 1u) & ~(((1u << eb) - 1u) << e0), m = 0u;
    for (int i = 0; i < 5; ++i) {
        uint32_t low = free_bits & (0u - free_bits);
        m |= low;
        free_bits ^= low;
    }
    return m;
}

// Slab position of thread t's value 0 in such a round; value k sits at
// q0 | k << e0.
HOSTDEV uint32_t ntt_round_q0(uint32_t t, int e0, int sb, int eb) {
    uint32_t lanes = ntt_lane_mask(e0, sb, eb);
    uint32_t rest = ((1u << sb) - 1u) & ~(((1u << eb) - 1u) << e0) & ~lanes;
    return ntt_deposit(t & 31u, lanes) | ntt_deposit(t >> 5, rest);
}

// ---------------------------------------------------------------------------
// Registers and shared memory
// ---------------------------------------------------------------------------

// (a, b) <- (a + w b, a - w b), and the same with w = 1.  CC: the sum and
// difference on the carry flag (fr_add_cc, fr_sub_cc), else field.cuh's; the
// rounds of four values take the first, those of eight the second, where the
// first spills (ntt/sweeps.py; PERF.md, PR 11).
template <bool CC>
DEV void ntt_bf(fr& a, fr& b, const fr& w) {
    fr t = fp_mul_cc<Fr>(b, w);
    b = CC ? fr_sub_cc(a, t) : fp_sub<Fr>(a, t);
    a = CC ? fr_add_cc(a, t) : fp_add<Fr>(a, t);
}

template <bool CC>
DEV void ntt_bf1(fr& a, fr& b) {
    fr t = b;
    b = CC ? fr_sub_cc(a, t) : fp_sub<Fr>(a, t);
    a = CC ? fr_add_cc(a, t) : fp_add<Fr>(a, t);
}

DEV fr ntt_sh_get(const uint32_t* sh, uint32_t cap, uint32_t q) {
    uint32_t s = ntt_swz(q);
    fr r;
    UNROLL
    for (int j = 0; j < Fr::W; ++j) r.v[j] = sh[(uint32_t)j * cap + s];
    return r;
}

DEV void ntt_sh_put(uint32_t* sh, uint32_t cap, uint32_t q, const fr& a) {
    uint32_t s = ntt_swz(q);
    UNROLL
    for (int j = 0; j < Fr::W; ++j) sh[(uint32_t)j * cap + s] = a.v[j];
}

// One round's stages on v[0 .. 2^EB - 1], v[k] at slab position q0 | k <<
// e0.  The stage of element bit b (blo <= b < bhi, lowest first) joins v[k]
// and v[k | 1 << b] for every k without bit b, with the twiddle tw_at(b, q)
// of the pair whose lower value sits at q.  The 2^b pairs' twiddles that
// differ (by k's bits below b) are each read once and serve the pairs that
// share them.  FIRST: the tile's first round (e0 = 0, q0 % 2^EB == 0),
// where the twiddle of k mod 2^b = 0 is w^0 = 1 and takes no product.
template <int EB, bool FIRST, class TwAt>
DEV void ntt_round(fr* v, uint32_t q0, int e0, int blo, int bhi, const TwAt& tw_at) {
    UNROLL
    for (int b = 0; b < EB; ++b) {
        if (b < blo || b >= bhi) continue;
        UNROLL
        for (int kl = 0; kl < (1 << b); ++kl) {
            if (FIRST && kl == 0) {
                UNROLL
                for (int kh = 0; kh < ((1 << (EB - 1)) >> b); ++kh) {
                    int k = kl + (kh << (b + 1));
                    ntt_bf1<EB == 2>(v[k], v[k + (1 << b)]);
                }
            } else {
                fr w = tw_at(b, q0 | ((uint32_t)kl << e0));
                UNROLL
                for (int kh = 0; kh < ((1 << (EB - 1)) >> b); ++kh) {
                    int k = kl + (kh << (b + 1));
                    ntt_bf<EB == 2>(v[k], v[k + (1 << b)], w);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The tile: every stage of a size-m radix-2 DIT NTT on the rows of (16, B, m)
// ---------------------------------------------------------------------------
//
// A block's slab is 2^sb elements, sb = max(11, log_m): whole rows, one after
// the other, so slab position q is (row in block, position in row).  Round
// 1 (stages 1 .. EB) reads x straight into registers.  Rows come in
// bit-reversed (the ladder's RN and RR orderings) as x's rows: thread t
// takes positions 2^EB t onwards, one 16-byte run (32 at EB = 3) of each
// limb plane.  Or they come in natural order as the columns of x seen as
// (B, m, C) blocks (C = 1: x's rows): thread t of a row takes elements
// t + k' m/2^EB, which the DIT's bit-reversed order puts at positions
// 2^EB brev(t) + brev(k'), so element e lands at brev(e) as it loads; each
// lane then reads a column apart, and neighbouring blocks neighbouring
// columns.  The four-step's transposes (C = the other factor) and the NN
// ladder's bit reversal (the columns in bit-reversed order, which the store
// applies: tile_out_row) fold into this load; chip_smoke.py found it faster
// than the copy it replaces (PERF.md, PR 11).  Rounds at s0 = EB, 2 EB, ...
// take stages s0 + 1 .. s0 + EB through shared memory; the last one writes
// natural rows out, times the row's entry of `w` and the scalar where given.

struct TileArgs {
    const uint32_t* x;     // (16, rows, m)
    const uint32_t* tw;    // (16, m/2): w_m^0 .. w_m^(m/2 - 1)
    const uint32_t* w;     // (16, w_rows, m) or null: row r takes row r % w_rows
    const uint32_t* scale; // (16,) or null
    uint32_t* out;         // (16, rows, m)
    size_t rows, w_rows;
    int log_m, sb;
    int vec_in;            // bit-reversed rows may be read 16 bytes at a time
    int cols_log;          // -1: x's rows, bit-reversed; else x is (16, B, m,
                           // 2^cols_log) and row b 2^cols_log + j is its column j
                           // of block b, in natural order
    int brev_cols;         // with cols_log: row b 2^cols_log + j is column brev(j)
};

// The output row of the tile's row i (the i-th the blocks take, in order):
// with brev_cols, block rows run down the columns (i = b 2^cols_log + j
// reads column j, so neighbouring blocks read neighbouring columns and
// share their sectors) and column j lands in row b 2^cols_log + brev(j).
HOSTDEV size_t tile_out_row(const TileArgs& a, size_t i) {
    if (a.cols_log < 0 || !a.brev_cols) return i;
    size_t mask = ((size_t)1 << a.cols_log) - 1;
    return (i & ~mask) | ntt_brev((uint32_t)(i & mask), a.cols_log);
}

// Thread t's value 0 in round 1 (value k at q0 + k).
HOSTDEV uint32_t tile_first_q0(uint32_t t, int log_m, int natural_in, int eb) {
    if (natural_in && log_m >= eb) {
        int lq = log_m - eb;
        uint32_t in_row = t & ((1u << lq) - 1u);
        return ((t >> lq) << log_m) | (ntt_brev(in_row, lq) << eb);
    }
    return t << eb;
}

// Element of x at slab position q of the block starting at row row0 (zero
// past the last row).
DEV fr tile_fetch(const TileArgs& a, size_t row0, uint32_t q) {
    size_t row = row0 + (q >> a.log_m);
    if (row >= a.rows) return fp_zero<Fr>();
    uint32_t p = q & ((1u << a.log_m) - 1u);
    size_t total = a.rows << a.log_m;
    if (a.cols_log < 0) return fp_load<Fr>(a.x, total, (row << a.log_m) + p);
    size_t j = row & (((size_t)1 << a.cols_log) - 1);
    size_t e = ntt_brev(p, a.log_m);
    return fp_load<Fr>(a.x, total, ((row >> a.cols_log) << (a.log_m + a.cols_log)) +
                                       (e << a.cols_log) + j);
}

// 2^EB neighbouring elements g, g + 1, ... of (16, total) planes, 16 bytes a
// load on the card (g % 2^EB == 0, the planes 16-byte aligned).
template <int EB>
DEV void tile_fetch_run(const uint32_t* x, size_t total, size_t g, fr* v) {
#ifdef __CUDA_ARCH__
    UNROLL
    for (int j = 0; j < Fr::W; ++j) {
        const uint4* lo = reinterpret_cast<const uint4*>(x + (size_t)(2 * j) * total + g);
        const uint4* hi = reinterpret_cast<const uint4*>(x + (size_t)(2 * j + 1) * total + g);
        UNROLL
        for (int c = 0; c < (1 << EB) / 4; ++c) {
            uint4 l = lo[c], h = hi[c];
            uint32_t ls[4] = {l.x, l.y, l.z, l.w}, hs[4] = {h.x, h.y, h.z, h.w};
            UNROLL
            for (int k = 0; k < 4; ++k)
                v[4 * c + k].v[j] = (ls[k] & 0xffffu) | (hs[k] << 16);
        }
    }
#else
    for (int k = 0; k < (1 << EB); ++k) v[k] = fp_load<Fr>(x, total, g + k);
#endif
}

// Value at slab position q -> out, times its entry of w and the scalar.
DEV void tile_emit(const TileArgs& a, size_t row0, uint32_t q, fr v, const fr* sc) {
    size_t row = row0 + (q >> a.log_m);
    if (row >= a.rows) return;
    row = tile_out_row(a, row);
    uint32_t p = q & ((1u << a.log_m) - 1u);
    if (a.w != nullptr)
        v = fp_mul_cc<Fr>(v, fp_load<Fr>(a.w, a.w_rows << a.log_m,
                                          ((row % a.w_rows) << a.log_m) + p));
    if (sc != nullptr) v = fp_mul_cc<Fr>(v, *sc);
    fp_store<Fr>(a.out, a.rows << a.log_m, (row << a.log_m) + p, v);
}

// The twiddle of stage e0 + b + 1 for the pair whose lower value sits at q.
struct TileTw {
    const uint32_t* tw;
    int log_m, e0;
    DEV fr operator()(int b, uint32_t q) const {
        int s1 = e0 + b;                                  // stage - 1
        uint32_t j = q & ((1u << s1) - 1u);
        return fp_load<Fr>(tw, (size_t)1 << (log_m - 1), (size_t)j << (log_m - 1 - s1));
    }
};

// The scalar, read once a thread (null when there is none).
DEV const fr* tile_scale(const TileArgs& a, fr& buf) {
    if (a.scale == nullptr) return nullptr;
    buf = fp_load<Fr>(a.scale, 1, 0);
    return &buf;
}

// Round 1 of thread t: x -> registers -> shared memory (out, when the row
// has at most EB stages).
template <int EB>
DEV void tile_round_first(const TileArgs& a, size_t row0, uint32_t t, uint32_t* sh) {
    constexpr int V = 1 << EB;
    uint32_t cap = 1u << a.sb;
    uint32_t q0 = tile_first_q0(t, a.log_m, a.cols_log >= 0, EB);
    fr v[V];
    size_t row = row0 + (q0 >> a.log_m);
    if (a.cols_log < 0 && a.vec_in && a.log_m >= EB && row < a.rows) {
        tile_fetch_run<EB>(a.x, a.rows << a.log_m, (row0 << a.log_m) + q0, v);
    } else {
        UNROLL
        for (int k = 0; k < V; ++k) v[k] = tile_fetch(a, row0, q0 + k);
    }
    int r = a.log_m < EB ? a.log_m : EB;
    ntt_round<EB, true>(v, q0, 0, 0, r, TileTw{a.tw, a.log_m, 0});
    if (a.log_m <= EB) {
        fr scb;
        const fr* sc = tile_scale(a, scb);
        UNROLL
        for (int k = 0; k < V; ++k) tile_emit(a, row0, q0 + k, v[k], sc);
    } else {
        UNROLL
        for (int k = 0; k < V; ++k) ntt_sh_put(sh, cap, q0 + k, v[k]);
    }
}

// The round of stages s0 + 1 .. min(s0 + EB, log_m) (s0 = EB, 2 EB, ...) of
// thread t: shared memory -> registers -> shared memory, or out after the
// last.
template <int EB>
DEV void tile_round(const TileArgs& a, size_t row0, uint32_t t, int s0, uint32_t* sh) {
    constexpr int V = 1 << EB;
    uint32_t cap = 1u << a.sb;
    int r = a.log_m - s0 < EB ? a.log_m - s0 : EB;
    int e0 = s0 + EB <= a.sb ? s0 : a.sb - EB;
    uint32_t q0 = ntt_round_q0(t, e0, a.sb, EB);
    fr v[V];
    UNROLL
    for (int k = 0; k < V; ++k) v[k] = ntt_sh_get(sh, cap, q0 | ((uint32_t)k << e0));
    ntt_round<EB, false>(v, q0, e0, s0 - e0, s0 - e0 + r, TileTw{a.tw, a.log_m, e0});
    if (s0 + r == a.log_m) {
        fr scb;
        const fr* sc = tile_scale(a, scb);
        UNROLL
        for (int k = 0; k < V; ++k) tile_emit(a, row0, q0 | ((uint32_t)k << e0), v[k], sc);
    } else {
        UNROLL
        for (int k = 0; k < V; ++k) ntt_sh_put(sh, cap, q0 | ((uint32_t)k << e0), v[k]);
    }
}

// Slab bits and rows of a block for rows of 2^log_m.
HOSTDEV int tile_slab_bits(int log_m) { return log_m > NTT_SLAB_BITS ? log_m : NTT_SLAB_BITS; }

HOSTDEV size_t tile_rows_per_block(int log_m) {
    return (size_t)1 << (tile_slab_bits(log_m) - log_m);
}

// ---------------------------------------------------------------------------
// The ladder's high stages: `count` consecutive radix-2 DIT stages of each
// row of (16, rows, n) in one pass
// ---------------------------------------------------------------------------
//
// The stages s1 .. s1 + count - 1 (half h0 = 2^(s1 - 1) at the first) mix
// only the 2^count elements o + i h0 (i < 2^count) of each aligned run of
// 2^count h0 elements, for each offset o < h0.  A block's slab is (runs,
// i, C offsets): slab bits [0, lo) the offset's low bits (C = 2^lo =
// min(h0, 2^(11 - count)) neighbouring offsets, so each 32-byte sector of a
// limb plane is read whole), [lo, lo + count) i, the bits above the run.
// Each round takes NTT_STAGES_EB of i's bits: round 0 from x into
// registers, the others through shared memory, and the last writes out,
// times the scalar where given.  The twiddle of stage s for offset o and i is w_(2^s)^(o + (i mod
// 2^(s - s1)) h0): entry (that) << (S - s) of the table of a size-2^S domain,
// S at least the launch's top stage (the full domain's table, or the top
// stage's own, whose entries are then close together).

struct StagesArgs {
    const uint32_t* x;     // (16, total)
    const uint32_t* tw;    // (16, 2^(log_s - 1))
    const uint32_t* scale; // (16,) or null
    uint32_t* out;         // (16, total)
    size_t total;          // rows * n; a multiple of 2^(log_h0 + count)
    int log_h0, count, log_s, lo;
};

HOSTDEV int stages_lo(int log_h0, int count) {
    return log_h0 < NTT_SLAB_BITS - count ? log_h0 : NTT_SLAB_BITS - count;
}

// Blocks of one launch: offset chunks (fastest) by slabs of runs.
HOSTDEV size_t stages_blocks(size_t total, int log_h0, int count) {
    int lo = stages_lo(log_h0, count);
    size_t runs = total >> (log_h0 + count);
    int run_bits = NTT_SLAB_BITS - count - lo;
    size_t chunks = (size_t)1 << (log_h0 - lo);
    return chunks * ((runs + ((size_t)1 << run_bits) - 1) >> run_bits);
}

// Array index of slab position q in block blk; false past the last run.
HOSTDEV bool stages_index(const StagesArgs& a, size_t blk, uint32_t q, size_t& idx) {
    int run_bits = NTT_SLAB_BITS - a.count - a.lo;
    size_t chunks = (size_t)1 << (a.log_h0 - a.lo);
    size_t chunk = blk & (chunks - 1), slab = blk >> (a.log_h0 - a.lo);
    size_t run = (slab << run_bits) + (q >> (a.lo + a.count));
    if (run >= a.total >> (a.log_h0 + a.count)) return false;
    size_t i = (q >> a.lo) & ((1u << a.count) - 1u);
    size_t o = (chunk << a.lo) + (q & ((1u << a.lo) - 1u));
    idx = (run << (a.log_h0 + a.count)) + (i << a.log_h0) + o;
    return true;
}

struct StagesTw {
    const StagesArgs* a;
    size_t chunk;
    int e0;
    DEV fr operator()(int b, uint32_t q) const {
        int t = e0 + b - a->lo;                               // the stage: s1 + t
        size_t o = (chunk << a->lo) + (q & ((1u << a->lo) - 1u));
        size_t il = (q >> a->lo) & ((1u << t) - 1u);
        size_t j = o + (il << a->log_h0);
        return fp_load<Fr>(a->tw, (size_t)1 << (a->log_s - 1),
                           j << (a->log_s - 1 - a->log_h0 - t));
    }
};

// Round `rnd` of thread t in block blk: i's bits [EB rnd, EB (rnd + 1)),
// from x in round 0, through shared memory after it, to out in the last.
DEV void stages_round(const StagesArgs& a, size_t blk, uint32_t t, int rnd, uint32_t* sh) {
    constexpr int EB = NTT_STAGES_EB, V = 1 << EB;
    const uint32_t cap = 1u << NTT_SLAB_BITS;
    int first = a.lo + EB * rnd;                         // slab bit of the round's first stage
    int r = a.count - EB * rnd < EB ? a.count - EB * rnd : EB;
    int e0 = first < NTT_SLAB_BITS - EB ? first : NTT_SLAB_BITS - EB;
    uint32_t q0 = ntt_round_q0(t, e0, NTT_SLAB_BITS, EB);
    bool last = EB * rnd + r == a.count;
    fr v[V];
    UNROLL
    for (int k = 0; k < V; ++k) {
        uint32_t q = q0 | ((uint32_t)k << e0);
        size_t idx;
        if (rnd > 0) v[k] = ntt_sh_get(sh, cap, q);
        else v[k] = stages_index(a, blk, q, idx) ? fp_load<Fr>(a.x, a.total, idx)
                                                 : fp_zero<Fr>();
    }
    size_t chunk = blk & (((size_t)1 << (a.log_h0 - a.lo)) - 1);
    ntt_round<EB, false>(v, q0, e0, first - e0, first - e0 + r, StagesTw{&a, chunk, e0});
    fr scb;
    const fr* sc = nullptr;
    if (last && a.scale != nullptr) {
        scb = fp_load<Fr>(a.scale, 1, 0);
        sc = &scb;
    }
    UNROLL
    for (int k = 0; k < V; ++k) {
        uint32_t q = q0 | ((uint32_t)k << e0);
        size_t idx;
        if (!last) {
            ntt_sh_put(sh, cap, q, v[k]);
        } else if (stages_index(a, blk, q, idx)) {
            fp_store<Fr>(a.out, a.total, idx, sc != nullptr ? fp_mul_cc<Fr>(v[k], *sc) : v[k]);
        }
    }
}
