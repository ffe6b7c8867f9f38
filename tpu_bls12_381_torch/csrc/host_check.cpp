// Host build of the kernels' lane bodies: the same device code as the CUDA
// kernels (field.cuh, field_carry.cuh, g1.cuh, g1_jac.cuh, g2.cuh,
// g2_pair.cuh, ntt.cuh, batch_inverse.cuh, lane_scan.cuh),
// compiled as plain C++ and run in a
// loop over the lanes (for the NTT tile and the ladder's stages: over the
// blocks, and inside a block over its rounds and threads, with a heap array
// for the shared memory).  It lets a machine without a GPU hold the kernels' arithmetic
// against the plain PyTorch versions (tests/test_torch_csrc_host.py):
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libhost_check.so host_check.cpp
//
// It is not part of the GPU build (_build.py compiles only *.cu).

#include <vector>

#include "batch_inverse.cuh"
#include "g1.cuh"
#include "g1_jac.cuh"
#include "g2_pair.cuh"
#include "lane_scan.cuh"
#include "ntt.cuh"

// The elementwise product's and square's lanes (field_kernels.cu's
// mont_mul_kernel), on the path the launcher takes or on the one forced.
template <class F, int MODE>
static void host_mont_mul_at(const uint32_t* a, const uint32_t* b, const El<F>& bc,
                             uint32_t* out, size_t n, size_t i, bool four) {
    if (four)
        mont_mul_lanes4<F, MODE>(a, b, bc, out, n, i);
    else
        mont_mul_lane1<F, MODE>(a, b, bc, out, n, i);
}

template <class F>
static void host_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                          size_t n, int mode, int path) {
    const El<F> bc = mode == MUL_COLUMN ? fp_load<F>(b, 1, 0) : fp_zero<F>();
    const bool four = path < 0 ? mont_mul_takes_four<F>(n, mode, a, b, out) : path == 1;
    if (four && n % 4 != 0) return;                 // no such launch
    for (size_t i = 0; i < n; i += four ? 4 : 1) {
        if (mode == MUL_PLANE)
            host_mont_mul_at<F, MUL_PLANE>(a, b, bc, out, n, i, four);
        else if (mode == MUL_COLUMN)
            host_mont_mul_at<F, MUL_COLUMN>(a, b, bc, out, n, i, four);
        else
            host_mont_mul_at<F, MUL_SQUARE>(a, a, bc, out, n, i, four);
    }
}

// The elementwise add's and sub's lanes (field_kernels.cu's addsub_kernel),
// on the path the launcher takes or on the one forced.
template <class F, bool SUB, int MODE>
static void host_addsub_mode(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n,
                             bool four) {
    const El<F> c = MODE == AS_COLUMN || MODE == AS_COLUMN_LEFT ? fp_load<F>(b, 1, 0)
                                                                 : fp_zero<F>();
    for (size_t i = 0; i < n; i += four ? 4 : 1) {
        if (four)
            addsub_lanes4<F, SUB, MODE>(a, b, c, out, n, i);
        else
            addsub_lane1<F, SUB, MODE>(a, b, c, out, n, i);
    }
}

template <class F, bool SUB>
static void host_addsub(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n,
                        int mode, int path) {
    const bool four = path < 0 ? addsub_takes_four<F>(n, mode, a, b, out) : path == 1;
    if (four && n % 4 != 0) return;                 // no such launch
    if (mode == AS_PLANES)
        host_addsub_mode<F, SUB, AS_PLANES>(a, b, out, n, four);
    else if (mode == AS_COLUMN)
        host_addsub_mode<F, SUB, AS_COLUMN>(a, b, out, n, four);
    else if (mode == AS_COLUMN_LEFT)
        host_addsub_mode<F, SUB, AS_COLUMN_LEFT>(a, b, out, n, four);
    else
        host_addsub_mode<F, SUB, AS_ALONE>(a, a, out, n, four);
}

// field_sum's shuffle tree: at each offset, lane l adds lane l + off's
// value, or its own where l + off is past the warp (what __shfl_down_sync
// returns there).
template <class F>
static El<F> host_sum_warp(std::vector<El<F>> x) {
    for (int off = 16; off > 0; off >>= 1) {
        std::vector<El<F>> y = x;
        for (int l = 0; l < 32; ++l) x[l] = fp_add_cc<F>(y[l], y[l + off < 32 ? l + off : l]);
    }
    return x[0];
}

// One field_sum pass (field_kernels.cu's field_sum_kernel), block by block:
// each thread's run, the warps' trees, the tree over the warps' partials.
template <class F>
static void host_sum_pass(const uint32_t* v, uint32_t* out, size_t n, size_t rows,
                          size_t G, bool four) {
    for (size_t k = 0; k < rows * G; ++k) {
        const size_t b = k / G, g = k % G;
        std::vector<El<F>> part(32, fp_zero<F>());
        for (size_t w = 0; w < SUM_THREADS / 32; ++w) {
            std::vector<El<F>> lanes(32);
            for (size_t l = 0; l < 32; ++l) {
                const size_t t = g * SUM_THREADS + 32 * w + l, step = G * SUM_THREADS;
                lanes[l] = four ? sum_run<F, true>(v + b * n, rows * n, n, t, step)
                                : sum_run<F, false>(v + b * n, rows * n, n, t, step);
            }
            part[w] = host_sum_warp<F>(lanes);
        }
        fp_store<F>(out, rows * G, k, host_sum_warp<F>(part));
    }
}

// field_sum's two passes as the launcher runs them, or with G blocks a row
// and (four: 0 or 1) the lanes a step forced.
template <class F>
static void host_field_sum(const uint32_t* v, uint32_t* out, size_t n, size_t rows,
                           size_t G, int four) {
    if (G == 0) G = field_sum_blocks(n, rows);
    auto takes = [&](size_t m, const uint32_t* p) {
        return four < 0 ? field_sum_takes_four(m, p) : four == 1 && m % 4 == 0;
    };
    std::vector<uint32_t> scratch((size_t)F::K * rows * G);
    uint32_t* first = G == 1 ? out : scratch.data();
    host_sum_pass<F>(v, first, n, rows, G, takes(n, v));
    if (G > 1) host_sum_pass<F>(first, out, G, rows, 1, takes(G, first));
}

// The batch inversion's three phases (batch_inverse.cu), phase 2's block of
// `threads` with its two Hillis-Steele scans as host loops (at step s, value
// t takes t - s of the prefix scan and t + s of the suffix scan of the step
// before).  Arguments as batch_inverse.cu's, scratch included.
template <class F>
static void host_batch_inverse(const uint32_t* x, uint32_t* out, uint32_t* pre,
                               uint32_t* col, uint32_t* colinv, size_t n, size_t L,
                               int R, size_t threads) {
    for (size_t l = 0; l < L; ++l) binv_prefix_lane<F>(x, pre, col, n, L, R, l);
    const size_t T = threads;
    std::vector<El<F>> p(T), q(T);
    for (size_t t = 0; t < T; ++t) p[t] = q[t] = binv_fold_run<F>(col, colinv, L, T, t);
    for (size_t s = 1; s < T; s <<= 1) {
        std::vector<El<F>> p0 = p, q0 = q;
        for (size_t t = 0; t < T; ++t) {
            if (t >= s) p[t] = fp_mul_cc<F>(p0[t - s], p0[t]);
            if (t + s < T) q[t] = fp_mul_cc<F>(q0[t], q0[t + s]);
        }
    }
    El<F> g = fp_inv_fermat<F>(p[T - 1]);
    for (size_t t = 0; t < T; ++t) {
        El<F> iv = g;
        if (t > 0) iv = fp_mul_cc<F>(iv, p[t - 1]);
        if (t + 1 < T) iv = fp_mul_cc<F>(iv, q[t + 1]);
        binv_walk_run<F>(iv, col, colinv, L, T, t);
    }
    for (size_t l = 0; l < L; ++l) binv_unwind_lane<F>(x, pre, colinv, out, n, L, R, l);
}

// The lane scan's three passes (lane_scan.cuh: padd_scan, padd2_scan),
// block by block, with the shared-memory block scan as a loop over the
// block's values (the same Hillis-Steele steps: at step s, value t takes
// value t - s of the step before).  Arguments as g1_kernels.cu's
// g1_padd_scan and g2_padd_scan.cu's g2_padd_scan.
template <class C>
static void host_block_scan(std::vector<typename C::P>& v) {
    for (size_t s = 1; s < v.size(); s <<= 1) {
        std::vector<typename C::P> before = v;
        for (size_t t = s; t < v.size(); ++t) v[t] = C::add(before[t - s], before[t]);
    }
}

template <class C>
static void host_padd_scan(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                           uint32_t* OX, uint32_t* OY, uint32_t* OZ,
                           uint32_t* SX, uint32_t* SY, uint32_t* SZ,
                           uint32_t* VX, uint32_t* VY, uint32_t* VZ,
                           uint32_t* CX, uint32_t* CY, uint32_t* CZ,
                           size_t rows, size_t L, int run, int threads, int threads2,
                           int reverse, int exclusive) {
    typedef typename C::P P;
    size_t T = threads, T2 = threads2, n = rows * L;   // n: the walk's planes
    size_t nblk = (L + (size_t)run * T - 1) / ((size_t)run * T);
    int run2 = (int)((nblk + T2 - 1) / T2);
    for (size_t b = 0; b < rows; ++b) {
        for (size_t k = 0; k < nblk; ++k) {                        // up
            std::vector<P> v(T);
            for (size_t t = 0; t < T; ++t)
                v[t] = scan_fold_lanes<C>(X, Y, Z, (uint32_t)L, (uint32_t)rows,
                                          (uint32_t)b, (uint32_t)((k * T + t) * run),
                                          (uint32_t)run, reverse != 0);
            host_block_scan<C>(v);
            for (size_t t = 0; t < T; ++t)
                C::store(VX, VY, VZ, rows * nblk * T, (b * nblk + k) * T + t, v[t]);
        }
        std::vector<P> w(T2);                                      // carry
        for (size_t t = 0; t < T2; ++t)
            w[t] = scan_fold_totals<C>(VX, VY, VZ, (uint32_t)rows, (uint32_t)nblk,
                                       (uint32_t)T, (uint32_t)b, (uint32_t)(t * run2),
                                       (uint32_t)run2);
        host_block_scan<C>(w);
        if (SX != nullptr) C::store(SX, SY, SZ, rows, b, w[T2 - 1]);
        for (size_t t = 0; t < T2; ++t)
            scan_carry_walk<C>(t > 0 ? w[t - 1] : C::identity(), VX, VY, VZ, CX, CY, CZ,
                               rows, nblk, T, b, t * run2, run2);
        if (OX == nullptr) continue;
        for (size_t k = 0; k < nblk; ++k)                          // down
            for (size_t t = 0; t < T; ++t)
                scan_walk<C>(scan_carry_in<C>(VX, VY, VZ, CX, CY, CZ, rows, nblk, T, b, k, t),
                             X, Y, Z, OX, OY, OZ, L, n, b, (k * T + t) * run, run,
                             reverse != 0, exclusive != 0);
    }
}

// The tile's rounds over the blocks of rows (fr_ntt_tile below).
template <int EB>
static void host_tile(const TileArgs& a, size_t per, uint32_t* sh) {
    const uint32_t threads = ntt_threads(a.sb, EB);
    for (size_t row0 = 0; row0 < a.rows; row0 += per) {
        for (uint32_t t = 0; t < threads; ++t) tile_round_first<EB>(a, row0, t, sh);
        for (int s0 = EB; s0 < a.log_m; s0 += EB)
            for (uint32_t t = 0; t < threads; ++t) tile_round<EB>(a, row0, t, s0, sh);
    }
}

extern "C" {

// The elementwise product and square (field_kernels.cu): `mode` as MulMode
// (b is one (K, 1) element for MUL_COLUMN, unused for MUL_SQUARE); `path`
// -1 takes the path the launcher takes (mont_mul_takes_four), 0 the one-lane
// path, 1 the four-lane path (n % 4 == 0), a thread's lanes in a loop.
void mont_mul_path(int words, const uint32_t* a, const uint32_t* b, uint32_t* out,
                   size_t n, int mode, int path) {
    if (words == 8)
        host_mont_mul<Fr>(a, b, out, n, mode, path);
    else
        host_mont_mul<Fq>(a, b, out, n, mode, path);
}

// 1 where the launcher takes the four-lane path for these pointers.
int mont_mul_four(int words, size_t n, int mode, const uint32_t* a, const uint32_t* b,
                  const uint32_t* out) {
    return (words == 8 ? mont_mul_takes_four<Fr>(n, mode, a, b, out)
                       : mont_mul_takes_four<Fq>(n, mode, a, b, out)) ? 1 : 0;
}

void fr_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    host_mont_mul<Fr>(a, b, out, n, MUL_PLANE, -1);
}

void fq_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    host_mont_mul<Fq>(a, b, out, n, MUL_PLANE, -1);
}

void fr_mont_sqr(const uint32_t* a, uint32_t* out, size_t n) {
    host_mont_mul<Fr>(a, a, out, n, MUL_SQUARE, -1);
}

void fq_mont_sqr(const uint32_t* a, uint32_t* out, size_t n) {
    host_mont_mul<Fq>(a, a, out, n, MUL_SQUARE, -1);
}

// The elementwise add and sub (field_kernels.cu): `sub` 0 or 1, `mode` as
// AddSubMode (b is one (K, 1) element for AS_COLUMN and AS_COLUMN_LEFT,
// unused for AS_ALONE), `path` as mont_mul_path's.
void addsub_path(int words, int sub, const uint32_t* a, const uint32_t* b, uint32_t* out,
                 size_t n, int mode, int path) {
    if (words == 8) {
        if (sub) host_addsub<Fr, true>(a, b, out, n, mode, path);
        else host_addsub<Fr, false>(a, b, out, n, mode, path);
    } else {
        if (sub) host_addsub<Fq, true>(a, b, out, n, mode, path);
        else host_addsub<Fq, false>(a, b, out, n, mode, path);
    }
}

// 1 where the launcher takes the four-lane path for these pointers.
int addsub_four(int words, size_t n, int mode, const uint32_t* a, const uint32_t* b,
                const uint32_t* out) {
    return (words == 8 ? addsub_takes_four<Fr>(n, mode, a, b, out)
                       : addsub_takes_four<Fq>(n, mode, a, b, out)) ? 1 : 0;
}

void fr_field_add(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    host_addsub<Fr, false>(a, b, out, n, AS_PLANES, -1);
}

void fq_field_add(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    host_addsub<Fq, false>(a, b, out, n, AS_PLANES, -1);
}

void fr_field_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    host_addsub<Fr, true>(a, b, out, n, AS_PLANES, -1);
}

void fq_field_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    host_addsub<Fq, true>(a, b, out, n, AS_PLANES, -1);
}

// field_sum (field_kernels.cu) over (K, rows, n) into (K, rows): `blocks`
// a row (0: the launcher's field_sum_blocks), `four` -1 the launcher's
// choice of lanes a step, 0 one, 1 four; field_sum_blocks for the tests.
void field_sum(int words, const uint32_t* v, uint32_t* out, size_t n, size_t rows,
               size_t blocks, int four) {
    if (words == 8)
        host_field_sum<Fr>(v, out, n, rows, blocks, four);
    else
        host_field_sum<Fq>(v, out, n, rows, blocks, four);
}

size_t sum_blocks(size_t n, size_t rows) { return field_sum_blocks(n, rows); }

void fr_butterfly(const uint32_t* e, const uint32_t* o, const uint32_t* w,
                  uint32_t* hi, uint32_t* lo, size_t n) {
    for (size_t i = 0; i < n; ++i) butterfly_lane<Fr>(e, o, w, hi, lo, n, i);
}

// The ladder's stages (ntt_stages.cu), block by block, each round thread by
// thread: a round's threads touch disjoint slab positions, and the barrier
// between the rounds is the end of the loop over the threads.  Arguments as
// ntt_stages.cu's fr_butterfly_stages.
void fr_butterfly_stages(const uint32_t* x, const uint32_t* tw, const uint32_t* scale,
                         uint32_t* out, size_t total, int log_h0, int count, int log_s) {
    StagesArgs a{x, tw, scale, out, total, log_h0, count, log_s,
                 stages_lo(log_h0, count)};
    const uint32_t threads = ntt_threads(NTT_SLAB_BITS, NTT_STAGES_EB);
    std::vector<uint32_t> sh((size_t)Fr::W << NTT_SLAB_BITS);
    size_t blocks = stages_blocks(total, log_h0, count);
    for (size_t blk = 0; blk < blocks; ++blk)
        for (int rnd = 0; NTT_STAGES_EB * rnd < count; ++rnd)
            for (uint32_t t = 0; t < threads; ++t) stages_round(a, blk, t, rnd, sh.data());
}

// One stage of the ladder: the stages kernel at count = 1, with the table of
// the whole domain (16, n/2).
void fr_butterfly_stage(const uint32_t* x, const uint32_t* tw, uint32_t* out,
                        size_t rows, size_t n, size_t half) {
    int log_n = 0, log_h = 0;
    while (((size_t)1 << log_n) < n) ++log_n;
    while (((size_t)1 << log_h) < half) ++log_h;
    fr_butterfly_stages(x, tw, nullptr, out, rows * n, log_h, 1, log_n);
}

// The tile kernel's body (ntt_kernels.cu), block by block, each round thread
// by thread (host_tile).  cols_log and brev_cols as fr_ntt_tile's; vec_in is
// the card's alone.

void fr_ntt_tile(const uint32_t* x, const uint32_t* tw, const uint32_t* w,
                 const uint32_t* scale, uint32_t* out, size_t rows, size_t w_rows,
                 int log_m, int cols_log, int brev_cols) {
    TileArgs a{x, tw, w, scale, out, rows, w_rows, log_m, tile_slab_bits(log_m), 0,
               cols_log, brev_cols};
    std::vector<uint32_t> sh((size_t)Fr::W << a.sb);
    size_t per = tile_rows_per_block(log_m);
    if (tile_eb(a.sb) == 2) host_tile<2>(a, per, sh.data());
    else host_tile<3>(a, per, sh.data());
}

// The round mappings, for the tests: element bits of the tile's rounds for
// a slab of 2^sb and of the stages kernel's; slab positions of thread t's
// 2^eb values (tile round 1, then a round with element bits [e0, e0 + eb));
// the array index of stages slab position q (-1 past the last run).
int ntt_tile_eb(int sb) { return tile_eb(sb); }

int ntt_stages_eb() { return NTT_STAGES_EB; }

void ntt_first_positions(uint32_t t, int log_m, int natural_in, int eb, uint32_t* q) {
    uint32_t q0 = tile_first_q0(t, log_m, natural_in, eb);
    for (int k = 0; k < (1 << eb); ++k) q[k] = q0 + (uint32_t)k;
}

void ntt_round_positions(uint32_t t, int e0, int sb, int eb, uint32_t* q) {
    uint32_t q0 = ntt_round_q0(t, e0, sb, eb);
    for (int k = 0; k < (1 << eb); ++k) q[k] = q0 | ((uint32_t)k << e0);
}

uint32_t ntt_swizzle(uint32_t q) { return ntt_swz(q); }

long long stages_array_index(size_t total, int log_h0, int count, size_t blk, uint32_t q) {
    StagesArgs a{nullptr, nullptr, nullptr, nullptr, total, log_h0, count, 0,
                 stages_lo(log_h0, count)};
    size_t idx;
    return stages_index(a, blk, q, idx) ? (long long)idx : -1;
}

size_t stages_block_count(size_t total, int log_h0, int count) {
    return stages_blocks(total, log_h0, count);
}

// The carry-chain product of field_carry.cuh (its chains as C++).
void fq_mont_mul_carry(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i)
        fp_store<Fq>(out, n, i, fq_mul_cc(fp_load<Fq>(a, n, i), fp_load<Fq>(b, n, i)));
}

void fr_mont_mul_carry(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i)
        fp_store<Fr>(out, n, i, fp_mul_cc<Fr>(fp_load<Fr>(a, n, i), fp_load<Fr>(b, n, i)));
}

void fq_add_sub(const uint32_t* a, const uint32_t* b, uint32_t* sum,
                uint32_t* diff, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        fq x = fp_load<Fq>(a, n, i), y = fp_load<Fq>(b, n, i);
        fp_store<Fq>(sum, n, i, fq_add(x, y));
        fp_store<Fq>(diff, n, i, fq_sub(x, y));
    }
}

void g1_pmadd_signed(const uint32_t* accX, const uint32_t* accY, const uint32_t* accZ,
                     const uint32_t* x2, const uint32_t* y2, size_t row_stride,
                     const uint8_t* inf2, const uint8_t* sign,
                     uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t L, int R) {
    for (size_t i = 0; i < L; ++i)
        g1_pmadd_signed_lane(accX, accY, accZ, x2, y2, row_stride, inf2, sign,
                             X3, Y3, Z3, L, R, i);
}

void g1_pmadd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
              const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
              uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_pmadd_lane(X1, Y1, Z1, x2, y2, inf2, X3, Y3, Z3, n, i);
}

void g1_padd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_padd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, i);
}

// The doubling chain of g1_kernels.cu's pdbl: `times` doublings a lane.
void g1_pdbl(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n, int times) {
    for (size_t i = 0; i < n; ++i) g1_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, i, times);
}

// The joint GLV ladder of g1_kernels.cu's glv_ladder (scalar_mul_glv in one
// launch): k1 (16, n) and k2 (k2_limbs, n) limb planes.
void g1_glv_ladder(const uint32_t* k1, const uint32_t* k2, int k2_limbs,
                   const uint32_t* x2, const uint32_t* y2, const uint32_t* phi_x2,
                   const uint8_t* inf2, uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                   size_t n, int num_bits) {
    for (size_t i = 0; i < n; ++i)
        g1_glv_ladder_lane(k1, k2, k2_limbs, x2, y2, phi_x2, inf2, X3, Y3, Z3, n, i,
                           num_bits);
}

void g1_jdbl(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i) g1_jdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, i);
}

// The ladder of g1_jac_kernels.cu's jac_ladder (scalar_mul in one launch):
// scalar limb j of lane i at scalars[j * s_plane + i * s_lane].  Every lane
// runs alone, so each takes the add where its own bit is set (WARP_ANY(p) is p).
void g1_jac_ladder(const uint32_t* scalars, size_t s_plane, size_t s_lane,
                   const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
                   uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n, int num_bits) {
    for (size_t i = 0; i < n; ++i)
        g1_jac_ladder_lane(scalars, s_plane, s_lane, x2, y2, inf2, X3, Y3, Z3, n, i,
                           num_bits);
}

void g1_madd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_madd_lane(X1, Y1, Z1, x2, y2, inf2, X3, Y3, Z3, n, i);
}

void g1_jadd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_jadd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, i);
}

void g1_padd_scan(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                  uint32_t* OX, uint32_t* OY, uint32_t* OZ,
                  uint32_t* SX, uint32_t* SY, uint32_t* SZ,
                  uint32_t* VX, uint32_t* VY, uint32_t* VZ,
                  uint32_t* CX, uint32_t* CY, uint32_t* CZ,
                  size_t rows, size_t L, int run, int threads, int threads2,
                  int reverse, int exclusive) {
    host_padd_scan<G1Curve>(X, Y, Z, OX, OY, OZ, SX, SY, SZ, VX, VY, VZ, CX, CY, CZ,
                            rows, L, run, threads, threads2, reverse, exclusive);
}

void g2_padd_scan(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                  uint32_t* OX, uint32_t* OY, uint32_t* OZ,
                  uint32_t* SX, uint32_t* SY, uint32_t* SZ,
                  uint32_t* VX, uint32_t* VY, uint32_t* VZ,
                  uint32_t* CX, uint32_t* CY, uint32_t* CZ,
                  size_t rows, size_t L, int run, int threads, int threads2,
                  int reverse, int exclusive) {
    host_padd_scan<G2Curve>(X, Y, Z, OX, OY, OZ, SX, SY, SZ, VX, VY, VZ, CX, CY, CZ,
                            rows, L, run, threads, threads2, reverse, exclusive);
}

void fr_batch_inverse(const uint32_t* x, uint32_t* out, uint32_t* pre, uint32_t* col,
                      uint32_t* colinv, size_t n, size_t L, int R, size_t threads) {
    host_batch_inverse<Fr>(x, out, pre, col, colinv, n, L, R, threads);
}

void fq_batch_inverse(const uint32_t* x, uint32_t* out, uint32_t* pre, uint32_t* col,
                      uint32_t* colinv, size_t n, size_t L, int R, size_t threads) {
    host_batch_inverse<Fq>(x, out, pre, col, colinv, n, L, R, threads);
}

// field_kernels.cu's field_inv: the Fermat inverse a lane (batch_inverse.cu's
// phase 2 runs the same fp_inv_fermat on one value).
void fr_field_inv(const uint32_t* a, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) field_inv_lane<Fr>(a, out, n, i);
}

void fq_field_inv(const uint32_t* a, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) field_inv_lane<Fq>(a, out, n, i);
}

// Fq2 products, squares and 12(1+u) multiples on (24, 2, n) batches.
void fq2_ops(const uint32_t* a, const uint32_t* b, uint32_t* prod,
             uint32_t* sqr, uint32_t* m12, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        fq2 x = fq2_load(a, n, i), y = fq2_load(b, n, i);
        fq2_store(prod, n, i, fq2_mul<CarryMul>(x, y));
        fq2_store(sqr, n, i, fq2_sqr<CarryMul>(x));
        fq2_store(m12, n, i, fq2_mul12(x));
    }
}

void g2_pmadd(const uint32_t* accX, const uint32_t* accY, const uint32_t* accZ,
              const uint32_t* x2, const uint32_t* y2, size_t row_stride,
              const uint8_t* inf2, const uint8_t* sign,
              uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t L, int R) {
    for (size_t i = 0; i < L; ++i)   // a pair at a time (g2_pair.cuh)
        g2_pmadd_pair_lane(accX, accY, accZ, x2, y2, row_stride, inf2, sign,
                           X3, Y3, Z3, L, R, i, true, [](bool) { return pair_ctx{}; });
}

void g2_padd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g2_padd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, i);
}

// The doubling chain of g2_pdbl.cu's pdbl2: `times` doublings a lane.
void g2_pdbl(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n, int times) {
    for (size_t i = 0; i < n; ++i) g2_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, i, times);
}

}  // extern "C"
