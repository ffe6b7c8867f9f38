// Montgomery's batch inversion, the lane bodies of batch_inverse.cu's three
// kernels (host_check.cpp runs the same bodies in loops on a CPU).
//
// The n elements of x (K, n) are tiled (R, L): element r*L + l is row r of
// column l.  Past n the tile holds ones, and a zero is taken as one (its
// inverse is written as 0), so every product below is of units.
//  phase 1  thread l walks its column down and writes the inclusive prefix
//           products of rows 0..R-2 to `pre` (K, (R-1)*L) and the column's
//           product to `col` (K, L);
//  phase 2  one block of T threads inverts the L column products: thread t
//           folds its run of columns t, t + T, t + 2T, ... (neighbouring
//           threads on neighbouring columns, so the loads coalesce; the
//           products commute, so any partition gives the same inverses),
//           writing the run's inclusive prefixes to `colinv`; the block
//           scans the run products from both ends, one thread takes the
//           single Fermat inverse of the total (field_carry.cuh's
//           fp_inv_fermat), and thread t walks its run backward, writing
//           1/col[l] to `colinv`;
//  phase 3  thread l walks its column up from 1/col[l]: the inverse of row
//           r is (1 / prefix r) * prefix (r - 1), and 1 / prefix (r - 1) is
//           (1 / prefix r) * x_r.
// Three products an element (one in phase 1, two in phase 3), all on the
// carry-chain product of field_carry.cuh.  An inverse is unique and
// canonical, so the result equals any other association's bit for bit.

#pragma once

#include "field_carry.cuh"

// Element i of the tile as a unit: one past n and in place of a zero.
template <class F>
DEV El<F> binv_unit(const uint32_t* x, size_t n, size_t i) {
    if (i >= n) return fp_one<F>();
    El<F> v = fp_load<F>(x, n, i);
    return fp_cmov<F>(fp_is_zero<F>(v), fp_one<F>(), v);
}

// Phase 1, column l.
template <class F>
DEV void binv_prefix_lane(const uint32_t* x, uint32_t* pre, uint32_t* col,
                          size_t n, size_t L, int R, size_t l) {
    const size_t rows = (size_t)(R - 1) * L;       // pre's plane stride
    El<F> acc = binv_unit<F>(x, n, l);
    ROLLED
    for (int r = 1; r < R; ++r) {
        fp_store<F>(pre, rows, (size_t)(r - 1) * L + l, acc);
        acc = fp_mul_cc<F>(acc, binv_unit<F>(x, n, (size_t)r * L + l));
    }
    fp_store<F>(col, L, l, acc);
}

// Phase 2, the fold of thread t's run (columns t, t + T, ... below L): the
// run's product; colinv[l] takes the run's inclusive prefix up to l.  An
// empty run is one.
template <class F>
DEV El<F> binv_fold_run(const uint32_t* col, uint32_t* colinv, size_t L,
                        size_t T, size_t t) {
    El<F> acc = fp_one<F>();
    ROLLED
    for (size_t l = t; l < L; l += T) {
        acc = fp_mul_cc<F>(acc, fp_load<F>(col, L, l));
        fp_store<F>(colinv, L, l, acc);
    }
    return acc;
}

// Phase 2, the walk back from iv = 1 / (the run's product): 1/col[l] is
// iv * (the run's prefix before l), then iv takes col[l] off.
template <class F>
DEV void binv_walk_run(El<F> iv, const uint32_t* col, uint32_t* colinv,
                       size_t L, size_t T, size_t t) {
    if (t >= L) return;
    size_t l = t + (L - 1 - t) / T * T;             // the run's last column
    ROLLED
    for (;;) {
        bool first = l == t;
        El<F> before = first ? fp_one<F>() : fp_load<F>(colinv, L, l - T);
        El<F> inv = fp_mul_cc<F>(iv, before);
        if (!first) iv = fp_mul_cc<F>(iv, fp_load<F>(col, L, l));
        fp_store<F>(colinv, L, l, inv);
        if (first) break;
        l -= T;
    }
}

// Phase 3, column l: every element's inverse, 0 for a zero.
template <class F>
DEV void binv_unwind_lane(const uint32_t* x, const uint32_t* pre,
                          const uint32_t* colinv, uint32_t* out, size_t n,
                          size_t L, int R, size_t l) {
    const size_t rows = (size_t)(R - 1) * L;
    El<F> iv = fp_load<F>(colinv, L, l);            // 1 / prefix R-1
    ROLLED
    for (int r = R - 1; r >= 0; --r) {
        size_t i = (size_t)r * L + l;
        El<F> inv = r > 0 ? fp_mul_cc<F>(iv, fp_load<F>(pre, rows, (size_t)(r - 1) * L + l))
                          : iv;
        if (i < n) {
            El<F> v = fp_load<F>(x, n, i);
            bool zero = fp_is_zero<F>(v);
            fp_store<F>(out, n, i, fp_cmov<F>(zero, fp_zero<F>(), inv));
            if (r > 0) iv = fp_mul_cc<F>(iv, fp_cmov<F>(zero, fp_one<F>(), v));
        }
    }
}
