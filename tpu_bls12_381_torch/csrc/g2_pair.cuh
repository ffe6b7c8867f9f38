// The G2 signed mixed add with its Fq2 state split between a pair of
// neighbouring threads: pmadd2's lane body (g2_pmadd.cu).
//
// RCB16 algorithm 8 (complete mixed addition, Z2 = 1, 11 Fq2 products + 2
// mul12), as the JAX package's curves/pallas_g2.py _k2_proj_madd.  Each
// thread of a pair holds one component of every Fq2 value: the even thread
// c0, the odd one c1, so a thread holds a 36-word point where one thread a
// lane holds 72.  An Fq2 product is two Fq products a thread after one
// exchange of the operands (__shfl_xor_sync): the even thread takes
// a0 b0 - a1 b1, the odd one a1 b0 + a0 b1.  Those are the field elements of
// the Karatsuba product (its c1 is (a0 + a1)(b0 + b1) - a0 b0 - a1 b1), and
// every result is canonical, so the limbs are those of the plain version
// over FQ2_PLAIN.  A pair makes 44 Fq products a lane where one thread makes
// 33, in a chain 22 products deep instead of 33, with half the registers.
//
// The formula is written once over `fq2h` (half an Fq2 value) and its few
// primitives.  On the card an fq2h is one thread's component and the
// primitives exchange with the partner; on the host (host_check.cpp) an fq2h
// holds both threads' components of a pair and the primitives do what each
// thread does, so the host runs the same selects as the card, and only the
// exchange is a swap.

#pragma once

#include "g2.cuh"

#ifdef __CUDACC__

// One thread's component of an Fq2 value.
struct fq2h {
    fq v;
};

// The threads of the warp in the add (both of a pair or neither), and
// whether this thread holds c1.
struct pair_ctx {
    unsigned mask;
    bool odd;
};

DEV fq2h h_swap(const pair_ctx& c, const fq2h& a) {
    fq2h r;
    UNROLL
    for (int w = 0; w < Fq::W; ++w) r.v.v[w] = __shfl_xor_sync(c.mask, a.v.v[w], 1);
    return r;
}

// The even thread's value or the odd one's.
DEV fq2h h_sel(const pair_ctx& c, const fq2h& if_even, const fq2h& if_odd) {
    return fq2h{fp_cmov<Fq>(c.odd, if_odd.v, if_even.v)};
}

DEV fq2h h_add(const fq2h& a, const fq2h& b) { return fq2h{fq_add(a.v, b.v)}; }
DEV fq2h h_sub(const fq2h& a, const fq2h& b) { return fq2h{fq_sub(a.v, b.v)}; }
DEV fq2h h_neg(const fq2h& a) { return fq2h{fq_neg(a.v)}; }
DEV fq2h h_mul12c(const fq2h& a) { return fq2h{fq_mul12(a.v)}; }
DEV fq2h h_cmov(bool take, const fq2h& a, const fq2h& b) {
    return fq2h{fp_cmov<Fq>(take, a.v, b.v)};
}
template <class M>
DEV fq2h h_mulc(const fq2h& a, const fq2h& b) { return fq2h{M::mul(a.v, b.v)}; }

// The identity's coordinates: 0, and 1 = (1, 0).
DEV fq2h h_zero(const pair_ctx&) { return fq2h{fp_zero<Fq>()}; }
DEV fq2h h_one(const pair_ctx& c) {
    return fq2h{fp_cmov<Fq>(c.odd, fp_zero<Fq>(), fp_one<Fq>())};
}

// This thread's component of lane idx of an Fq2 batch (g2.cuh's layout).
DEV fq2h h_load(const pair_ctx& c, const uint32_t* base, size_t n, size_t idx) {
    return fq2h{fp_load<Fq>(base + (c.odd ? n : 0), 2 * n, idx)};
}
DEV void h_store(const pair_ctx& c, uint32_t* base, size_t n, size_t idx, const fq2h& a) {
    fp_store<Fq>(base + (c.odd ? n : 0), 2 * n, idx, a.v);
}

#else  // the host: an fq2h is both threads' components of a pair

struct fq2h {
    fq v[2];
};

struct pair_ctx {};

DEV fq2h h_swap(const pair_ctx&, const fq2h& a) { return fq2h{{a.v[1], a.v[0]}}; }
DEV fq2h h_sel(const pair_ctx&, const fq2h& if_even, const fq2h& if_odd) {
    return fq2h{{if_even.v[0], if_odd.v[1]}};
}
DEV fq2h h_add(const fq2h& a, const fq2h& b) {
    return fq2h{{fq_add(a.v[0], b.v[0]), fq_add(a.v[1], b.v[1])}};
}
DEV fq2h h_sub(const fq2h& a, const fq2h& b) {
    return fq2h{{fq_sub(a.v[0], b.v[0]), fq_sub(a.v[1], b.v[1])}};
}
DEV fq2h h_neg(const fq2h& a) { return fq2h{{fq_neg(a.v[0]), fq_neg(a.v[1])}}; }
DEV fq2h h_mul12c(const fq2h& a) { return fq2h{{fq_mul12(a.v[0]), fq_mul12(a.v[1])}}; }
DEV fq2h h_cmov(bool take, const fq2h& a, const fq2h& b) {
    return fq2h{{fp_cmov<Fq>(take, a.v[0], b.v[0]), fp_cmov<Fq>(take, a.v[1], b.v[1])}};
}
template <class M>
DEV fq2h h_mulc(const fq2h& a, const fq2h& b) {
    return fq2h{{M::mul(a.v[0], b.v[0]), M::mul(a.v[1], b.v[1])}};
}

DEV fq2h h_zero(const pair_ctx&) { return fq2h{{fp_zero<Fq>(), fp_zero<Fq>()}}; }
DEV fq2h h_one(const pair_ctx&) { return fq2h{{fp_one<Fq>(), fp_zero<Fq>()}}; }

DEV fq2h h_load(const pair_ctx&, const uint32_t* base, size_t n, size_t idx) {
    return fq2h{{fp_load<Fq>(base, 2 * n, idx), fp_load<Fq>(base + n, 2 * n, idx)}};
}
DEV void h_store(const pair_ctx&, uint32_t* base, size_t n, size_t idx, const fq2h& a) {
    fp_store<Fq>(base, 2 * n, idx, a.v[0]);
    fp_store<Fq>(base + n, 2 * n, idx, a.v[1]);
}

#endif

// The Fq2 product: a0 b0 - a1 b1 on the even thread, a1 b0 + a0 b1 on the
// odd one, each two Fq products after the exchange.
template <class M>
DEV fq2h h_mul(const pair_ctx& c, const fq2h& a, const fq2h& b) {
    fq2h a_ = h_swap(c, a), b_ = h_swap(c, b);
    fq2h x = h_mulc<M>(a, h_sel(c, b, b_));      // a0 b0 | a1 b0
    fq2h y = h_mulc<M>(a_, h_sel(c, b_, b));     // a1 b1 | a0 b1
    return h_sel(c, h_sub(x, y), h_add(x, y));
}

// fq2_mul12: 12(c0 - c1) on the even thread, 12(c0 + c1) on the odd one.
DEV fq2h h_mul12(const pair_ctx& c, const fq2h& a) {
    fq2h o = h_swap(c, a);
    return h_mul12c(h_sel(c, h_sub(a, o), h_add(o, a)));
}

struct HPoint {
    fq2h X, Y, Z;
};

// P + (x2, y2) on a pair.  The products with X and x2 first, then those with
// Y and y2, so that the operand and X, Y are dead before mul12(Z).  The last
// six products come from six values a = t3, b = t1 - 3b' t2, c = t5,
// d = 3b' t4, e = t1 + 3b' t2, f = 3 t0 (3b' t is h_mul12):
//   X3 = ab - cd,  Y3 = be + df,  Z3 = ec + fa;
// each value is in two of them, and taken around that cycle (ab, be, ec, cd,
// df, fa), b, e, c and d each die with their second product.
template <class M>
DEV HPoint h_proj_madd(const pair_ctx& c, const HPoint& P, const fq2h& x2,
                       const fq2h& y2) {
    fq2h t0 = h_mul<M>(c, P.X, x2);
    fq2h t3 = h_mul<M>(c, h_add(P.X, P.Y), h_add(x2, y2));
    fq2h t4 = h_add(h_mul<M>(c, x2, P.Z), P.X);
    fq2h t1 = h_mul<M>(c, P.Y, y2);
    fq2h t5 = h_add(h_mul<M>(c, y2, P.Z), P.Y);
    t3 = h_sub(t3, h_add(t0, t1));
    fq2h t0_3 = h_add(h_add(t0, t0), t0);
    fq2h t2 = h_mul12(c, P.Z);
    fq2h b = h_sub(t1, t2), d = h_mul12(c, t4), e = h_add(t1, t2);
    fq2h ab = h_mul<M>(c, t3, b);
    fq2h be = h_mul<M>(c, b, e);
    fq2h ec = h_mul<M>(c, e, t5);
    HPoint R;
    R.X = h_sub(ab, h_mul<M>(c, t5, d));
    R.Y = h_add(be, h_mul<M>(c, d, t0_3));
    R.Z = h_add(ec, h_mul<M>(c, t0_3, t3));
    return R;
}

DEV HPoint h_load_point(const pair_ctx& c, const uint32_t* X, const uint32_t* Y,
                        const uint32_t* Z, size_t n, size_t idx) {
    return HPoint{h_load(c, X, n, idx), h_load(c, Y, n, idx), h_load(c, Z, n, idx)};
}

DEV void h_store_point(const pair_ctx& c, uint32_t* X, uint32_t* Y, uint32_t* Z,
                       size_t n, size_t idx, const HPoint& P) {
    h_store(c, X, n, idx, P.X);
    h_store(c, Y, n, idx, P.Y);
    h_store(c, Z, n, idx, P.Z);
}

// The pair of lane idx: from the accumulator acc_* (or, where acc_* is null,
// the identity (0 : 1 : 0)), R signed mixed adds down the rows of the x2/y2
// tile (rows `row_stride` slots apart, a row a (24, 2, L) block), every
// prefix written to the contiguous (R, 24, 2, L) outputs.  A row whose point
// is the identity (inf2) skips the add and keeps the accumulator, which is
// the select of the JAX kernel.  `ctx_for(take)` gives the pair's context for
// a row from whether it adds (on the card: the ballot of the warp's pairs
// that do, which every thread of the warp runs); `live` is false past the
// last lane, where a thread only takes part in the ballots.
template <class Ctx>
DEV void g2_pmadd_pair_lane(const uint32_t* accX, const uint32_t* accY,
                            const uint32_t* accZ, const uint32_t* x2,
                            const uint32_t* y2, size_t row_stride,
                            const uint8_t* inf2, const uint8_t* sign,
                            uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                            size_t L, int R, size_t idx, bool live, Ctx ctx_for) {
    const pair_ctx c0 = ctx_for(false);
    HPoint acc{h_zero(c0), h_one(c0), h_zero(c0)};
    if (live && accX) acc = h_load_point(c0, accX, accY, accZ, L, idx);
    const size_t out_stride = (size_t)2 * Fq::K * L;
    ROLLED
    for (int r = 0; r < R; ++r) {
        bool take = live && inf2[(size_t)r * L + idx] == 0;
        const pair_ctx c = ctx_for(take);
        if (take) {
            bool is_neg = sign[(size_t)r * L + idx] != 0;
            fq2h x = h_load(c, x2 + (size_t)r * row_stride, L, idx);
            fq2h y = h_load(c, y2 + (size_t)r * row_stride, L, idx);
            acc = h_proj_madd<CarryMul>(c, acc, x, h_cmov(is_neg, h_neg(y), y));
        }
        if (live)
            h_store_point(c, X3 + (size_t)r * out_stride, Y3 + (size_t)r * out_stride,
                          Z3 + (size_t)r * out_stride, L, idx, acc);
    }
}
