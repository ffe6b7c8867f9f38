// Complete homogeneous-projective group law for G2 (y^2 = x^3 + 4(1+u) over
// Fq2 = Fq[u]/(u^2+1)), Renes-Costello-Batina 2016, a = 0, 3b' = 12(1+u).
// One point operation per thread; the mixed add of the scan runs on two
// threads a lane (g2_pair.cuh).
//
// Fq2 arithmetic and the formulas follow the JAX package's
// curves/pallas_g2.py operation by operation (_k2_mul: Karatsuba, three Fq
// products; _k2_sqr: complex squaring, two; _k2_mul12; _k2_proj_add,
// _k2_proj_dbl), so that with canonical field results the coordinates
// written back equal the plain PyTorch versions in curves/projective.py over
// FQ2_PLAIN limb for limb.  The Fq2 product and square and the formulas take
// their Fq product as a parameter (g1.cuh's policies); the kernels run them
// on the carry-chain product (CarryMul: padd2, padd2_scan, pdbl2).  Both
// products are canonical, so the limbs are the same either way.
//
// A G2 point is 72 words, and a formula holds several Fq2 temporaries beside
// it, so at 255 registers a thread the order of the products decides what
// spills.  Each formula takes its products so that operands die early: the
// products of one coordinate together, the others after.  Every value is the
// formula's (field results are canonical, so the order of additions does not
// change a limb).
//
// Stored layout of an Fq2 batch: (24, 2, n) int32, limbs first, then the
// component (c0, c1), then the lanes.  Limb k of component c of lane idx is
// at (2k + c) * n + idx: each component is a limbs-first Fq batch whose planes
// are 2n slots apart, c1 starting n slots after c0.

#pragma once

#include "g1.cuh"

struct fq2 {
    fq c0, c1;
};

struct G2Proj {
    fq2 X, Y, Z;
};

DEV fq2 fq2_add(const fq2& a, const fq2& b) {
    fq2 r;
    r.c0 = fq_add(a.c0, b.c0);
    r.c1 = fq_add(a.c1, b.c1);
    return r;
}

DEV fq2 fq2_sub(const fq2& a, const fq2& b) {
    fq2 r;
    r.c0 = fq_sub(a.c0, b.c0);
    r.c1 = fq_sub(a.c1, b.c1);
    return r;
}

// Karatsuba: v0 = a0 b0, v1 = a1 b1; real = v0 - v1,
// imaginary = (a0 + a1)(b0 + b1) - v0 - v1.
template <class M>
DEV fq2 fq2_mul(const fq2& a, const fq2& b) {
    fq v0 = M::mul(a.c0, b.c0);
    fq v1 = M::mul(a.c1, b.c1);
    fq s = M::mul(fq_add(a.c0, a.c1), fq_add(b.c0, b.c1));
    fq2 r;
    r.c0 = fq_sub(v0, v1);
    r.c1 = fq_sub(fq_sub(s, v0), v1);
    return r;
}

// (a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u: two products, no Fq square.
template <class M>
DEV fq2 fq2_sqr(const fq2& a) {
    fq2 r;
    r.c0 = M::mul(fq_add(a.c0, a.c1), fq_sub(a.c0, a.c1));
    fq m = M::mul(a.c0, a.c1);
    r.c1 = fq_add(m, m);
    return r;
}

// 3b' = 12(1+u): (c0, c1) -> (12 (c0 - c1), 12 (c0 + c1)).
DEV fq2 fq2_mul12(const fq2& a) {
    fq2 r;
    r.c0 = fq_mul12(fq_sub(a.c0, a.c1));
    r.c1 = fq_mul12(fq_add(a.c0, a.c1));
    return r;
}

DEV fq2 fq2_load(const uint32_t* base, size_t n, size_t idx) {
    fq2 r;
    r.c0 = fp_load<Fq>(base, 2 * n, idx);
    r.c1 = fp_load<Fq>(base + n, 2 * n, idx);
    return r;
}

DEV void fq2_store(uint32_t* base, size_t n, size_t idx, const fq2& a) {
    fp_store<Fq>(base, 2 * n, idx, a.c0);
    fp_store<Fq>(base + n, 2 * n, idx, a.c1);
}

DEV G2Proj g2_identity() {
    G2Proj P;
    P.X.c0 = fp_zero<Fq>();
    P.X.c1 = fp_zero<Fq>();
    P.Y.c0 = fp_one<Fq>();
    P.Y.c1 = fp_zero<Fq>();
    P.Z.c0 = fp_zero<Fq>();
    P.Z.c1 = fp_zero<Fq>();
    return P;
}

// Algorithm 7: complete addition, 12 Fq2 products + 2 mul12.  X's three
// products first, then Y's, then Z's (as g1_proj_add): a coordinate pair
// dies with its third product.
template <class M>
DEV G2Proj g2_proj_add(const G2Proj& P, const G2Proj& Q) {
    fq2 t0 = fq2_mul<M>(P.X, Q.X);
    fq2 m3 = fq2_mul<M>(fq2_add(P.X, P.Y), fq2_add(Q.X, Q.Y));   // (X1+Y1)(X2+Y2)
    fq2 my = fq2_mul<M>(fq2_add(P.X, P.Z), fq2_add(Q.X, Q.Z));   // (X1+Z1)(X2+Z2)
    fq2 m4 = fq2_mul<M>(fq2_add(P.Y, P.Z), fq2_add(Q.Y, Q.Z));   // (Y1+Z1)(Y2+Z2)
    fq2 t1 = fq2_mul<M>(P.Y, Q.Y);
    fq2 t3 = fq2_sub(m3, fq2_add(t0, t1));
    fq2 t2 = fq2_mul<M>(P.Z, Q.Z);
    fq2 t4 = fq2_sub(m4, fq2_add(t1, t2));
    fq2 ty = fq2_sub(my, fq2_add(t0, t2));
    fq2 t0_3 = fq2_add(fq2_add(t0, t0), t0);
    t2 = fq2_mul12(t2);
    fq2 Z3 = fq2_add(t1, t2);
    t1 = fq2_sub(t1, t2);
    fq2 Y3 = fq2_mul12(ty);
    G2Proj R;
    R.X = fq2_sub(fq2_mul<M>(t3, t1), fq2_mul<M>(t4, Y3));
    R.Y = fq2_add(fq2_mul<M>(t1, Z3), fq2_mul<M>(Y3, t0_3));
    R.Z = fq2_add(fq2_mul<M>(Z3, t4), fq2_mul<M>(t0_3, t3));
    return R;
}

// Algorithm 9: complete doubling, 6 Fq2 products + 2 complex squares + mul12.
// X*Y is taken first: X is read nowhere else, so it dies at the top and the
// live set through the rest is Y, Z and that product.  The products, their
// operands and their association are the formula's, so the values are too.
template <class M>
DEV G2Proj g2_proj_dbl(const G2Proj& P) {
    fq2 xy = fq2_mul<M>(P.X, P.Y);
    fq2 t0 = fq2_sqr<M>(P.Y);
    fq2 Z3 = fq2_add(t0, t0);
    Z3 = fq2_add(Z3, Z3);
    Z3 = fq2_add(Z3, Z3);                          // 8 Y^2
    fq2 t1 = fq2_mul<M>(P.Y, P.Z);
    fq2 t2 = fq2_mul12(fq2_sqr<M>(P.Z));           // 3b' Z^2
    fq2 X3 = fq2_mul<M>(t2, Z3);
    fq2 Y3 = fq2_add(t0, t2);
    G2Proj R;
    R.Z = fq2_mul<M>(t1, Z3);
    t2 = fq2_add(fq2_add(t2, t2), t2);             // 9b' Z^2
    t0 = fq2_sub(t0, t2);
    R.Y = fq2_add(fq2_mul<M>(t0, Y3), X3);
    fq2 t = fq2_mul<M>(t0, xy);
    R.X = fq2_add(t, t);
    return R;
}

DEV G2Proj g2_load(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                   size_t n, size_t idx) {
    G2Proj P;
    P.X = fq2_load(X, n, idx);
    P.Y = fq2_load(Y, n, idx);
    P.Z = fq2_load(Z, n, idx);
    return P;
}

DEV void g2_store(uint32_t* X, uint32_t* Y, uint32_t* Z, size_t n, size_t idx,
                  const G2Proj& P) {
    fq2_store(X, n, idx, P.X);
    fq2_store(Y, n, idx, P.Y);
    fq2_store(Z, n, idx, P.Z);
}

// ---------------------------------------------------------------------------
// Lane bodies: what one thread does (see g1.cuh).
// ---------------------------------------------------------------------------

DEV void g2_padd_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx) {
    G2Proj P = g2_load(X1, Y1, Z1, n, idx);
    G2Proj Q = g2_load(X2, Y2, Z2, n, idx);
    g2_store(X3, Y3, Z3, n, idx, g2_proj_add<CarryMul>(P, Q));
}

// The doubling chain: the lane loaded once, doubled `times` times in
// registers on the carry-chain product, stored once (times = 1: the
// elementwise doubling), as g1_pdbl_lane.
DEV void g2_pdbl_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx, int times) {
    G2Proj P = g2_load(X1, Y1, Z1, n, idx);
    ROLLED
    for (int k = 0; k < times; ++k) P = g2_proj_dbl<CarryMul>(P);
    g2_store(X3, Y3, Z3, n, idx, P);
}

// The point type of the lane scan (lane_scan.cuh: padd2_scan in g2_padd_scan.cu),
// as G1Curve in g1.cuh: 72 words a point, held in shared memory as 72
// planes of T words.
struct G2Curve {
    typedef G2Proj P;
    static constexpr int WORDS = 72;
    static DEV P identity() { return g2_identity(); }
    static DEV P add(const P& a, const P& b) { return g2_proj_add<CarryMul>(a, b); }
    static DEV P load(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                      size_t n, size_t idx) {
        return g2_load(X, Y, Z, n, idx);
    }
    static DEV void store(uint32_t* X, uint32_t* Y, uint32_t* Z, size_t n, size_t idx,
                          const P& a) {
        g2_store(X, Y, Z, n, idx, a);
    }
    static DEV void put_fq(uint32_t* sh, unsigned T, unsigned t, int k, const fq& a) {
        UNROLL
        for (int w = 0; w < 12; ++w) sh[(12 * k + w) * T + t] = a.v[w];
    }
    static DEV fq get_fq(const uint32_t* sh, unsigned T, unsigned t, int k) {
        fq a;
        UNROLL
        for (int w = 0; w < 12; ++w) a.v[w] = sh[(12 * k + w) * T + t];
        return a;
    }
    static DEV void put(uint32_t* sh, unsigned T, unsigned t, const P& a) {
        put_fq(sh, T, t, 0, a.X.c0);
        put_fq(sh, T, t, 1, a.X.c1);
        put_fq(sh, T, t, 2, a.Y.c0);
        put_fq(sh, T, t, 3, a.Y.c1);
        put_fq(sh, T, t, 4, a.Z.c0);
        put_fq(sh, T, t, 5, a.Z.c1);
    }
    static DEV P get(const uint32_t* sh, unsigned T, unsigned t) {
        P a;
        a.X.c0 = get_fq(sh, T, t, 0);
        a.X.c1 = get_fq(sh, T, t, 1);
        a.Y.c0 = get_fq(sh, T, t, 2);
        a.Y.c1 = get_fq(sh, T, t, 3);
        a.Z.c0 = get_fq(sh, T, t, 4);
        a.Z.c1 = get_fq(sh, T, t, 5);
        return a;
    }
};
