// Complete homogeneous-projective group law for G2 (y^2 = x^3 + 4(1+u) over
// Fq2 = Fq[u]/(u^2+1)), Renes-Costello-Batina 2016, a = 0, 3b' = 12(1+u).
// One point operation per thread.
//
// Fq2 arithmetic and the three formulas follow the JAX package's
// curves/pallas_g2.py operation by operation (_k2_mul: Karatsuba, three Fq
// products; _k2_sqr: complex squaring, two; _k2_mul12; _k2_proj_add,
// _k2_proj_madd, _k2_proj_dbl), so that with canonical field results the
// coordinates written back equal the plain PyTorch versions in
// curves/projective.py over FQ2_PLAIN limb for limb.  The Fq2 product and
// square take their Fq product as a parameter (g1.cuh's policies): the
// doubling runs on the carry-chain product (CarryMul, pdbl2), the two adds on
// field.cuh's (FieldMul, pmadd2 and padd2).  Both products are canonical, so
// the limbs are the same either way.
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

DEV fq2 fq2_neg(const fq2& a) {
    fq2 r;
    r.c0 = fq_neg(a.c0);
    r.c1 = fq_neg(a.c1);
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

DEV fq2 fq2_cmov(bool take, const fq2& a, const fq2& b) {
    fq2 r;
    r.c0 = fp_cmov<Fq>(take, a.c0, b.c0);
    r.c1 = fp_cmov<Fq>(take, a.c1, b.c1);
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

// Algorithm 7: complete addition, 12 Fq2 products + 2 mul12.
DEV G2Proj g2_proj_add(const G2Proj& P, const G2Proj& Q) {
    fq2 t0 = fq2_mul<FieldMul>(P.X, Q.X);
    fq2 t1 = fq2_mul<FieldMul>(P.Y, Q.Y);
    fq2 t2 = fq2_mul<FieldMul>(P.Z, Q.Z);
    fq2 t3 = fq2_sub(fq2_mul<FieldMul>(fq2_add(P.X, P.Y), fq2_add(Q.X, Q.Y)),
                     fq2_add(t0, t1));
    fq2 t4 = fq2_sub(fq2_mul<FieldMul>(fq2_add(P.Y, P.Z), fq2_add(Q.Y, Q.Z)),
                     fq2_add(t1, t2));
    fq2 ty = fq2_sub(fq2_mul<FieldMul>(fq2_add(P.X, P.Z), fq2_add(Q.X, Q.Z)),
                     fq2_add(t0, t2));
    fq2 t0_3 = fq2_add(fq2_add(t0, t0), t0);
    t2 = fq2_mul12(t2);
    fq2 Z3 = fq2_add(t1, t2);
    t1 = fq2_sub(t1, t2);
    fq2 Y3 = fq2_mul12(ty);
    G2Proj R;
    R.X = fq2_sub(fq2_mul<FieldMul>(t3, t1), fq2_mul<FieldMul>(t4, Y3));
    R.Y = fq2_add(fq2_mul<FieldMul>(t1, Z3), fq2_mul<FieldMul>(Y3, t0_3));
    R.Z = fq2_add(fq2_mul<FieldMul>(Z3, t4), fq2_mul<FieldMul>(t0_3, t3));
    return R;
}

// Algorithm 8: complete mixed addition (Z2 = 1), 11 Fq2 products + 2 mul12.
// The affine encoding cannot hold the identity, so `inf2` passes P through.
DEV G2Proj g2_proj_madd(const G2Proj& P, const fq2& x2, const fq2& y2, bool inf2) {
    fq2 t0 = fq2_mul<FieldMul>(P.X, x2);
    fq2 t1 = fq2_mul<FieldMul>(P.Y, y2);
    fq2 t3 = fq2_sub(fq2_mul<FieldMul>(fq2_add(P.X, P.Y), fq2_add(x2, y2)),
                     fq2_add(t0, t1));
    fq2 t4 = fq2_add(fq2_mul<FieldMul>(x2, P.Z), P.X);
    fq2 t5 = fq2_add(fq2_mul<FieldMul>(y2, P.Z), P.Y);
    fq2 t0_3 = fq2_add(fq2_add(t0, t0), t0);
    fq2 t2 = fq2_mul12(P.Z);
    fq2 Z3 = fq2_add(t1, t2);
    t1 = fq2_sub(t1, t2);
    fq2 Y3 = fq2_mul12(t4);
    G2Proj R;
    R.X = fq2_cmov(inf2, P.X,
                   fq2_sub(fq2_mul<FieldMul>(t3, t1), fq2_mul<FieldMul>(t5, Y3)));
    R.Y = fq2_cmov(inf2, P.Y,
                   fq2_add(fq2_mul<FieldMul>(t1, Z3), fq2_mul<FieldMul>(Y3, t0_3)));
    R.Z = fq2_cmov(inf2, P.Z,
                   fq2_add(fq2_mul<FieldMul>(Z3, t5), fq2_mul<FieldMul>(t0_3, t3)));
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

// acc_* may be null: the accumulator then starts at the identity (0 : 1 : 0).
// x2/y2 rows are `row_stride` slots apart (two halves of one (R, 96, L)
// tile); a row is a (24, 2, L) block.  The outputs are contiguous
// (R, 24, 2, L).
DEV void g2_pmadd_lane(const uint32_t* accX, const uint32_t* accY,
                       const uint32_t* accZ, const uint32_t* x2,
                       const uint32_t* y2, size_t row_stride,
                       const uint8_t* inf2, const uint8_t* sign,
                       uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                       size_t L, int R, size_t idx) {
    G2Proj acc = accX ? g2_load(accX, accY, accZ, L, idx) : g2_identity();
    const size_t out_stride = (size_t)2 * Fq::K * L;
    for (int r = 0; r < R; ++r) {
        fq2 x = fq2_load(x2 + (size_t)r * row_stride, L, idx);
        fq2 y = fq2_load(y2 + (size_t)r * row_stride, L, idx);
        bool is_inf = inf2[(size_t)r * L + idx] != 0;
        bool is_neg = sign[(size_t)r * L + idx] != 0;
        y = fq2_cmov(is_neg, fq2_neg(y), y);
        acc = g2_proj_madd(acc, x, y, is_inf);
        g2_store(X3 + (size_t)r * out_stride, Y3 + (size_t)r * out_stride,
                 Z3 + (size_t)r * out_stride, L, idx, acc);
    }
}

DEV void g2_padd_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx) {
    G2Proj P = g2_load(X1, Y1, Z1, n, idx);
    G2Proj Q = g2_load(X2, Y2, Z2, n, idx);
    g2_store(X3, Y3, Z3, n, idx, g2_proj_add(P, Q));
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
