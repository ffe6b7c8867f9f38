// Complete homogeneous-projective group law for G1 (y^2 = x^3 + 4 over Fq),
// Renes-Costello-Batina 2016, a = 0, 3b = 12.  One point operation per thread.
//
// The formulas and their operation order are those of the JAX package's
// curves/pallas_g1.py (_k_mul12, _k_proj_add, _k_proj_madd, _k_proj_dbl),
// so that with canonical field results the coordinates written back equal
// the plain PyTorch versions in curves/projective.py limb for limb.  The
// complete addition takes the carry-chain Fq product of field_carry.cuh; the
// mixed addition and the doubling take their product (and square) as a
// parameter, and every G1 kernel runs them on the carry-chain one
// (CarryMul).  The policy (a product and a square) also serves the Jacobian
// law of g1_jac.cuh and the Fq2 arithmetic of g2.cuh.

#pragma once

#include "field_carry.cuh"

typedef El<Fq> fq;

struct G1Proj {
    fq X, Y, Z;
};

// The square as the product a*a: a canonical product is unique.
struct CarryMul {
    static DEV fq mul(const fq& a, const fq& b) { return fq_mul_cc(a, b); }
    static DEV fq sqr(const fq& a) { return fq_mul_cc(a, a); }
};
DEV fq fq_add(const fq& a, const fq& b) { return fp_add<Fq>(a, b); }
DEV fq fq_sub(const fq& a, const fq& b) { return fp_sub<Fq>(a, b); }
DEV fq fq_neg(const fq& a) { return fp_neg<Fq>(a); }

// 12a = 4 * 3a by additions (3b for b = 4); stays reduced.
DEV fq fq_mul12(const fq& a) {
    fq t = fq_add(fq_add(a, a), a);
    t = fq_add(t, t);
    return fq_add(t, t);
}

DEV G1Proj g1_identity() {
    G1Proj P;
    P.X = fp_zero<Fq>();
    P.Y = fp_one<Fq>();
    P.Z = fp_zero<Fq>();
    return P;
}

// Algorithm 7: complete addition, 12M + 2 mul12.  The products are taken
// so that the operands die early (X's three first, then Y's and Z's), which
// keeps the live set under the product's own registers; each value is the
// formula's, so the limbs are too.
DEV G1Proj g1_proj_add(const G1Proj& P, const G1Proj& Q) {
    fq t0 = fq_mul_cc(P.X, Q.X);
    fq m3 = fq_mul_cc(fq_add(P.X, P.Y), fq_add(Q.X, Q.Y));   // (X1+Y1)(X2+Y2)
    fq my = fq_mul_cc(fq_add(P.X, P.Z), fq_add(Q.X, Q.Z));   // (X1+Z1)(X2+Z2)
    fq m4 = fq_mul_cc(fq_add(P.Y, P.Z), fq_add(Q.Y, Q.Z));   // (Y1+Z1)(Y2+Z2)
    fq t1 = fq_mul_cc(P.Y, Q.Y);
    fq t2 = fq_mul_cc(P.Z, Q.Z);
    fq t3 = fq_sub(m3, fq_add(t0, t1));
    fq t4 = fq_sub(m4, fq_add(t1, t2));
    fq ty = fq_sub(my, fq_add(t0, t2));
    fq t0_3 = fq_add(fq_add(t0, t0), t0);
    t2 = fq_mul12(t2);
    fq Z3 = fq_add(t1, t2);
    t1 = fq_sub(t1, t2);
    fq Y3 = fq_mul12(ty);
    G1Proj R;
    R.X = fq_sub(fq_mul_cc(t3, t1), fq_mul_cc(t4, Y3));
    R.Y = fq_add(fq_mul_cc(t1, Z3), fq_mul_cc(Y3, t0_3));
    R.Z = fq_add(fq_mul_cc(Z3, t4), fq_mul_cc(t0_3, t3));
    return R;
}

// Algorithm 8: complete mixed addition (Z2 = 1), 11M + 2 mul12.  The affine
// encoding cannot hold the identity, so `inf2` passes P through.
template <class M>
DEV G1Proj g1_proj_madd(const G1Proj& P, const fq& x2, const fq& y2, bool inf2) {
    fq t0 = M::mul(P.X, x2);
    fq t1 = M::mul(P.Y, y2);
    fq t3 = fq_sub(M::mul(fq_add(P.X, P.Y), fq_add(x2, y2)), fq_add(t0, t1));
    fq t4 = fq_add(M::mul(x2, P.Z), P.X);
    fq t5 = fq_add(M::mul(y2, P.Z), P.Y);
    fq t0_3 = fq_add(fq_add(t0, t0), t0);
    fq t2 = fq_mul12(P.Z);
    fq Z3 = fq_add(t1, t2);
    t1 = fq_sub(t1, t2);
    fq Y3 = fq_mul12(t4);
    G1Proj R;
    R.X = fp_cmov<Fq>(inf2, P.X, fq_sub(M::mul(t3, t1), M::mul(t5, Y3)));
    R.Y = fp_cmov<Fq>(inf2, P.Y, fq_add(M::mul(t1, Z3), M::mul(Y3, t0_3)));
    R.Z = fp_cmov<Fq>(inf2, P.Z, fq_add(M::mul(Z3, t5), M::mul(t0_3, t3)));
    return R;
}

// Algorithm 9: complete doubling, 6M + 2S + mul12.
template <class M>
DEV G1Proj g1_proj_dbl(const G1Proj& P) {
    fq t0 = M::sqr(P.Y);
    fq Z3 = fq_add(t0, t0);
    Z3 = fq_add(Z3, Z3);
    Z3 = fq_add(Z3, Z3);                       // 8 Y^2
    fq t1 = M::mul(P.Y, P.Z);
    fq t2 = fq_mul12(M::sqr(P.Z));             // 3b Z^2
    fq X3 = M::mul(t2, Z3);
    fq Y3 = fq_add(t0, t2);
    G1Proj R;
    R.Z = M::mul(t1, Z3);
    t2 = fq_add(fq_add(t2, t2), t2);           // 9b Z^2
    t0 = fq_sub(t0, t2);
    R.Y = fq_add(M::mul(t0, Y3), X3);
    fq t = M::mul(t0, M::mul(P.X, P.Y));
    R.X = fq_add(t, t);
    return R;
}

DEV G1Proj g1_load(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                   size_t n, size_t idx) {
    G1Proj P;
    P.X = fp_load<Fq>(X, n, idx);
    P.Y = fp_load<Fq>(Y, n, idx);
    P.Z = fp_load<Fq>(Z, n, idx);
    return P;
}

DEV void g1_store(uint32_t* X, uint32_t* Y, uint32_t* Z, size_t n, size_t idx,
                  const G1Proj& P) {
    fp_store<Fq>(X, n, idx, P.X);
    fp_store<Fq>(Y, n, idx, P.Y);
    fp_store<Fq>(Z, n, idx, P.Z);
}

// ---------------------------------------------------------------------------
// Lane bodies: what one thread does.  The kernels in g1_kernels.cu call them
// with the thread's index; host_check.cpp calls them in a loop on a CPU.
// ---------------------------------------------------------------------------

// acc_* may be null: the accumulator then starts at the identity (0 : 1 : 0).
// x2/y2 rows are `row_stride` slots apart (they may be two halves of one
// (R, 48, L) tile); the limb planes inside a row are L slots apart.  The
// outputs are contiguous (R, 24, L).
DEV void g1_pmadd_signed_lane(const uint32_t* accX, const uint32_t* accY,
                              const uint32_t* accZ, const uint32_t* x2,
                              const uint32_t* y2, size_t row_stride,
                              const uint8_t* inf2, const uint8_t* sign,
                              uint32_t* X3, uint32_t* Y3, uint32_t* Z3,
                              size_t L, int R, size_t idx) {
    G1Proj acc = accX ? g1_load(accX, accY, accZ, L, idx) : g1_identity();
    const size_t out_stride = (size_t)Fq::K * L;
    for (int r = 0; r < R; ++r) {
        fq x = fp_load<Fq>(x2 + (size_t)r * row_stride, L, idx);
        fq y = fp_load<Fq>(y2 + (size_t)r * row_stride, L, idx);
        bool is_inf = inf2[(size_t)r * L + idx] != 0;
        bool is_neg = sign[(size_t)r * L + idx] != 0;
        acc = g1_proj_madd<CarryMul>(acc, x, fp_cmov<Fq>(is_neg, fq_neg(y), y), is_inf);
        g1_store(X3 + (size_t)r * out_stride, Y3 + (size_t)r * out_stride,
                 Z3 + (size_t)r * out_stride, L, idx, acc);
    }
}

// The mixed add without the sign: P + A, lanes with `inf2` pass P through.
DEV void g1_pmadd_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                       const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
                       uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                       size_t idx) {
    G1Proj P = g1_load(X1, Y1, Z1, n, idx);
    fq x = fp_load<Fq>(x2, n, idx);
    fq y = fp_load<Fq>(y2, n, idx);
    g1_store(X3, Y3, Z3, n, idx, g1_proj_madd<CarryMul>(P, x, y, inf2[idx] != 0));
}

// The joint double-and-add of glv.scalar_mul_glv for one lane, MSB first:
// k1 * A + k2 * phi(A), with phi(A) = (beta x, y).  A and beta x are loaded
// once; the accumulator starts at the identity and stays in registers for
// all num_bits steps, and is stored once.  Each step is the doubling, then
// the mixed add of A selected where bit b of k1 is set, then the mixed add of
// phi(A) selected where bit b of k2 is set: the formulas and their order of
// glv.py's loop, so the limbs are too.  The select is the mixed add's own
// pass-through mask: with `inf2` or the bit clear it returns acc, which is
// glv.py's select of the sum where the bit is set (lanes with inf2 pass acc
// through either way).
// Constant time: both adds run in every lane at every step and the selects
// are masks (fp_cmov), with no branch on a scalar bit, since the scalars are
// per lane and may be secret.  RCB16 algorithm 8 is complete, so no lane
// needs a doubling branch either.
// k1 is a (16, n) plane of 16-bit limbs, k2 a (k2_limbs, n) plane: the bits
// of k2 above 16 * k2_limbs read 0.  A limb is read once every 16 bits.
DEV void g1_glv_ladder_lane(const uint32_t* k1, const uint32_t* k2, int k2_limbs,
                            const uint32_t* x2, const uint32_t* y2,
                            const uint32_t* phi_x2, const uint8_t* inf2,
                            uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                            size_t idx, int num_bits) {
    bool inf = inf2[idx] != 0;
    const fq x = fp_load<Fq>(x2, n, idx), y = fp_load<Fq>(y2, n, idx);
    const fq phi_x = fp_load<Fq>(phi_x2, n, idx);
    G1Proj acc = g1_identity();
    uint32_t l1 = 0u, l2 = 0u;
    ROLLED
    for (int b = num_bits - 1; b >= 0; --b) {
        if (b == num_bits - 1 || (b & 15) == 15) {
            int j = b >> 4;
            l1 = k1[(size_t)j * n + idx];
            l2 = j < k2_limbs ? k2[(size_t)j * n + idx] : 0u;
        }
        bool b1 = ((l1 >> (b & 15)) & 1u) != 0u;
        bool b2 = ((l2 >> (b & 15)) & 1u) != 0u;
        acc = g1_proj_dbl<CarryMul>(acc);
        acc = g1_proj_madd<CarryMul>(acc, x, y, inf | !b1);
        acc = g1_proj_madd<CarryMul>(acc, phi_x, y, inf | !b2);
    }
    g1_store(X3, Y3, Z3, n, idx, acc);
}

DEV void g1_padd_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx) {
    G1Proj P = g1_load(X1, Y1, Z1, n, idx);
    G1Proj Q = g1_load(X2, Y2, Z2, n, idx);
    g1_store(X3, Y3, Z3, n, idx, g1_proj_add(P, Q));
}

// The doubling chain: the lane loaded once, doubled `times` times in
// registers, stored once (times = 1: the elementwise doubling).
DEV void g1_pdbl_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx, int times) {
    G1Proj P = g1_load(X1, Y1, Z1, n, idx);
    ROLLED
    for (int k = 0; k < times; ++k) P = g1_proj_dbl<CarryMul>(P);
    g1_store(X3, Y3, Z3, n, idx, P);
}

// The point type of the lane scan (lane_scan.cuh: padd_scan in
// g1_kernels.cu): 36 words a point, held in shared memory as 36 planes of T
// words, so that the threads of a warp touch neighbouring banks.
struct G1Curve {
    typedef G1Proj P;
    static constexpr int WORDS = 36;
    static DEV P identity() { return g1_identity(); }
    static DEV P add(const P& a, const P& b) { return g1_proj_add(a, b); }
    static DEV P load(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                      size_t n, size_t idx) {
        return g1_load(X, Y, Z, n, idx);
    }
    static DEV void store(uint32_t* X, uint32_t* Y, uint32_t* Z, size_t n, size_t idx,
                          const P& a) {
        g1_store(X, Y, Z, n, idx, a);
    }
    static DEV void put(uint32_t* sh, unsigned T, unsigned t, const P& a) {
        for (int w = 0; w < 12; ++w) {
            sh[w * T + t] = a.X.v[w];
            sh[(12 + w) * T + t] = a.Y.v[w];
            sh[(24 + w) * T + t] = a.Z.v[w];
        }
    }
    static DEV P get(const uint32_t* sh, unsigned T, unsigned t) {
        P a;
        for (int w = 0; w < 12; ++w) {
            a.X.v[w] = sh[w * T + t];
            a.Y.v[w] = sh[(12 + w) * T + t];
            a.Z.v[w] = sh[(24 + w) * T + t];
        }
        return a;
    }
};
