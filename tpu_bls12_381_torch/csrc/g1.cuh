// Complete homogeneous-projective group law for G1 (y^2 = x^3 + 4 over Fq),
// Renes-Costello-Batina 2016, a = 0, 3b = 12.  One point operation per thread.
//
// The formulas and their operation order are those of the JAX package's
// curves/pallas_g1.py (_k_mul12, _k_proj_add, _k_proj_madd, _k_proj_dbl),
// so that with canonical field results the coordinates written back equal
// the plain PyTorch versions in curves/projective.py limb for limb.  The
// complete addition takes the carry-chain Fq product of field_carry.cuh; the
// mixed addition takes its product as a parameter, field.cuh's (FieldMul,
// for pmadd) or the carry-chain one (CarryMul, for pmadd_signed); the
// doubling takes its product and square the same way and runs on CarryMul
// (pdbl).  Both products are canonical, so the limbs are the same either
// way.  The policies (FieldMul, CarryMul: a product and a square) also serve
// the Jacobian law of g1_jac.cuh and the Fq2 arithmetic of g2.cuh.

#pragma once

#include "field_carry.cuh"

typedef El<Fq> fq;

struct G1Proj {
    fq X, Y, Z;
};

DEV fq fq_mul(const fq& a, const fq& b) { return fp_mul<Fq>(a, b); }

struct FieldMul {
    static DEV fq mul(const fq& a, const fq& b) { return fp_mul<Fq>(a, b); }
    static DEV fq sqr(const fq& a) { return fp_sqr<Fq>(a); }
};
// The square as the product a*a: a canonical product is unique.
struct CarryMul {
    static DEV fq mul(const fq& a, const fq& b) { return fq_mul_cc(a, b); }
    static DEV fq sqr(const fq& a) { return fq_mul_cc(a, a); }
};
DEV fq fq_sqr(const fq& a) { return fp_sqr<Fq>(a); }
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
    g1_store(X3, Y3, Z3, n, idx, g1_proj_madd<FieldMul>(P, x, y, inf2[idx] != 0));
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

// ---------------------------------------------------------------------------
// The lane scan (padd_scan in g1_kernels.cu): RCB16 additions scanned along
// the last axis of `rows` rows of L lanes, coordinates (24, rows, L).
// Logical lane i of a row is physical lane i, or L - 1 - i for a suffix
// scan.  Thread t of block k owns the run of `run` logical lanes from
// (k * T + t) * run.  Three passes:
//  up     each thread folds its run; the block scans the run totals
//         (inclusive, in shared memory) and writes them to V (rows, nblk*T);
//  carry  one block a row scans the block totals V[., k*T + T - 1] the same
//         way (runs of run2) into exclusive block carries C (rows, nblk), and
//         the row's total;
//  down   each thread starts from C[k] + V[k*T + t - 1] (the identity for
//         t = 0) and walks its run again, writing every lane.
// A fold or a walk adds only what exists (lanes below L, blocks below nblk);
// a run with nothing in it is the identity.
// Every sum is the same association in curves/cuda_g1.py::padd_scan_plain.
// The bodies below are the serial parts; the block scans are in the kernels
// (and in host_check.cpp as a loop).
// ---------------------------------------------------------------------------

// The fold of a thread's run, in the up pass (lanes) and in the carry pass
// (block totals): `count` points from slot p0 of planes n slots apart, `step`
// slots apart (step 0xffffffff walks down), added in order; the identity for
// a run past the end (count 0).  32-bit slots: the wrapper keeps
// rows * nblk * T and rows * L below 2^31.
DEV G1Proj g1_scan_fold(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                        uint32_t n, uint32_t p0, uint32_t step, uint32_t count) {
    if (count == 0) return g1_identity();
    G1Proj acc = g1_load(X, Y, Z, n, p0);
    uint32_t p = p0;
    ROLLED
    for (uint32_t j = 1; j < count; ++j) {
        p += step;
        acc = g1_proj_add(acc, g1_load(X, Y, Z, n, p));
    }
    return acc;
}

// The up pass's run of thread t of block k: lanes i0 = (k*T + t)*run on.
DEV G1Proj g1_scan_fold_lanes(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                              uint32_t L, uint32_t rows, uint32_t b, uint32_t i0,
                              uint32_t run, bool reverse) {
    uint32_t count = i0 < L ? (L - i0 < run ? L - i0 : run) : 0u;
    return g1_scan_fold(X, Y, Z, rows * L, b * L + (reverse ? L - 1u - i0 : i0),
                        reverse ? 0xffffffffu : 1u, count);
}

// The carry pass's run of thread t: block totals q0 = t*run2 on, which lie
// at V[., q*T + T - 1].
DEV G1Proj g1_scan_fold_totals(const uint32_t* VX, const uint32_t* VY,
                               const uint32_t* VZ, uint32_t rows, uint32_t nblk,
                               uint32_t T, uint32_t b, uint32_t q0, uint32_t run2) {
    uint32_t count = q0 < nblk ? (nblk - q0 < run2 ? nblk - q0 : run2) : 0u;
    return g1_scan_fold(VX, VY, VZ, rows * nblk * T, (b * nblk + q0) * T + T - 1u, T,
                        count);
}

// The down pass's walk of one run from its carry-in `acc`.
DEV void g1_scan_walk(G1Proj acc, const uint32_t* X, const uint32_t* Y,
                      const uint32_t* Z, uint32_t* OX, uint32_t* OY, uint32_t* OZ,
                      size_t L, size_t n, size_t b, size_t i0, int run,
                      bool reverse, bool exclusive) {
    ROLLED
    for (int j = 0; j < run; ++j) {
        size_t i = i0 + j;
        if (i >= L) break;
        size_t p = b * L + (reverse ? L - 1 - i : i);
        G1Proj x = g1_load(X, Y, Z, n, p);
        if (exclusive) g1_store(OX, OY, OZ, n, p, acc);
        acc = g1_proj_add(acc, x);
        if (!exclusive) g1_store(OX, OY, OZ, n, p, acc);
    }
}

// The carry pass's walk: the exclusive carry of every block of the run.
DEV void g1_scan_carry_walk(G1Proj acc, const uint32_t* VX, const uint32_t* VY,
                            const uint32_t* VZ, uint32_t* CX, uint32_t* CY,
                            uint32_t* CZ, size_t rows, size_t nblk, size_t T,
                            size_t b, size_t q0, int run2) {
    ROLLED
    for (int j = 0; j < run2; ++j) {
        size_t q = q0 + j;
        if (q >= nblk) break;
        g1_store(CX, CY, CZ, rows * nblk, b * nblk + q, acc);
        acc = g1_proj_add(
            acc, g1_load(VX, VY, VZ, rows * nblk * T, (b * nblk + q) * T + T - 1));
    }
}

// The down pass's carry-in of thread t of block k.
DEV G1Proj g1_scan_carry_in(const uint32_t* VX, const uint32_t* VY,
                            const uint32_t* VZ, const uint32_t* CX,
                            const uint32_t* CY, const uint32_t* CZ, size_t rows,
                            size_t nblk, size_t T, size_t b, size_t k, size_t t) {
    G1Proj before = t > 0 ? g1_load(VX, VY, VZ, rows * nblk * T, (b * nblk + k) * T + t - 1)
                          : g1_identity();
    return g1_proj_add(g1_load(CX, CY, CZ, rows * nblk, b * nblk + k), before);
}
