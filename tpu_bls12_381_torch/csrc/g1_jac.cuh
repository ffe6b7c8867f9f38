// Jacobian group law for G1 (y^2 = x^3 + 4 over Fq), a = 0, with the
// constant-time edge-case selections.  One point operation per thread, or one
// whole double-and-add ladder (g1_jac_ladder_lane).
//
// The formulas and the order of the selections are those of the JAX package's
// curves/pallas_g1.py (_k_dbl, _madd_kernel, _add_kernel), which are those of
// its curves/points.py (jac_double, jac_add_affine, jac_add): with canonical
// field results the coordinates written back equal the plain PyTorch versions
// in curves/points.py limb for limb.  Jacobian (X : Y : Z) is x = X/Z^2,
// y = Y/Z^3; the identity is any point with Z = 0, and the canonical one
// written here is (R mod p : R mod p : 0), the Montgomery one twice.
//
// The doubling and the adds take their Fq product and square as a parameter
// (g1.cuh's policies); every kernel runs them on the carry-chain product
// (CarryMul, its squares the products a*a).  The product is canonical, so
// the limbs are those of field.cuh's fp_mul.
//
// The edge cases (P == A, P == -A, an identity operand) pick between the
// generic sum and the doubling with fp_cmov, as the JAX formulas do, in the
// same order.  madd and jadd compute the doubling only in a warp that holds a
// P == A (P == Q) lane (WARP_ANY): every lane writes the value it would write
// with the doubling computed everywhere, but a call's time now depends on
// whether a warp holds such a lane.  The ladder adds only in a warp where a
// lane's bit is set, likewise.  Their callers are points.scalar_mul (hence
// is_in_subgroup, with the public scalar r and the public points of an SRS)
// and sum_reduce; the MSM never reaches them (it runs the projective
// pmadd_signed and pmadd of g1.cuh).
//
// fp_sub is canonical only for canonical operands.  Every operand here comes
// from a kernel, from g1.affine_from_ints or from the plain versions, all of
// which write canonical values, so every intermediate is canonical too.

#pragma once

#include "g1.cuh"

struct G1Jac {
    fq X, Y, Z;
};

DEV bool fq_is_zero(const fq& a) { return fp_is_zero<Fq>(a); }

DEV G1Jac g1_jac_cmov(bool take, const G1Jac& a, const G1Jac& b) {
    G1Jac r;
    r.X = fp_cmov<Fq>(take, a.X, b.X);
    r.Y = fp_cmov<Fq>(take, a.Y, b.Y);
    r.Z = fp_cmov<Fq>(take, a.Z, b.Z);
    return r;
}

// (1 : 1 : 0) in Montgomery form.
DEV G1Jac g1_jac_identity() {
    G1Jac r;
    r.X = fp_one<Fq>();
    r.Y = fp_one<Fq>();
    r.Z = fp_zero<Fq>();
    return r;
}

// dbl-2009-l (a = 0), 2M + 5S.  Complete for Z = 0: Z3 = 2YZ = 0.
template <class M>
DEV G1Jac g1_jac_dbl(const G1Jac& P) {
    fq A = M::sqr(P.X);
    fq B = M::sqr(P.Y);
    fq C = M::sqr(B);
    fq D = fq_sub(fq_sub(M::sqr(fq_add(P.X, B)), A), C);
    D = fq_add(D, D);
    fq E = fq_add(fq_add(A, A), A);                 // 3A
    fq G = M::sqr(E);
    G1Jac R;
    R.X = fq_sub(G, fq_add(D, D));
    fq C8 = fq_add(C, C);
    C8 = fq_add(C8, C8);
    C8 = fq_add(C8, C8);
    R.Y = fq_sub(M::mul(E, fq_sub(D, R.X)), C8);
    R.Z = M::mul(fq_add(P.Y, P.Y), P.Z);
    return R;
}

// madd-2007-bl (Z2 = 1), 7M + 4S, plus the doubling for P == A, computed only
// where a lane of the warp needs it.  The affine operand cannot hold the
// identity, so `inf2` passes P through.
template <class M>
DEV G1Jac g1_jac_madd(const G1Jac& P, const fq& x2, const fq& y2, bool inf2) {
    fq Z1Z1 = M::sqr(P.Z);
    fq U2 = M::mul(x2, Z1Z1);
    fq S2 = M::mul(M::mul(y2, P.Z), Z1Z1);
    fq H = fq_sub(U2, P.X);
    fq HH = M::sqr(H);
    fq I = fq_add(HH, HH);
    I = fq_add(I, I);
    fq J = M::mul(H, I);
    fq rr = fq_sub(S2, P.Y);
    fq r = fq_add(rr, rr);
    fq V = M::mul(P.X, I);
    G1Jac R;
    R.X = fq_sub(fq_sub(M::sqr(r), J), fq_add(V, V));
    fq YJ = M::mul(P.Y, J);
    R.Y = fq_sub(M::mul(r, fq_sub(V, R.X)), fq_add(YJ, YJ));
    R.Z = fq_sub(fq_sub(M::sqr(fq_add(P.Z, H)), Z1Z1), HH);

    // the selections, in the order of points.jac_add_affine; a warp with no
    // P == A lane would select R everywhere, so it skips the doubling
    bool idP = fq_is_zero(P.Z);
    bool x_eq = fq_is_zero(H) & !idP & !inf2;
    bool y_eq = fq_is_zero(rr);
    if (WARP_ANY(x_eq & y_eq))
        R = g1_jac_cmov(x_eq & y_eq, g1_jac_dbl<M>(P), R);  // P == A
    R = g1_jac_cmov(x_eq & !y_eq, g1_jac_identity(), R);   // P == -A
    G1Jac promoted;                                        // identity + A
    promoted.X = x2;
    promoted.Y = y2;
    promoted.Z = fp_one<Fq>();
    R = g1_jac_cmov(idP & !inf2, promoted, R);
    return g1_jac_cmov(inf2, P, R);
}

// add-2007-bl, 11M + 5S, plus the doubling for P == Q, computed only where a
// lane of the warp needs it; complete.
template <class M>
DEV G1Jac g1_jac_add(const G1Jac& P, const G1Jac& Q) {
    fq Z1Z1 = M::sqr(P.Z);
    fq Z2Z2 = M::sqr(Q.Z);
    fq U1 = M::mul(P.X, Z2Z2);
    fq U2 = M::mul(Q.X, Z1Z1);
    fq S1 = M::mul(M::mul(P.Y, Q.Z), Z2Z2);
    fq S2 = M::mul(M::mul(Q.Y, P.Z), Z1Z1);
    fq H = fq_sub(U2, U1);
    fq I = M::sqr(fq_add(H, H));
    fq J = M::mul(H, I);
    fq rr = fq_sub(S2, S1);
    fq r = fq_add(rr, rr);
    fq V = M::mul(U1, I);
    G1Jac R;
    R.X = fq_sub(fq_sub(M::sqr(r), J), fq_add(V, V));
    fq SJ = M::mul(S1, J);
    R.Y = fq_sub(M::mul(r, fq_sub(V, R.X)), fq_add(SJ, SJ));
    R.Z = M::mul(fq_sub(fq_sub(M::sqr(fq_add(P.Z, Q.Z)), Z1Z1), Z2Z2), H);

    // the selections, in the order of points.jac_add; a warp with no P == Q
    // lane would select R everywhere, so it skips the doubling
    bool idP = fq_is_zero(P.Z);
    bool idQ = fq_is_zero(Q.Z);
    bool x_eq = fq_is_zero(H) & !idP & !idQ;
    bool y_eq = fq_is_zero(rr);
    bool same = x_eq & y_eq;                               // P == Q
    if (WARP_ANY(same)) R = g1_jac_cmov(same, g1_jac_dbl<M>(P), R);
    R = g1_jac_cmov(x_eq & !y_eq, g1_jac_identity(), R);   // P == -Q
    R = g1_jac_cmov(idP, Q, R);
    return g1_jac_cmov(idQ, P, R);
}

DEV G1Jac g1_jac_load(const uint32_t* X, const uint32_t* Y, const uint32_t* Z,
                      size_t n, size_t idx) {
    G1Jac P;
    P.X = fp_load<Fq>(X, n, idx);
    P.Y = fp_load<Fq>(Y, n, idx);
    P.Z = fp_load<Fq>(Z, n, idx);
    return P;
}

DEV void g1_jac_store(uint32_t* X, uint32_t* Y, uint32_t* Z, size_t n, size_t idx,
                      const G1Jac& P) {
    fp_store<Fq>(X, n, idx, P.X);
    fp_store<Fq>(Y, n, idx, P.Y);
    fp_store<Fq>(Z, n, idx, P.Z);
}

// ---------------------------------------------------------------------------
// Lane bodies: what one thread does.  The kernels in g1_jac_kernels.cu call
// them with the thread's index; host_check.cpp calls them in a loop on a CPU.
// Every operand is a contiguous (24, n) plane, `inf2` one byte a lane.
// ---------------------------------------------------------------------------

DEV void g1_jdbl_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx) {
    g1_jac_store(X3, Y3, Z3, n, idx,
                 g1_jac_dbl<CarryMul>(g1_jac_load(X1, Y1, Z1, n, idx)));
}

DEV void g1_madd_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx) {
    G1Jac P = g1_jac_load(X1, Y1, Z1, n, idx);
    fq x = fp_load<Fq>(x2, n, idx);
    fq y = fp_load<Fq>(y2, n, idx);
    g1_jac_store(X3, Y3, Z3, n, idx, g1_jac_madd<CarryMul>(P, x, y, inf2[idx] != 0));
}

DEV void g1_jadd_lane(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
                      const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
                      uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                      size_t idx) {
    G1Jac P = g1_jac_load(X1, Y1, Z1, n, idx);
    G1Jac Q = g1_jac_load(X2, Y2, Z2, n, idx);
    g1_jac_store(X3, Y3, Z3, n, idx, g1_jac_add<CarryMul>(P, Q));
}

// The double-and-add ladder of points.scalar_mul for one lane, MSB first:
// scalars[lane] * A[lane].  A = (x, y, inf) is loaded once, the accumulator
// stays in registers for all num_bits steps and is stored once.  The scalar's
// 16-bit limbs are in standard form, limb j of the lane at
// scalars[j * s_plane + idx * s_lane] ((16, n) planes: s_plane = n, s_lane =
// 1; one (16, 1) column for every lane: s_plane = 1, s_lane = 0); a limb is
// read once every 16 bits.  Each step is the doubling, then the mixed add
// selected where the lane's bit is set; a warp in which no lane has the bit
// would select acc in every lane, so it skips the add (WARP_ANY).  With one
// scalar for every lane (is_in_subgroup's r) the branch is the same in every
// warp and a zero bit costs no add.  The limbs are those of num_bits
// doublings, mixed adds and selects in a row.
DEV void g1_jac_ladder_lane(const uint32_t* scalars, size_t s_plane, size_t s_lane,
                            const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
                            uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n,
                            size_t idx, int num_bits) {
    const uint32_t* k = scalars + idx * s_lane;
    fq x = fp_load<Fq>(x2, n, idx);
    fq y = fp_load<Fq>(y2, n, idx);
    bool inf = inf2[idx] != 0;
    G1Jac acc = g1_jac_identity();
    uint32_t limb = 0u;
    ROLLED
    for (int b = num_bits - 1; b >= 0; --b) {
        if (b == num_bits - 1 || (b & 15) == 15) limb = k[(size_t)(b >> 4) * s_plane];
        bool bit = ((limb >> (b & 15)) & 1u) != 0u;
        acc = g1_jac_dbl<CarryMul>(acc);
        if (WARP_ANY(bit)) acc = g1_jac_cmov(bit, g1_jac_madd<CarryMul>(acc, x, y, inf), acc);
    }
    g1_jac_store(X3, Y3, Z3, n, idx, acc);
}
