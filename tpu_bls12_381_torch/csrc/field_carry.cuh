// The Montgomery product on two carry chains, for Fq (12 words: the MSM's
// scan, lane scan and doubling kernels in g1_kernels.cu) and for Fr (8 words:
// the batch inversion of batch_inverse.cu).
//
// field.cuh's fp_mul writes every step as (uint64_t)a*b + t + c, so each
// wide multiply-add waits on the carry of the one before and costs several
// instructions.  Here the product a*b_i of one row is split by the parity of
// a's word index: the products of the even words land in E with their low
// halves on even positions and their high halves on odd ones, the products of
// the odd words in O, one word up.  No two products of one array overlap, so
// each array takes its row as ONE chain of mad.lo.cc / madc.hi.cc on the
// hardware carry flag, and the two chains are independent: two chains side by
// side instead of one 64-bit chain.  The value held is T = E + 2^32 O; the
// reduction m = E[0] * n0 adds m*p the same way, and the division by 2^32 is
// a change of roles: the next row takes O as its even array and E, moved
// two words down, as its odd one (the scheme of the sppark library's mont_t).
// The modulus leaves a spare top bit (p < 2^381 for Fq, r < 2^255 for Fr):
// T stays below 2^(32(W+1)), so O never carries out of its top word.
//
// Each chain is one asm statement: the carry flag does not survive from one
// statement to the next.  Without __CUDA_ARCH__ (host_check.cpp) the same
// chains run as C++ with an explicit carry, so the schedule above is held
// against the plain versions on a CPU; only the PTX spelling is the card's.
//
// A canonical Montgomery product is unique, so the limbs equal fp_mul's bit
// for bit.  A square is the product a*a.
//
// Below the product: the Fermat inverse of one element (batch_inverse.cu's
// phase 2 and field_kernels.cu's field_inv), and the lane bodies of
// field_kernels.cu's elementwise product and square.

#pragma once

#include "field.cuh"

// The moduli's words as compile-time constants (field.cuh's FQ_P and FR_P
// live in constant memory, which an asm operand cannot name).
DEV constexpr uint32_t fq_p_word(int j) {
    return j == 0 ? 0xffffaaabu : j == 1 ? 0xb9feffffu : j == 2 ? 0xb153ffffu
         : j == 3 ? 0x1eabfffeu : j == 4 ? 0xf6b0f624u : j == 5 ? 0x6730d2a0u
         : j == 6 ? 0xf38512bfu : j == 7 ? 0x64774b84u : j == 8 ? 0x434bacd7u
         : j == 9 ? 0x4b1ba7b6u : j == 10 ? 0x397fe69au : 0x1a0111eau;
}

DEV constexpr uint32_t fr_p_word(int j) {
    return j == 0 ? 0x00000001u : j == 1 ? 0xffffffffu : j == 2 ? 0xfffe5bfeu
         : j == 3 ? 0x53bda402u : j == 4 ? 0x09a1d805u : j == 5 ? 0x3339d808u
         : j == 6 ? 0x299d7d48u : 0x73eda753u;
}

template <class F>
DEV constexpr uint32_t cc_p_word(int j) {
    return F::W == 12 ? fq_p_word(j) : fr_p_word(j);
}

// E += w_even * m (lows on even positions, highs on odd ones); the carry out
// of the top word goes into `top`, O's top word, which has the same weight.
template <int W>
DEV void cc_mad_even(uint32_t* E, uint32_t& top, const uint32_t* w, uint32_t m) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 12) {
        asm(
            "mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
            "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
            "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
            "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
            "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
            "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
            "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
            "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
            "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
            "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
            "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
            "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
            "addc.u32 %12, %12, 0;"
            : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]), "+r"(E[5]),
              "+r"(E[6]), "+r"(E[7]), "+r"(E[8]), "+r"(E[9]), "+r"(E[10]), "+r"(E[11]),
              "+r"(top)
            : "r"(w[0]), "r"(w[2]), "r"(w[4]), "r"(w[6]), "r"(w[8]), "r"(w[10]), "r"(m));
    } else {
        static_assert(W == 8, "carry chains for 8 and 12 words");
        asm(
            "mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
            "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
            "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
            "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
            "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
            "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
            "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
            "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
            "addc.u32 %8, %8, 0;"
            : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]), "+r"(E[5]),
              "+r"(E[6]), "+r"(E[7]), "+r"(top)
            : "r"(w[0]), "r"(w[2]), "r"(w[4]), "r"(w[6]), "r"(m));
    }
#else
    uint32_t cf = 0;
    for (int k = 0; k < W / 2; ++k) {
        uint64_t pr = (uint64_t)w[2 * k] * m;
        uint64_t s = (uint64_t)(uint32_t)pr + E[2 * k] + cf;
        E[2 * k] = (uint32_t)s;
        s = (pr >> 32) + E[2 * k + 1] + (s >> 32);
        E[2 * k + 1] = (uint32_t)s;
        cf = (uint32_t)(s >> 32);
    }
    top += cf;
#endif
}

// O += w_odd * m, one word up (w[2k+1]*m at positions 2k, 2k+1 of O, which
// stands 2^32 above E); O's top word takes no carry out.
template <int W>
DEV void cc_mad_odd(uint32_t* O, const uint32_t* w, uint32_t m) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 12) {
        asm(
            "mad.lo.cc.u32 %0, %12, %18, %0;\n\t"
            "madc.hi.cc.u32 %1, %12, %18, %1;\n\t"
            "madc.lo.cc.u32 %2, %13, %18, %2;\n\t"
            "madc.hi.cc.u32 %3, %13, %18, %3;\n\t"
            "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
            "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
            "madc.lo.cc.u32 %6, %15, %18, %6;\n\t"
            "madc.hi.cc.u32 %7, %15, %18, %7;\n\t"
            "madc.lo.cc.u32 %8, %16, %18, %8;\n\t"
            "madc.hi.cc.u32 %9, %16, %18, %9;\n\t"
            "madc.lo.cc.u32 %10, %17, %18, %10;\n\t"
            "madc.hi.u32 %11, %17, %18, %11;"
            : "+r"(O[0]), "+r"(O[1]), "+r"(O[2]), "+r"(O[3]), "+r"(O[4]), "+r"(O[5]),
              "+r"(O[6]), "+r"(O[7]), "+r"(O[8]), "+r"(O[9]), "+r"(O[10]), "+r"(O[11])
            : "r"(w[1]), "r"(w[3]), "r"(w[5]), "r"(w[7]), "r"(w[9]), "r"(w[11]), "r"(m));
    } else {
        asm(
            "mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
            "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
            "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
            "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
            "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
            "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
            "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
            "madc.hi.u32 %7, %11, %12, %7;"
            : "+r"(O[0]), "+r"(O[1]), "+r"(O[2]), "+r"(O[3]), "+r"(O[4]), "+r"(O[5]),
              "+r"(O[6]), "+r"(O[7])
            : "r"(w[1]), "r"(w[3]), "r"(w[5]), "r"(w[7]), "r"(m));
    }
#else
    uint32_t cf = 0;
    for (int k = 0; k < W / 2; ++k) {
        uint64_t pr = (uint64_t)w[2 * k + 1] * m;
        uint64_t s = (uint64_t)(uint32_t)pr + O[2 * k] + cf;
        O[2 * k] = (uint32_t)s;
        s = (pr >> 32) + O[2 * k + 1] + (s >> 32);
        O[2 * k + 1] = (uint32_t)s;
        cf = (uint32_t)(s >> 32);
    }
#endif
}

// The start of a row after a reduction: e0 += O[1] (the word that the
// division by 2^32 brings down to weight 1), then O becomes O moved two
// words down plus a_odd * b, the first add's carry flowing into the chain.
template <int W>
DEV void cc_row_odd(uint32_t& e0, uint32_t* O, const uint32_t* a, uint32_t b) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 12) {
        asm(
            "add.cc.u32 %0, %0, %2;\n\t"
            "madc.lo.cc.u32 %1, %13, %19, %3;\n\t"
            "madc.hi.cc.u32 %2, %13, %19, %4;\n\t"
            "madc.lo.cc.u32 %3, %14, %19, %5;\n\t"
            "madc.hi.cc.u32 %4, %14, %19, %6;\n\t"
            "madc.lo.cc.u32 %5, %15, %19, %7;\n\t"
            "madc.hi.cc.u32 %6, %15, %19, %8;\n\t"
            "madc.lo.cc.u32 %7, %16, %19, %9;\n\t"
            "madc.hi.cc.u32 %8, %16, %19, %10;\n\t"
            "madc.lo.cc.u32 %9, %17, %19, %11;\n\t"
            "madc.hi.cc.u32 %10, %17, %19, %12;\n\t"
            "madc.lo.cc.u32 %11, %18, %19, 0;\n\t"
            "madc.hi.u32 %12, %18, %19, 0;"
            : "+r"(e0), "+r"(O[0]), "+r"(O[1]), "+r"(O[2]), "+r"(O[3]), "+r"(O[4]),
              "+r"(O[5]), "+r"(O[6]), "+r"(O[7]), "+r"(O[8]), "+r"(O[9]), "+r"(O[10]),
              "+r"(O[11])
            : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(a[9]), "r"(a[11]), "r"(b));
    } else {
        asm(
            "add.cc.u32 %0, %0, %2;\n\t"
            "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
            "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
            "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
            "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
            "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
            "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
            "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
            "madc.hi.u32 %8, %12, %13, 0;"
            : "+r"(e0), "+r"(O[0]), "+r"(O[1]), "+r"(O[2]), "+r"(O[3]), "+r"(O[4]),
              "+r"(O[5]), "+r"(O[6]), "+r"(O[7])
            : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
    }
#else
    uint64_t s = (uint64_t)e0 + O[1];
    e0 = (uint32_t)s;
    uint32_t cf = (uint32_t)(s >> 32);
    for (int k = 0; k < W / 2; ++k) {
        uint64_t pr = (uint64_t)a[2 * k + 1] * b;
        uint32_t up_lo = k < W / 2 - 1 ? O[2 * k + 2] : 0u;
        uint32_t up_hi = k < W / 2 - 1 ? O[2 * k + 3] : 0u;
        s = (uint64_t)(uint32_t)pr + up_lo + cf;
        O[2 * k] = (uint32_t)s;
        s = (pr >> 32) + up_hi + (s >> 32);
        O[2 * k + 1] = (uint32_t)s;
        cf = (uint32_t)(s >> 32);
    }
#endif
}

// E[i] += O[i + 1] for i < W - 1, the carry into E[W - 1]: the last division
// by 2^32 folded into the sum of the two arrays.
template <int W>
DEV void cc_merge(uint32_t* E, const uint32_t* O) {
#ifdef __CUDA_ARCH__
    if constexpr (W == 12) {
        asm(
            "add.cc.u32 %0, %0, %12;\n\t"
            "addc.cc.u32 %1, %1, %13;\n\t"
            "addc.cc.u32 %2, %2, %14;\n\t"
            "addc.cc.u32 %3, %3, %15;\n\t"
            "addc.cc.u32 %4, %4, %16;\n\t"
            "addc.cc.u32 %5, %5, %17;\n\t"
            "addc.cc.u32 %6, %6, %18;\n\t"
            "addc.cc.u32 %7, %7, %19;\n\t"
            "addc.cc.u32 %8, %8, %20;\n\t"
            "addc.cc.u32 %9, %9, %21;\n\t"
            "addc.cc.u32 %10, %10, %22;\n\t"
            "addc.u32 %11, %11, 0;"
            : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]), "+r"(E[5]),
              "+r"(E[6]), "+r"(E[7]), "+r"(E[8]), "+r"(E[9]), "+r"(E[10]), "+r"(E[11])
            : "r"(O[1]), "r"(O[2]), "r"(O[3]), "r"(O[4]), "r"(O[5]), "r"(O[6]),
              "r"(O[7]), "r"(O[8]), "r"(O[9]), "r"(O[10]), "r"(O[11]));
    } else {
        asm(
            "add.cc.u32 %0, %0, %8;\n\t"
            "addc.cc.u32 %1, %1, %9;\n\t"
            "addc.cc.u32 %2, %2, %10;\n\t"
            "addc.cc.u32 %3, %3, %11;\n\t"
            "addc.cc.u32 %4, %4, %12;\n\t"
            "addc.cc.u32 %5, %5, %13;\n\t"
            "addc.cc.u32 %6, %6, %14;\n\t"
            "addc.u32 %7, %7, 0;"
            : "+r"(E[0]), "+r"(E[1]), "+r"(E[2]), "+r"(E[3]), "+r"(E[4]), "+r"(E[5]),
              "+r"(E[6]), "+r"(E[7])
            : "r"(O[1]), "r"(O[2]), "r"(O[3]), "r"(O[4]), "r"(O[5]), "r"(O[6]),
              "r"(O[7]));
    }
#else
    uint32_t cf = 0;
    for (int i = 0; i < W; ++i) {
        uint64_t s = (uint64_t)E[i] + (i < W - 1 ? O[i + 1] : 0u) + cf;
        E[i] = (uint32_t)s;
        cf = (uint32_t)(s >> 32);
    }
#endif
}

// One row's reduction: m = E[0] n0 makes T = E + 2^32 O divisible by 2^32.
template <class F>
DEV void cc_reduce(uint32_t* E, uint32_t* O) {
    uint32_t p[F::W];
    UNROLL
    for (int j = 0; j < F::W; ++j) p[j] = cc_p_word<F>(j);
    uint32_t m = E[0] * F::N0;
    cc_mad_odd<F::W>(O, p, m);
    cc_mad_even<F::W>(E, O[F::W - 1], p, m);
}

// One row a * b_i into (E, O), after the reduction of the row before, whose
// even array was O and odd array E (hence the names' order).
template <class F>
DEV void cc_row(uint32_t* E, uint32_t* O, const uint32_t* a, uint32_t b) {
    cc_row_odd<F::W>(E[0], O, a, b);
    cc_mad_even<F::W>(E, O[F::W - 1], a, b);
    cc_reduce<F>(E, O);
}

// a*b*R^-1 mod p, canonical for canonical a, b: limb for limb fp_mul<F>.
template <class F>
DEV El<F> fp_mul_cc(const El<F>& a, const El<F>& b) {
    constexpr int W = F::W;
    uint32_t E[W], O[W];
    UNROLL
    for (int j = 0; j < W; j += 2) {
        uint64_t pe = (uint64_t)a.v[j] * b.v[0];
        uint64_t po = (uint64_t)a.v[j + 1] * b.v[0];
        E[j] = (uint32_t)pe;
        E[j + 1] = (uint32_t)(pe >> 32);
        O[j] = (uint32_t)po;
        O[j + 1] = (uint32_t)(po >> 32);
    }
    cc_reduce<F>(E, O);
    UNROLL
    for (int i = 1; i < W; i += 2) {
        cc_row<F>(O, E, a.v, b.v[i]);
        if (i + 1 < W) cc_row<F>(E, O, a.v, b.v[i + 1]);
    }
    // the last row left T = O + 2^32 E with O[0] = 0: the value is E + O/2^32
    cc_merge<W>(E, O);
    El<F> r;
    UNROLL
    for (int j = 0; j < W; ++j) r.v[j] = E[j];
    return fp_cond_sub_p<F>(r, 0u);
}

DEV El<Fq> fq_mul_cc(const El<Fq>& a, const El<Fq>& b) { return fp_mul_cc<Fq>(a, b); }

// The butterfly's sum and difference for Fr on the carry flag: a + b and
// a - b mod r for canonical a, b, each one add chain and one subtract chain
// of 8 words and a select (field.cuh's fp_add and fp_sub give the same limbs;
// r < 2^255, so a + b never leaves 8 words).
DEV El<Fr> fr_add_cc(const El<Fr>& a, const El<Fr>& b) {
    El<Fr> s, d;
    uint32_t keep;
#ifdef __CUDA_ARCH__
    asm("add.cc.u32 %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32 %7, %15, %23;"
        : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]), "=r"(s.v[4]),
          "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7])
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
          "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]),
          "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(keep)
        : "r"(s.v[0]), "r"(s.v[1]), "r"(s.v[2]), "r"(s.v[3]), "r"(s.v[4]), "r"(s.v[5]),
          "r"(s.v[6]), "r"(s.v[7]), "r"(fr_p_word(0)), "r"(fr_p_word(1)),
          "r"(fr_p_word(2)), "r"(fr_p_word(3)), "r"(fr_p_word(4)), "r"(fr_p_word(5)),
          "r"(fr_p_word(6)), "r"(fr_p_word(7)));
#else
    uint64_t c = 0;
    for (int j = 0; j < 8; ++j) {
        c += (uint64_t)a.v[j] + b.v[j];
        s.v[j] = (uint32_t)c;
        c >>= 32;
    }
    uint32_t br = 0;
    for (int j = 0; j < 8; ++j) {
        uint64_t t = (uint64_t)s.v[j] - fr_p_word(j) - br;
        d.v[j] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    keep = 0u - br;
#endif
    // keep: all ones where s - r borrowed (s < r): the sum stands
    El<Fr> r;
    UNROLL
    for (int j = 0; j < 8; ++j) r.v[j] = (s.v[j] & keep) | (d.v[j] & ~keep);
    return r;
}

DEV El<Fr> fr_sub_cc(const El<Fr>& a, const El<Fr>& b) {
    El<Fr> d;
    uint32_t m;
#ifdef __CUDA_ARCH__
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, 0, 0;"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]),
          "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(m)
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
          "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]), "+r"(d.v[4]),
          "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7])
        : "r"(fr_p_word(0) & m), "r"(fr_p_word(1) & m), "r"(fr_p_word(2) & m),
          "r"(fr_p_word(3) & m), "r"(fr_p_word(4) & m), "r"(fr_p_word(5) & m),
          "r"(fr_p_word(6) & m), "r"(fr_p_word(7) & m));
#else
    uint32_t br = 0;
    for (int j = 0; j < 8; ++j) {
        uint64_t t = (uint64_t)a.v[j] - b.v[j] - br;
        d.v[j] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    m = 0u - br;
    uint64_t c = 0;
    for (int j = 0; j < 8; ++j) {
        c += (uint64_t)d.v[j] + (fr_p_word(j) & m);
        d.v[j] = (uint32_t)c;
        c >>= 32;
    }
#endif
    return d;
}

// The same for Fq (12 words; p < 2^381, so a + b < 2^382 never leaves 12
// words either): fq_add_cc and fq_sub_cc, one add chain, one subtract chain
// and a select, on two helpers whose chains stay under the inline asm's
// operand limit.

// x += y on the carry flag, 12 words; the caller keeps the sum below 2^384.
DEV void cc_add12(uint32_t* x, const uint32_t* y) {
#ifdef __CUDA_ARCH__
    asm("add.cc.u32 %0, %0, %12;\n\t"
        "addc.cc.u32 %1, %1, %13;\n\t"
        "addc.cc.u32 %2, %2, %14;\n\t"
        "addc.cc.u32 %3, %3, %15;\n\t"
        "addc.cc.u32 %4, %4, %16;\n\t"
        "addc.cc.u32 %5, %5, %17;\n\t"
        "addc.cc.u32 %6, %6, %18;\n\t"
        "addc.cc.u32 %7, %7, %19;\n\t"
        "addc.cc.u32 %8, %8, %20;\n\t"
        "addc.cc.u32 %9, %9, %21;\n\t"
        "addc.cc.u32 %10, %10, %22;\n\t"
        "addc.u32 %11, %11, %23;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
          "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]), "+r"(x[10]), "+r"(x[11])
        : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
          "r"(y[6]), "r"(y[7]), "r"(y[8]), "r"(y[9]), "r"(y[10]), "r"(y[11]));
#else
    uint64_t c = 0;
    for (int j = 0; j < 12; ++j) {
        c += (uint64_t)x[j] + y[j];
        x[j] = (uint32_t)c;
        c >>= 32;
    }
#endif
}

// x -= y on the carry flag, 12 words; returns all ones where it borrowed
// (x < y), else 0.
DEV uint32_t cc_sub12(uint32_t* x, const uint32_t* y) {
    uint32_t m;
#ifdef __CUDA_ARCH__
    asm("sub.cc.u32 %0, %0, %13;\n\t"
        "subc.cc.u32 %1, %1, %14;\n\t"
        "subc.cc.u32 %2, %2, %15;\n\t"
        "subc.cc.u32 %3, %3, %16;\n\t"
        "subc.cc.u32 %4, %4, %17;\n\t"
        "subc.cc.u32 %5, %5, %18;\n\t"
        "subc.cc.u32 %6, %6, %19;\n\t"
        "subc.cc.u32 %7, %7, %20;\n\t"
        "subc.cc.u32 %8, %8, %21;\n\t"
        "subc.cc.u32 %9, %9, %22;\n\t"
        "subc.cc.u32 %10, %10, %23;\n\t"
        "subc.cc.u32 %11, %11, %24;\n\t"
        "subc.u32 %12, 0, 0;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
          "+r"(x[6]), "+r"(x[7]), "+r"(x[8]), "+r"(x[9]), "+r"(x[10]), "+r"(x[11]),
          "=r"(m)
        : "r"(y[0]), "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]),
          "r"(y[6]), "r"(y[7]), "r"(y[8]), "r"(y[9]), "r"(y[10]), "r"(y[11]));
#else
    uint32_t br = 0;
    for (int j = 0; j < 12; ++j) {
        uint64_t t = (uint64_t)x[j] - y[j] - br;
        x[j] = (uint32_t)t;
        br = (uint32_t)(t >> 63);
    }
    m = 0u - br;
#endif
    return m;
}

DEV El<Fq> fq_add_cc(const El<Fq>& a, const El<Fq>& b) {
    El<Fq> s = a;
    cc_add12(s.v, b.v);
    uint32_t p[12];
    UNROLL
    for (int j = 0; j < 12; ++j) p[j] = fq_p_word(j);
    El<Fq> d = s;
    const uint32_t keep = cc_sub12(d.v, p);     // s < p: the sum stands
    El<Fq> r;
    UNROLL
    for (int j = 0; j < 12; ++j) r.v[j] = (s.v[j] & keep) | (d.v[j] & ~keep);
    return r;
}

DEV El<Fq> fq_sub_cc(const El<Fq>& a, const El<Fq>& b) {
    El<Fq> d = a;
    const uint32_t m = cc_sub12(d.v, b.v);      // a < b: add p back
    uint32_t pm[12];
    UNROLL
    for (int j = 0; j < 12; ++j) pm[j] = fq_p_word(j) & m;
    cc_add12(d.v, pm);
    return d;
}

// (a + b) mod p and (a - b) mod p for canonical a, b of either field, limb
// for limb field.cuh's fp_add and fp_sub: Fr's are the butterfly's.
template <class F>
DEV El<F> fp_add_cc(const El<F>& a, const El<F>& b) {
    if constexpr (F::W == 8)
        return fr_add_cc(a, b);
    else
        return fq_add_cc(a, b);
}

template <class F>
DEV El<F> fp_sub_cc(const El<F>& a, const El<F>& b) {
    if constexpr (F::W == 8)
        return fr_sub_cc(a, b);
    else
        return fq_sub_cc(a, b);
}

// ---------------------------------------------------------------------------
// The Fermat inverse
// ---------------------------------------------------------------------------

// Word j of the exponent p - 2 of the Fermat inverse.
template <class F>
DEV constexpr uint32_t binv_exp_word(int j) {
    return j == 0 ? cc_p_word<F>(0) - 2u
         : j == 1 ? cc_p_word<F>(1) - (cc_p_word<F>(0) < 2u ? 1u : 0u)
         : cc_p_word<F>(j);
}

// a^(p-2) = 1/a for a unit a, and 0 for a = 0: left to right in 4-bit
// windows from a table of a^0 .. a^15 (380 squares and 105 products for Fq,
// 252 and 73 for Fr, the table's 14 among them).  The windows branch on the
// public exponent only, never on a.  One thread runs it; the table lies in
// local memory.
template <class F>
DEV El<F> fp_inv_fermat(const El<F>& a) {
    El<F> tab[16];
    tab[0] = fp_one<F>();
    tab[1] = a;
    for (int k = 2; k < 16; ++k) tab[k] = fp_mul_cc<F>(tab[k - 1], a);
    const int top = 8 * F::W - 1;                  // the highest 4-bit digit
    El<F> r = tab[(binv_exp_word<F>(top >> 3) >> ((top & 7) * 4)) & 15u];
    ROLLED
    for (int i = top - 1; i >= 0; --i) {
        UNROLL
        for (int s = 0; s < 4; ++s) r = fp_mul_cc<F>(r, r);
        uint32_t d = (binv_exp_word<F>(i >> 3) >> ((i & 7) * 4)) & 15u;
        if (d) r = fp_mul_cc<F>(r, tab[d]);
    }
    return r;
}

// field_inv's lane: the Montgomery-form inverse of element idx, inv(0) = 0.
template <class F>
DEV void field_inv_lane(const uint32_t* a, uint32_t* out, size_t n, size_t idx) {
    fp_store<F>(out, n, idx, fp_inv_fermat<F>(fp_load<F>(a, n, idx)));
}

// ---------------------------------------------------------------------------
// The elementwise product and square (field_kernels.cu's mont_mul, mont_sqr)
// ---------------------------------------------------------------------------

// What the second factor is: a (K, n) plane, one element (K, 1) that every
// lane takes (held in registers), or the first factor again (the square).
enum MulMode { MUL_PLANE = 0, MUL_COLUMN = 1, MUL_SQUARE = 2 };

// Four neighbouring words of one plane: on the card one 16-byte access (p
// is 16-byte aligned).  Plain loads and stores: the streaming hints
// (__ldcs / __stcs) measured slower (fields/sweeps.py --builds).
DEV void ld4(const uint32_t* p, uint32_t* w) {
#ifdef __CUDA_ARCH__
    uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
#else
    for (int l = 0; l < 4; ++l) w[l] = p[l];
#endif
}

DEV void st4(uint32_t* p, const uint32_t* w) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
#else
    for (int l = 0; l < 4; ++l) p[l] = w[l];
#endif
}

// Lanes i .. i+3 of a (K, n) plane as four elements, and back.
template <class F>
DEV void fp_load4(const uint32_t* base, size_t n, size_t i, El<F>* v) {
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        uint32_t lo[4], hi[4];
        ld4(base + (size_t)(2 * j) * n + i, lo);
        ld4(base + (size_t)(2 * j + 1) * n + i, hi);
        UNROLL
        for (int l = 0; l < 4; ++l) v[l].v[j] = (lo[l] & 0xffffu) | (hi[l] << 16);
    }
}

template <class F>
DEV void fp_store4(uint32_t* base, size_t n, size_t i, const El<F>* v) {
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        uint32_t lo[4], hi[4];
        UNROLL
        for (int l = 0; l < 4; ++l) {
            lo[l] = v[l].v[j] & 0xffffu;
            hi[l] = v[l].v[j] >> 16;
        }
        st4(base + (size_t)(2 * j) * n + i, lo);
        st4(base + (size_t)(2 * j + 1) * n + i, hi);
    }
}

// Lanes i .. i+3 (n % 4 == 0, every plane 16-byte aligned): per limb plane
// one 16-byte load of each operand and one 16-byte store, neighbouring
// threads on neighbouring addresses.  `bc` is the column's element
// (MUL_COLUMN), unused otherwise.
template <class F, int MODE>
DEV void mont_mul_lanes4(const uint32_t* a, const uint32_t* b, const El<F>& bc,
                         uint32_t* out, size_t n, size_t i) {
    El<F> x[4];
    fp_load4<F>(a, n, i, x);
    if constexpr (MODE == MUL_PLANE) {
        El<F> y[4];
        fp_load4<F>(b, n, i, y);
        UNROLL
        for (int l = 0; l < 4; ++l) x[l] = fp_mul_cc<F>(x[l], y[l]);
    } else {
        UNROLL
        for (int l = 0; l < 4; ++l)
            x[l] = fp_mul_cc<F>(x[l], MODE == MUL_COLUMN ? bc : x[l]);
    }
    fp_store4<F>(out, n, i, x);
}

// Lane i alone: Fr's path, and Fq's where n % 4 != 0 or a plane is not
// 16-byte aligned.
template <class F, int MODE>
DEV void mont_mul_lane1(const uint32_t* a, const uint32_t* b, const El<F>& bc,
                        uint32_t* out, size_t n, size_t i) {
    El<F> x = fp_load<F>(a, n, i);
    El<F> y = MODE == MUL_PLANE ? fp_load<F>(b, n, i) : MODE == MUL_COLUMN ? bc : x;
    fp_store<F>(out, n, i, fp_mul_cc<F>(x, y));
}

// Whether a launch takes the four-lane path: Fq only (Fr's lighter product
// reads faster one lane a thread: fields/sweeps.py --builds), and only where
// every plane of a, out and (for MUL_PLANE) b starts on a 16-byte boundary,
// which needs n % 4 == 0 (the plane stride is 4n bytes) and 16-byte aligned
// pointers.
template <class F>
inline bool mont_mul_takes_four(size_t n, int mode, const void* a, const void* b,
                                const void* out) {
    auto al = [](const void* p) { return ((size_t)p & 15u) == 0; };
    return F::W == 12 && n % 4 == 0 && al(a) && al(out) && (mode != MUL_PLANE || al(b));
}

// ---------------------------------------------------------------------------
// The elementwise add and sub (field_kernels.cu's field_add, field_sub)
// ---------------------------------------------------------------------------

// What the operands are: two (K, n) planes; a plane and one (K, 1) column
// that every lane takes (read once a thread, held in registers), right of
// the plane (a + c, a - c) or left of it (c - a: the sub does not commute);
// or the plane alone: a + a (the doubling) and 0 - a (the negation), which
// read one plane and write one.
enum AddSubMode { AS_PLANES = 0, AS_COLUMN = 1, AS_COLUMN_LEFT = 2, AS_ALONE = 3 };

// One lane's sum or difference; y is the plane's element or the column.
template <class F, bool SUB, int MODE>
DEV El<F> addsub_cc(const El<F>& x, const El<F>& y) {
    if constexpr (MODE == AS_ALONE) {
        if constexpr (SUB)
            return fp_sub_cc<F>(fp_zero<F>(), x);
        else
            return fp_add_cc<F>(x, x);
    } else {
        const El<F>& l = MODE == AS_COLUMN_LEFT ? y : x;
        const El<F>& r = MODE == AS_COLUMN_LEFT ? x : y;
        if constexpr (SUB)
            return fp_sub_cc<F>(l, r);
        else
            return fp_add_cc<F>(l, r);
    }
}

// Lanes i .. i+3 (n % 4 == 0, every plane 16-byte aligned), as the
// product's mont_mul_lanes4: a 16-byte access a plane and operand.
template <class F, bool SUB, int MODE>
DEV void addsub_lanes4(const uint32_t* a, const uint32_t* b, const El<F>& c,
                       uint32_t* out, size_t n, size_t i) {
    El<F> x[4];
    fp_load4<F>(a, n, i, x);
    if constexpr (MODE == AS_PLANES) {
        El<F> y[4];
        fp_load4<F>(b, n, i, y);
        UNROLL
        for (int l = 0; l < 4; ++l) x[l] = addsub_cc<F, SUB, MODE>(x[l], y[l]);
    } else {
        UNROLL
        for (int l = 0; l < 4; ++l) x[l] = addsub_cc<F, SUB, MODE>(x[l], c);
    }
    fp_store4<F>(out, n, i, x);
}

// Lane i alone: Fq's path, and Fr's where n % 4 != 0 or a plane is not
// 16-byte aligned.
template <class F, bool SUB, int MODE>
DEV void addsub_lane1(const uint32_t* a, const uint32_t* b, const El<F>& c,
                      uint32_t* out, size_t n, size_t i) {
    const El<F> x = fp_load<F>(a, n, i);
    const El<F> y = MODE == AS_PLANES ? fp_load<F>(b, n, i) : c;
    fp_store<F>(out, n, i, addsub_cc<F, SUB, MODE>(x, y));
}

// Whether a launch takes the four-lane path: Fr only (Fq's add and sub read
// as fast or faster one lane a thread, the reverse of the product:
// fields/sweeps.py --builds), and only where every plane of a, out and
// (AS_PLANES) b starts on a 16-byte boundary, which needs n % 4 == 0.
template <class F>
inline bool addsub_takes_four(size_t n, int mode, const void* a, const void* b,
                              const void* out) {
    auto al = [](const void* p) { return ((size_t)p & 15u) == 0; };
    return F::W == 8 && n % 4 == 0 && al(a) && al(out) && (mode != AS_PLANES || al(b));
}

// ---------------------------------------------------------------------------
// The modular sum of a vector (field_kernels.cu's field_sum)
// ---------------------------------------------------------------------------

// Threads of a field_sum block, and the blocks a first pass aims at over all
// its rows (8 resident blocks on each of an H100's 132 SMs, rounded).
#define SUM_THREADS 256
#define SUM_BLOCKS_TARGET 1024

// Blocks a row of n lanes (rows rows): enough to fill the card, none
// without a lane for each of its threads.  1: one pass writes the sums.
inline size_t field_sum_blocks(size_t n, size_t rows) {
    const size_t by_lanes = (n + SUM_THREADS - 1) / SUM_THREADS;
    const size_t by_card = (SUM_BLOCKS_TARGET + rows - 1) / rows;
    const size_t g = by_lanes < by_card ? by_lanes : by_card;
    return g ? g : 1;
}

// Whether a pass over rows of n lanes at v reads four neighbouring lanes a
// step with one 16-byte access a plane: n % 4 == 0 keeps every row and
// plane on a 16-byte boundary where v starts on one.
inline bool field_sum_takes_four(size_t n, const void* v) {
    return n % 4 == 0 && ((size_t)v & 15u) == 0;
}

// One thread's run over one row (plane stride `stride`): lanes t, t + step,
// ... in registers; with FOUR, t and step count groups of four neighbouring
// lanes, summed pairwise before they join the run.
template <class F, bool FOUR>
DEV El<F> sum_run(const uint32_t* row, size_t stride, size_t n, size_t t, size_t step) {
    El<F> acc = fp_zero<F>();
    if constexpr (FOUR) {
        for (size_t u = t; u < n / 4; u += step) {
            El<F> x[4];
            fp_load4<F>(row, stride, 4 * u, x);
            acc = fp_add_cc<F>(acc, fp_add_cc<F>(fp_add_cc<F>(x[0], x[1]),
                                                 fp_add_cc<F>(x[2], x[3])));
        }
    } else {
        for (size_t i = t; i < n; i += step) acc = fp_add_cc<F>(acc, fp_load<F>(row, stride, i));
    }
    return acc;
}
