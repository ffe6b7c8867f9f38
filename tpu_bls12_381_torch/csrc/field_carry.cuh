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
