// Montgomery arithmetic for the BLS12-381 fields, one field element per thread.
//
// Device code shared by field_kernels.cu, g1_kernels.cu and ntt_kernels.cu.
// It takes the place of the limb pipeline of the JAX package's
// fields/pallas_ops.py (_k_mont_mul, _k_mont_sqr, _k_add, _k_sub,
// _k_cond_sub_modulus), thought through again for a GPU thread:
//
//  * Stored layout is the JAX package's: (K, N) planes of 16-bit limbs, one
//    32-bit slot per limb, limbs first.  Thread `idx` owns column `idx`, so
//    the threads of a warp read neighbouring addresses of one plane and the
//    loads coalesce as they are.
//  * In registers a value is W = K/2 words of 32 bits (12 for Fq, 8 for Fr).
//    Montgomery R stays 2^(16K) = 2^(32W), and every result is canonical
//    (< p), so the limbs written back equal the 16-bit-limb pipeline's bit
//    for bit.
//  * Products are 32x32 -> 64 with a 64-bit running sum (CIOS); the compiler
//    turns them into wide integer multiply-adds.  The modulus lives in
//    __constant__ memory; the loops are fully unrolled, so its words are
//    read with constant indices and every array stays in registers.
//  * No branches on data: selects only.
//
// The header also compiles as plain C++ (no __CUDACC__), so the arithmetic
// can be exercised on a host without a GPU.

#pragma once

#include <stddef.h>
#include <stdint.h>

// ROLLED keeps a loop of dependent steps (group operations, products down a
// column) rolled: unrolled, the compiler overlaps two iterations' registers
// and spills for no gain.
// WARP_ANY(p) is true in every lane of a warp where p holds in one of its
// active lanes (a branch that only some lanes need is then taken by the
// whole warp or skipped by it).  The mask is the active one, since a launch's
// last warp may have lanes that returned early.  On the host a lane runs
// alone: p itself.
#ifdef __CUDACC__
#define DEV __device__ __forceinline__
#define DEV_CONST __device__ __constant__
#define UNROLL _Pragma("unroll")
#define ROLLED _Pragma("unroll 1")
#define WARP_ANY(p) __any_sync(__activemask(), (p))
#else
#define DEV inline
#define DEV_CONST static const
#define UNROLL
#define ROLLED
#define WARP_ANY(p) (p)
#endif

// p, R mod p and -p^-1 mod 2^32 as little-endian 32-bit words.
// tests/test_torch_fields.py reads these lines and checks them against the
// Python field specs.
DEV_CONST uint32_t FQ_P[12] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
    0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
DEV_CONST uint32_t FQ_ONE[12] = {
    0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau, 0x5f489857u,
    0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
DEV_CONST uint32_t FR_P[8] = {
    0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u,
    0x09a1d805u, 0x3339d808u, 0x299d7d48u, 0x73eda753u};
DEV_CONST uint32_t FR_ONE[8] = {
    0xfffffffeu, 0x00000001u, 0x00034802u, 0x5884b7fau,
    0xecbc4ff5u, 0x998c4fefu, 0xacc5056fu, 0x1824b159u};

struct Fq {
    static constexpr int W = 12;               // 32-bit words
    static constexpr int K = 24;               // 16-bit limbs as stored
    static constexpr uint32_t N0 = 0xfffcfffdu;
    static DEV uint32_t p(int i) { return FQ_P[i]; }
    static DEV uint32_t one(int i) { return FQ_ONE[i]; }
};

struct Fr {
    static constexpr int W = 8;
    static constexpr int K = 16;
    static constexpr uint32_t N0 = 0xffffffffu;
    static DEV uint32_t p(int i) { return FR_P[i]; }
    static DEV uint32_t one(int i) { return FR_ONE[i]; }
};

template <class F>
struct El {
    uint32_t v[F::W];
};

// ---------------------------------------------------------------------------
// Loads and stores in the (K, N) limbs-first layout (plane stride = n slots)
// ---------------------------------------------------------------------------

template <class F>
DEV El<F> fp_load(const uint32_t* base, size_t n, size_t idx) {
    El<F> r;
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        uint32_t lo = base[(size_t)(2 * j) * n + idx];
        uint32_t hi = base[(size_t)(2 * j + 1) * n + idx];
        r.v[j] = (lo & 0xffffu) | (hi << 16);
    }
    return r;
}

template <class F>
DEV void fp_store(uint32_t* base, size_t n, size_t idx, const El<F>& a) {
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        base[(size_t)(2 * j) * n + idx] = a.v[j] & 0xffffu;
        base[(size_t)(2 * j + 1) * n + idx] = a.v[j] >> 16;
    }
}

template <class F>
DEV El<F> fp_zero() {
    El<F> r;
    UNROLL
    for (int j = 0; j < F::W; ++j) r.v[j] = 0u;
    return r;
}

template <class F>
DEV El<F> fp_one() {
    El<F> r;
    UNROLL
    for (int j = 0; j < F::W; ++j) r.v[j] = F::one(j);
    return r;
}

template <class F>
DEV bool fp_is_zero(const El<F>& a) {
    uint32_t acc = 0u;
    UNROLL
    for (int j = 0; j < F::W; ++j) acc |= a.v[j];
    return acc == 0u;
}

// a where take else b
template <class F>
DEV El<F> fp_cmov(bool take, const El<F>& a, const El<F>& b) {
    El<F> r;
    uint32_t m = take ? 0xffffffffu : 0u;
    UNROLL
    for (int j = 0; j < F::W; ++j) r.v[j] = (a.v[j] & m) | (b.v[j] & ~m);
    return r;
}

// ---------------------------------------------------------------------------
// Modular add / sub / neg
// ---------------------------------------------------------------------------

// value = top * 2^(32W) + t, known to be < 2p  ->  value mod p
template <class F>
DEV El<F> fp_cond_sub_p(const El<F>& t, uint32_t top) {
    El<F> d;
    uint64_t br = 0;
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        uint64_t s = (uint64_t)t.v[j] - F::p(j) - br;
        d.v[j] = (uint32_t)s;
        br = s >> 63;
    }
    // value >= p  iff  the overflow word is set or the subtraction did not borrow
    return fp_cmov<F>((top != 0u) | (br == 0u), d, t);
}

template <class F>
DEV El<F> fp_add(const El<F>& a, const El<F>& b) {
    El<F> t;
    uint64_t c = 0;
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        c += (uint64_t)a.v[j] + b.v[j];
        t.v[j] = (uint32_t)c;
        c >>= 32;
    }
    return fp_cond_sub_p<F>(t, (uint32_t)c);
}

template <class F>
DEV El<F> fp_sub(const El<F>& a, const El<F>& b) {
    El<F> d;
    uint64_t br = 0;
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        uint64_t s = (uint64_t)a.v[j] - b.v[j] - br;
        d.v[j] = (uint32_t)s;
        br = s >> 63;
    }
    // a < b: add p back
    uint32_t m = (uint32_t)0 - (uint32_t)br;
    uint64_t c = 0;
    UNROLL
    for (int j = 0; j < F::W; ++j) {
        c += (uint64_t)d.v[j] + (F::p(j) & m);
        d.v[j] = (uint32_t)c;
        c >>= 32;
    }
    return d;
}

// 0 - a: p - a, and 0 stays 0
template <class F>
DEV El<F> fp_neg(const El<F>& a) {
    return fp_sub<F>(fp_zero<F>(), a);
}

// ---------------------------------------------------------------------------
// Montgomery product and square
// ---------------------------------------------------------------------------

// a*b*R^-1 mod p by CIOS: per word of b, add a*b_i into a (W+2)-word sum,
// add m*p with m chosen so that the lowest word becomes 0, shift one word down.
template <class F>
DEV El<F> fp_mul(const El<F>& a, const El<F>& b) {
    constexpr int W = F::W;
    uint32_t t[W + 2];
    UNROLL
    for (int j = 0; j < W + 2; ++j) t[j] = 0u;
    UNROLL
    for (int i = 0; i < W; ++i) {
        uint64_t c = 0;
        UNROLL
        for (int j = 0; j < W; ++j) {
            uint64_t s = (uint64_t)a.v[j] * b.v[i] + t[j] + c;
            t[j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[W] + c;
        t[W] = (uint32_t)s;
        t[W + 1] = (uint32_t)(s >> 32);

        uint32_t m = t[0] * F::N0;
        s = (uint64_t)m * F::p(0) + t[0];
        c = s >> 32;
        UNROLL
        for (int j = 1; j < W; ++j) {
            s = (uint64_t)m * F::p(j) + t[j] + c;
            t[j - 1] = (uint32_t)s;
            c = s >> 32;
        }
        s = (uint64_t)t[W] + c;
        t[W - 1] = (uint32_t)s;
        t[W] = t[W + 1] + (uint32_t)(s >> 32);
    }
    El<F> r;
    UNROLL
    for (int j = 0; j < W; ++j) r.v[j] = t[j];
    return fp_cond_sub_p<F>(r, t[W]);
}

// a*a*R^-1 mod p with the symmetric products taken once: the W(W-1)/2 cross
// products are summed, doubled by a one-bit shift, the W squares are added on
// the diagonal, and the 2W-word square is reduced word by word.
template <class F>
DEV El<F> fp_sqr(const El<F>& a) {
    constexpr int W = F::W;
    uint32_t t[2 * W];
    UNROLL
    for (int j = 0; j < 2 * W; ++j) t[j] = 0u;
    UNROLL
    for (int i = 0; i < W - 1; ++i) {
        uint64_t c = 0;
        UNROLL
        for (int j = i + 1; j < W; ++j) {
            uint64_t s = (uint64_t)a.v[i] * a.v[j] + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
        t[i + W] = (uint32_t)c;
    }
    UNROLL
    for (int j = 2 * W - 1; j > 0; --j) t[j] = (t[j] << 1) | (t[j - 1] >> 31);
    t[0] <<= 1;
    {
        uint64_t c = 0;
        UNROLL
        for (int i = 0; i < W; ++i) {
            uint64_t s = (uint64_t)a.v[i] * a.v[i] + t[2 * i] + c;
            t[2 * i] = (uint32_t)s;
            c = s >> 32;
            s = (uint64_t)t[2 * i + 1] + c;
            t[2 * i + 1] = (uint32_t)s;
            c = s >> 32;
        }
    }
    uint32_t top = 0u;
    UNROLL
    for (int i = 0; i < W; ++i) {
        uint32_t m = t[i] * F::N0;
        uint64_t c = 0;
        UNROLL
        for (int j = 0; j < W; ++j) {
            uint64_t s = (uint64_t)m * F::p(j) + t[i + j] + c;
            t[i + j] = (uint32_t)s;
            c = s >> 32;
        }
        uint64_t s = (uint64_t)t[i + W] + c + top;
        t[i + W] = (uint32_t)s;
        top = (uint32_t)(s >> 32);
    }
    El<F> r;
    UNROLL
    for (int j = 0; j < W; ++j) r.v[j] = t[j + W];
    return fp_cond_sub_p<F>(r, top);
}

// ---------------------------------------------------------------------------
// Lane bodies: what one thread does (see g1.cuh; the product's, the
// square's, the add's and the sub's are field_carry.cuh's).
// ---------------------------------------------------------------------------

// The radix-2 butterfly: (e + w*o, e - w*o).
template <class F>
DEV void fp_butterfly(const El<F>& e, const El<F>& o, const El<F>& w,
                      El<F>& hi, El<F>& lo) {
    El<F> t = fp_mul<F>(o, w);
    hi = fp_add<F>(e, t);
    lo = fp_sub<F>(e, t);
}

// Elementwise butterfly on five (K, n) planes.
template <class F>
DEV void butterfly_lane(const uint32_t* e, const uint32_t* o, const uint32_t* w,
                        uint32_t* hi, uint32_t* lo, size_t n, size_t idx) {
    El<F> h, l;
    fp_butterfly<F>(fp_load<F>(e, n, idx), fp_load<F>(o, n, idx),
                    fp_load<F>(w, n, idx), h, l);
    fp_store<F>(hi, n, idx, h);
    fp_store<F>(lo, n, idx, l);
}
