// Host build of the kernels' lane bodies: the same device code as the CUDA
// kernels (field.cuh, g1.cuh, g1_jac.cuh, g2.cuh, ntt.cuh), compiled as plain C++ and run in a
// loop over the lanes (for the NTT tile: over the blocks, and inside a block
// over its elements and pairs, with a heap array for the shared memory).  It lets a machine without a GPU hold the kernels' arithmetic
// against the plain PyTorch versions (tests/test_torch_csrc_host.py):
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libhost_check.so host_check.cpp
//
// It is not part of the GPU build (_build.py compiles only *.cu).

#include <vector>

#include "g1.cuh"
#include "g1_jac.cuh"
#include "g2.cuh"
#include "ntt.cuh"

extern "C" {

void fr_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mont_mul_lane<Fr>(a, b, out, n, i);
}

void fq_mont_mul(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mont_mul_lane<Fq>(a, b, out, n, i);
}

void fr_mont_sqr(const uint32_t* a, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mont_sqr_lane<Fr>(a, out, n, i);
}

void fq_mont_sqr(const uint32_t* a, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) mont_sqr_lane<Fq>(a, out, n, i);
}

void fr_field_add(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) add_lane<Fr>(a, b, out, n, i);
}

void fq_field_add(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) add_lane<Fq>(a, b, out, n, i);
}

void fr_field_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) sub_lane<Fr>(a, b, out, n, i);
}

void fq_field_sub(const uint32_t* a, const uint32_t* b, uint32_t* out, size_t n) {
    for (size_t i = 0; i < n; ++i) sub_lane<Fq>(a, b, out, n, i);
}

void fr_butterfly(const uint32_t* e, const uint32_t* o, const uint32_t* w,
                  uint32_t* hi, uint32_t* lo, size_t n) {
    for (size_t i = 0; i < n; ++i) butterfly_lane<Fr>(e, o, w, hi, lo, n, i);
}

void fr_butterfly_stage(const uint32_t* x, const uint32_t* tw, uint32_t* out,
                        size_t rows, size_t n, size_t half) {
    for (size_t i = 0; i < rows * (n / 2); ++i)
        butterfly_stage_lane<Fr>(x, tw, out, rows, n, half, i);
}

// The tile kernel's body, block by block.
void fr_ntt_tile(const uint32_t* x, const uint32_t* tw, const uint32_t* w,
                 const uint32_t* scale, uint32_t* out, size_t rows, size_t w_rows,
                 int log_m) {
    uint32_t cap = tile_rows_per_block(log_m) << log_m;
    size_t total = rows << log_m;
    std::vector<uint32_t> sh((size_t)cap * Fr::W);
    fr sc;
    if (scale != nullptr) sc = fp_load<Fr>(scale, 1, 0);
    for (size_t base = 0; base < total; base += cap) {
        for (uint32_t e = 0; e < cap; ++e) tile_load(x, total, base, sh.data(), cap, e);
        for (int s = 1; s <= log_m; ++s)
            for (uint32_t q = 0; q < cap / 2; ++q)
                tile_butterfly(sh.data(), cap, tw, log_m, s, q);
        for (uint32_t e = 0; e < cap; ++e)
            tile_store(sh.data(), cap, e, base, total, log_m, w, w_rows,
                       scale != nullptr ? &sc : nullptr, out);
    }
}

void fq_add_sub(const uint32_t* a, const uint32_t* b, uint32_t* sum,
                uint32_t* diff, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        fq x = fp_load<Fq>(a, n, i), y = fp_load<Fq>(b, n, i);
        fp_store<Fq>(sum, n, i, fq_add(x, y));
        fp_store<Fq>(diff, n, i, fq_sub(x, y));
    }
}

void g1_pmadd_signed(const uint32_t* accX, const uint32_t* accY, const uint32_t* accZ,
                     const uint32_t* x2, const uint32_t* y2, size_t row_stride,
                     const uint8_t* inf2, const uint8_t* sign,
                     uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t L, int R) {
    for (size_t i = 0; i < L; ++i)
        g1_pmadd_signed_lane(accX, accY, accZ, x2, y2, row_stride, inf2, sign,
                             X3, Y3, Z3, L, R, i);
}

void g1_pmadd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
              const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
              uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_pmadd_lane(X1, Y1, Z1, x2, y2, inf2, X3, Y3, Z3, n, i);
}

void g1_padd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_padd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, i);
}

void g1_pdbl(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i) g1_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, i);
}

void g1_jdbl(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i) g1_jdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, i);
}

void g1_madd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* x2, const uint32_t* y2, const uint8_t* inf2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_madd_lane(X1, Y1, Z1, x2, y2, inf2, X3, Y3, Z3, n, i);
}

void g1_jadd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g1_jadd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, i);
}

// Fq2 products, squares and 12(1+u) multiples on (24, 2, n) batches.
void fq2_ops(const uint32_t* a, const uint32_t* b, uint32_t* prod,
             uint32_t* sqr, uint32_t* m12, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        fq2 x = fq2_load(a, n, i), y = fq2_load(b, n, i);
        fq2_store(prod, n, i, fq2_mul(x, y));
        fq2_store(sqr, n, i, fq2_sqr(x));
        fq2_store(m12, n, i, fq2_mul12(x));
    }
}

void g2_pmadd(const uint32_t* accX, const uint32_t* accY, const uint32_t* accZ,
              const uint32_t* x2, const uint32_t* y2, size_t row_stride,
              const uint8_t* inf2, const uint8_t* sign,
              uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t L, int R) {
    for (size_t i = 0; i < L; ++i)
        g2_pmadd_lane(accX, accY, accZ, x2, y2, row_stride, inf2, sign,
                      X3, Y3, Z3, L, R, i);
}

void g2_padd(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             const uint32_t* X2, const uint32_t* Y2, const uint32_t* Z2,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i)
        g2_padd_lane(X1, Y1, Z1, X2, Y2, Z2, X3, Y3, Z3, n, i);
}

void g2_pdbl(const uint32_t* X1, const uint32_t* Y1, const uint32_t* Z1,
             uint32_t* X3, uint32_t* Y3, uint32_t* Z3, size_t n) {
    for (size_t i = 0; i < n; ++i) g2_pdbl_lane(X1, Y1, Z1, X3, Y3, Z3, n, i);
}

}  // extern "C"
