// Host build of the kernels' lane bodies: the same device code as the CUDA
// kernels (field.cuh, g1.cuh), compiled as plain C++ and run in a loop over
// the lanes.  It lets a machine without a GPU hold the kernels' arithmetic
// against the plain PyTorch versions (tests/test_torch_csrc_host.py):
//
//   g++ -O2 -std=c++17 -shared -fPIC -o libhost_check.so host_check.cpp
//
// It is not part of the GPU build (_build.py compiles only *.cu).

#include "g1.cuh"

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

}  // extern "C"
