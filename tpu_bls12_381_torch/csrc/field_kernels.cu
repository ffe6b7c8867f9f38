// Elementwise field kernels over (K, N) limb planes: Montgomery product and
// square, the Fermat inverse, modular add and sub, and the radix-2 NTT
// butterfly.
//
// They take the place of the JAX package's fields/pallas_ops.py kernels
// _build_mul_kernel (mont_mul), _build_sqr_kernel (mont_sqr),
// _build_add_kernel (add), _build_sub_kernel (sub) and
// _build_butterfly_kernel (butterfly), for Fr (K = 16) and Fq (K = 24);
// field_inv takes the place of the two product kernels as the JAX package's
// fields/ops.py inv_mont chains them (a^(p-2), one jitted loop there).
//
// mont_mul and mont_sqr (field_carry.cuh has their lane bodies): an Fq
// product moves 3 * 24 * 4 = 288 bytes as stored (a 16-bit limb in a 32-bit
// slot) for 2 * 12^2 + 12 = 300 wide multiply-adds; at the card's peak rates
// the bytes take about 2.4 times as long, so the memory binds.  So:
//  * the carry-chain product (fp_mul_cc), which leaves the multiply-adds
//    well under the memory's time; the square is the product a*a;
//  * for Fq a thread takes four neighbouring lanes and reads or writes each
//    limb plane with one 16-byte access, neighbouring threads on
//    neighbouring addresses, a thread for every four lanes; Fr's lighter
//    product reads faster one lane a thread (so do none of a grid of the
//    blocks the SMs hold at once walking the lanes with a grid stride, or
//    streaming hints: fields/sweeps.py --builds has each);
//  * a factor that is one element (a (K, 1) column: from_mont's one, GLV's
//    beta, a scalar times a vector) is read once a thread and held in
//    registers, so the call moves two planes, not three;
//  * where n % 4 != 0 or a plane is not 16-byte aligned, one lane a thread
//    for Fq too: a path of the kernel, held to the plain version like the
//    other.
//
// field_inv: one thread a lane runs fp_inv_fermat (field_carry.cuh), a chain
// of 485 dependent products (Fq) from a 16-entry table in local memory.
// It serves few lanes (the affine conversion of a few points: fewer than
// 4096, above which vecops.batch_inverse takes over), where the port ran the
// ladder one product or square a launch, 610 launches for Fq: one thread's
// latency bounds it, so a block is one warp and 4096 lanes spread over 128
// SMs.  An inverse is unique and canonical, so the limbs equal any other
// inversion's bit for bit, inv(0) = 0 included.
//
// add and sub move the same bytes as the product for a handful of
// additions: the memory binds them outright.  The butterfly moves five
// elements for one product: the memory binds it three times over.  (The
// reckoning is in PERF.md.)  They are as first written: one thread an
// element, field.cuh's arithmetic.
//
// `butterfly` is the elementwise form of the TPU kernel: contiguous e, o, w
// of one shape in, hi and lo out.  The ladder's stages on the array where it
// lies, several a launch, are ntt_stages.cu's.
//
// Plain C interface for ctypes: pointers are device pointers to contiguous
// int32 planes, `stream` is a cudaStream_t, the return value is
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include "field_carry.cuh"

#define THREADS 128
#define INV_THREADS 32

// MODE: b a plane, one (K, 1) column, or (MUL_SQUARE, mont_sqr) a again.
template <class F, int MODE, bool FOUR>
__global__ void __launch_bounds__(THREADS)
mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                uint32_t* __restrict__ out, size_t n) {
    const size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (u >= (FOUR ? n / 4 : n)) return;
    const El<F> bc = MODE == MUL_COLUMN ? fp_load<F>(b, 1, 0) : fp_zero<F>();
    if constexpr (FOUR)
        mont_mul_lanes4<F, MODE>(a, b, bc, out, n, 4 * u);
    else
        mont_mul_lane1<F, MODE>(a, b, bc, out, n, u);
}

template <class F>
__global__ void __launch_bounds__(INV_THREADS)
field_inv_kernel(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    field_inv_lane<F>(a, out, n, idx);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
field_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    add_lane<F>(a, b, out, n, idx);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
field_sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    sub_lane<F>(a, b, out, n, idx);
}

template <class F>
__global__ void __launch_bounds__(THREADS)
butterfly_kernel(const uint32_t* __restrict__ e, const uint32_t* __restrict__ o,
                 const uint32_t* __restrict__ w, uint32_t* __restrict__ hi,
                 uint32_t* __restrict__ lo, size_t n) {
    size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= n) return;
    butterfly_lane<F>(e, o, w, hi, lo, n, idx);
}

static inline unsigned blocks_for(size_t n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

template <class F, int MODE>
static int launch_mul(const void* a, const void* b, void* out, long long n,
                      void* stream) {
    if (n > 0) {
        const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b;
        uint32_t* po = (uint32_t*)out;
        cudaStream_t st = (cudaStream_t)stream;
        if (mont_mul_takes_four<F>((size_t)n, MODE, a, b, out))
            mont_mul_kernel<F, MODE, true><<<blocks_for((size_t)n / 4), THREADS, 0, st>>>(
                pa, pb, po, (size_t)n);
        else
            mont_mul_kernel<F, MODE, false><<<blocks_for((size_t)n), THREADS, 0, st>>>(
                pa, pb, po, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static int launch_inv(const void* a, void* out, long long n, void* stream) {
    if (n > 0) {
        field_inv_kernel<F><<<(unsigned)((n + INV_THREADS - 1) / INV_THREADS), INV_THREADS,
                              0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (uint32_t*)out, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static int launch_add(const void* a, const void* b, void* out, long long n,
                      void* stream) {
    if (n > 0) {
        field_add_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static int launch_sub(const void* a, const void* b, void* out, long long n,
                      void* stream) {
    if (n > 0) {
        field_sub_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static int launch_butterfly(const void* e, const void* o, const void* w,
                            void* hi, void* lo, long long n, void* stream) {
    if (n > 0) {
        butterfly_kernel<F><<<blocks_for((size_t)n), THREADS, 0, (cudaStream_t)stream>>>(
            (const uint32_t*)e, (const uint32_t*)o, (const uint32_t*)w,
            (uint32_t*)hi, (uint32_t*)lo, (size_t)n);
    }
    return (int)cudaGetLastError();
}

extern "C" {

int fr_mont_mul(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_mul<Fr, MUL_PLANE>(a, b, out, n, stream);
}

int fq_mont_mul(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_mul<Fq, MUL_PLANE>(a, b, out, n, stream);
}

// b: one element (K, 1), the factor of every lane.
int fr_mont_mul_col(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_mul<Fr, MUL_COLUMN>(a, b, out, n, stream);
}

int fq_mont_mul_col(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_mul<Fq, MUL_COLUMN>(a, b, out, n, stream);
}

int fr_mont_sqr(const void* a, void* out, long long n, void* stream) {
    return launch_mul<Fr, MUL_SQUARE>(a, a, out, n, stream);
}

int fq_mont_sqr(const void* a, void* out, long long n, void* stream) {
    return launch_mul<Fq, MUL_SQUARE>(a, a, out, n, stream);
}

int fr_field_inv(const void* a, void* out, long long n, void* stream) {
    return launch_inv<Fr>(a, out, n, stream);
}

int fq_field_inv(const void* a, void* out, long long n, void* stream) {
    return launch_inv<Fq>(a, out, n, stream);
}

int fr_field_add(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_add<Fr>(a, b, out, n, stream);
}

int fq_field_add(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_add<Fq>(a, b, out, n, stream);
}

int fr_field_sub(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_sub<Fr>(a, b, out, n, stream);
}

int fq_field_sub(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_sub<Fq>(a, b, out, n, stream);
}

int fr_butterfly(const void* e, const void* o, const void* w, void* hi, void* lo,
                 long long n, void* stream) {
    return launch_butterfly<Fr>(e, o, w, hi, lo, n, stream);
}

int fq_butterfly(const void* e, const void* o, const void* w, void* hi, void* lo,
                 long long n, void* stream) {
    return launch_butterfly<Fq>(e, o, w, hi, lo, n, stream);
}

}  // extern "C"
