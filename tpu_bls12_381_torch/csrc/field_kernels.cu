// Elementwise field kernels over (K, N) limb planes: Montgomery product and
// square, the Fermat inverse, modular add and sub (with the doubling and the
// negation), the modular sum of a vector, and the radix-2 NTT butterfly.
//
// They take the place of the JAX package's fields/pallas_ops.py kernels
// _build_mul_kernel (mont_mul), _build_sqr_kernel (mont_sqr),
// _build_add_kernel (add), _build_sub_kernel (sub) and
// _build_butterfly_kernel (butterfly), for Fr (K = 16) and Fq (K = 24);
// field_inv takes the place of the two product kernels as the JAX package's
// fields/ops.py inv_mont chains them (a^(p-2), one jitted loop there);
// field_sum takes the place of the add kernel as the JAX package's
// vecops.py vector_sum chains it (log2 n halving rounds, one add each).
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
// field_add and field_sub move the product's bytes for a handful of
// additions: the memory binds them outright, and the layout (a 16-bit limb
// in a 32-bit slot) sets how far down they go.  So they move no byte more
// than the function needs: one add chain, one subtract chain and a select
// on the carry flag (fp_add_cc, fp_sub_cc), four lanes a thread for Fr and
// one for Fq (the reverse of the product: fields/sweeps.py --builds), and
// the operand forms the paths call, each moving only its planes: two planes;
// a plane and a (K, 1) column held in registers (a scalar added to a
// vector; for the sub on either side); one plane alone, a + a (the
// doubling) and 0 - a (the negation), which read one plane and write one.
//
// field_sum: (K, rows, n) -> (K, rows) in one pass over the input, where
// the halving rounds made log2 n launches and copied each round's halves.
// A block sums a grid-stride part of its row in registers (coalesced
// loads, four neighbouring lanes a step where the row allows it), then a
// shuffle tree over its warps' words and one more over the warps' partials
// in shared memory, and writes one partial a block; a second launch of the
// same kernel sums a row's partials (it read faster than one launch whose
// last block sums them, and than one lane a step: fields/sweeps.py
// --builds).  A row short enough for one block takes one launch.  Modular addition of canonical values is
// exact, so any association gives the halving tree's limbs bit for bit.
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

// SUB: the difference, else the sum; MODE: the operands (AddSubMode).
template <class F, bool SUB, int MODE, bool FOUR>
__global__ void __launch_bounds__(THREADS)
addsub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
              uint32_t* __restrict__ out, size_t n) {
    const size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (u >= (FOUR ? n / 4 : n)) return;
    const El<F> c = MODE == AS_COLUMN || MODE == AS_COLUMN_LEFT ? fp_load<F>(b, 1, 0)
                                                                 : fp_zero<F>();
    if constexpr (FOUR)
        addsub_lanes4<F, SUB, MODE>(a, b, c, out, n, 4 * u);
    else
        addsub_lane1<F, SUB, MODE>(a, b, c, out, n, u);
}

// The sum of each lane of a shuffle tree: the value of lane 0 is the warp's.
template <class F>
__device__ __forceinline__ El<F> sum_warp(El<F> x) {
    UNROLL
    for (int off = 16; off > 0; off >>= 1) {
        El<F> y;
        UNROLL
        for (int j = 0; j < F::W; ++j) y.v[j] = __shfl_down_sync(0xffffffffu, x.v[j], off);
        x = fp_add_cc<F>(x, y);
    }
    return x;
}

// Block k of a pass over (K, rows, n): part g = k % G of row b = k / G
// (G = gridDim.x / rows blocks a row), summed into element k of out,
// (K, rows, G).
template <class F, bool FOUR>
__global__ void __launch_bounds__(SUM_THREADS)
field_sum_kernel(const uint32_t* __restrict__ v, uint32_t* __restrict__ out, size_t n,
                 size_t rows) {
    __shared__ uint32_t part[SUM_THREADS / 32][F::W];
    const size_t G = gridDim.x / rows, b = blockIdx.x / G, g = blockIdx.x % G;
    El<F> acc = sum_warp<F>(sum_run<F, FOUR>(v + b * n, rows * n, n,
                                             g * SUM_THREADS + threadIdx.x, G * SUM_THREADS));
    const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        UNROLL
        for (int j = 0; j < F::W; ++j) part[warp][j] = acc.v[j];
    }
    __syncthreads();
    if (warp != 0) return;
    acc = fp_zero<F>();
    if (lane < SUM_THREADS / 32) {
        UNROLL
        for (int j = 0; j < F::W; ++j) acc.v[j] = part[lane][j];
    }
    acc = sum_warp<F>(acc);
    if (lane == 0) fp_store<F>(out, rows * G, blockIdx.x, acc);
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

template <class F, bool SUB, int MODE>
static int launch_addsub(const void* a, const void* b, void* out, long long n,
                         void* stream) {
    if (n > 0) {
        const uint32_t *pa = (const uint32_t*)a, *pb = (const uint32_t*)b;
        uint32_t* po = (uint32_t*)out;
        cudaStream_t st = (cudaStream_t)stream;
        if (addsub_takes_four<F>((size_t)n, MODE, a, b, out))
            addsub_kernel<F, SUB, MODE, true><<<blocks_for((size_t)n / 4), THREADS, 0, st>>>(
                pa, pb, po, (size_t)n);
        else
            addsub_kernel<F, SUB, MODE, false><<<blocks_for((size_t)n), THREADS, 0, st>>>(
                pa, pb, po, (size_t)n);
    }
    return (int)cudaGetLastError();
}

template <class F>
static void sum_pass(const uint32_t* v, uint32_t* out, size_t n, size_t rows, size_t G,
                     cudaStream_t st) {
    const unsigned blocks = (unsigned)(rows * G);
    if (field_sum_takes_four(n, v))
        field_sum_kernel<F, true><<<blocks, SUM_THREADS, 0, st>>>(v, out, n, rows);
    else
        field_sum_kernel<F, false><<<blocks, SUM_THREADS, 0, st>>>(v, out, n, rows);
}

// (K, rows, n) -> (K, rows): one pass of field_sum_blocks(n, rows) blocks a
// row into scratch (K, rows, G), a second over the partials; one pass
// straight into out where G is 1.
template <class F>
static int launch_sum(const void* v, void* out, void* scratch, long long n, long long rows,
                      void* stream) {
    if (n > 0 && rows > 0) {
        cudaStream_t st = (cudaStream_t)stream;
        const size_t G = field_sum_blocks((size_t)n, (size_t)rows);
        uint32_t* first = (uint32_t*)(G == 1 ? out : scratch);
        sum_pass<F>((const uint32_t*)v, first, (size_t)n, (size_t)rows, G, st);
        if (G > 1) sum_pass<F>(first, (uint32_t*)out, G, (size_t)rows, 1, st);
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

// add and sub: a, b planes of one shape; _col: b one element (K, 1);
// _col_left: a - b with a the (K, 1) column and b the plane, passed as
// (plane, column); double: a + a; neg: 0 - a (b unused).
int fr_field_add(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fr, false, AS_PLANES>(a, b, out, n, stream);
}

int fq_field_add(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fq, false, AS_PLANES>(a, b, out, n, stream);
}

int fr_field_add_col(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fr, false, AS_COLUMN>(a, b, out, n, stream);
}

int fq_field_add_col(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fq, false, AS_COLUMN>(a, b, out, n, stream);
}

int fr_field_double(const void* a, void* out, long long n, void* stream) {
    return launch_addsub<Fr, false, AS_ALONE>(a, a, out, n, stream);
}

int fq_field_double(const void* a, void* out, long long n, void* stream) {
    return launch_addsub<Fq, false, AS_ALONE>(a, a, out, n, stream);
}

int fr_field_sub(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fr, true, AS_PLANES>(a, b, out, n, stream);
}

int fq_field_sub(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fq, true, AS_PLANES>(a, b, out, n, stream);
}

int fr_field_sub_col(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fr, true, AS_COLUMN>(a, b, out, n, stream);
}

int fq_field_sub_col(const void* a, const void* b, void* out, long long n, void* stream) {
    return launch_addsub<Fq, true, AS_COLUMN>(a, b, out, n, stream);
}

int fr_field_sub_col_left(const void* a, const void* b, void* out, long long n,
                          void* stream) {
    return launch_addsub<Fr, true, AS_COLUMN_LEFT>(a, b, out, n, stream);
}

int fq_field_sub_col_left(const void* a, const void* b, void* out, long long n,
                          void* stream) {
    return launch_addsub<Fq, true, AS_COLUMN_LEFT>(a, b, out, n, stream);
}

int fr_field_neg(const void* a, void* out, long long n, void* stream) {
    return launch_addsub<Fr, true, AS_ALONE>(a, a, out, n, stream);
}

int fq_field_neg(const void* a, void* out, long long n, void* stream) {
    return launch_addsub<Fq, true, AS_ALONE>(a, a, out, n, stream);
}

// The sum of every row of (K, rows, n) into (K, rows); scratch holds
// (K, rows, field_sum_blocks(n, rows)) elements where that is above 1.
int fr_field_sum(const void* v, void* out, void* scratch, long long n, long long rows,
                 void* stream) {
    return launch_sum<Fr>(v, out, scratch, n, rows, stream);
}

int fq_field_sum(const void* v, void* out, void* scratch, long long n, long long rows,
                 void* stream) {
    return launch_sum<Fq>(v, out, scratch, n, rows, stream);
}

long long field_sum_blocks_per_row(long long n, long long rows) {
    return (long long)field_sum_blocks((size_t)n, (size_t)rows);
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
