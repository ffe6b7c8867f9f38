// The radix-2 ladder's stages, several in one launch: `count` consecutive DIT
// stages (count <= 6), from half = 2^log_h0 up, on each row of a (16, rows,
// n) array of Fr elements, then optionally times one scalar (16,).  At count
// = 1 it is one stage of the ladder on the array where it lies.
//
// Takes the place of the JAX package's fields/pallas_ops.py butterfly
// (_build_butterfly_kernel), which the JAX ladder (ntt/ntt.py) calls once a
// stage through slices and a concatenation.  On the card the ladder's low
// stages run as one tile launch (ntt_kernels.cu, bit-reversed rows in: in a
// DIT ladder on bit-reversed input the first c stages never leave aligned
// runs of 2^c elements) and the stages above c in one or two launches of
// this kernel.  ntt.cuh says how a block works: a slab of 2^11 elements,
// C >= 8 neighbouring offsets by the 2^count elements at stride half of
// each (and whole runs above, where half is small), 4 values a thread in
// registers, two of i's bits a round, through 64 KB of shared memory
// between rounds (none at count <= 2), the carry-chain product.
//
// What bounds it on an H100: a launch reads and writes the array once (2^22
// x 16 limbs: 0.080 ms at 2 bytes a limb, 0.160 ms as stored) and does
// count x n/2 products a row (0.034 ms a stage at 2^22 by their
// multiply-adds): the bytes, up to about five stages a launch, by that
// reckoning.  In fact the butterflies' instructions take about half a
// launch, and the loads, stores, exchanges and spills the rest (ntt.cuh).
// The twiddles come on top: stage s reads
// w_(2^s)^j from a table of a size-2^S domain at stride 2^(S - s); the
// router hands a launch below the top the table of its own top stage, so its
// entries lie close together.
//
// Plain C interface for ctypes, as field_kernels.cu.

#include <cuda_runtime.h>

#include "ntt.cuh"

extern __shared__ uint32_t stages_sh[];

// 512 threads of four values, two blocks an SM (64 registers a thread, and
// some spill; ntt/sweeps.py times the builds with eight values a thread and
// at one block an SM against it).
__global__ void __launch_bounds__(ntt_threads(NTT_SLAB_BITS, NTT_STAGES_EB), 2)
butterfly_stages_kernel(StagesArgs a) {
    stages_round(a, blockIdx.x, threadIdx.x, 0, stages_sh);
    for (int rnd = 1; NTT_STAGES_EB * rnd < a.count; ++rnd) {
        __syncthreads();
        stages_round(a, blockIdx.x, threadIdx.x, rnd, stages_sh);
    }
}

extern "C" {

// x, out: (16, total) with total a multiple of 2^(log_h0 + count); tw:
// (16, 2^(log_s - 1)), the table of the size-2^log_s domain, log_h0 + count
// <= log_s; scale: (16,) or null.  1 <= count <= 6.
int fr_butterfly_stages(const void* x, const void* tw, const void* scale, void* out,
                        long long total, int log_h0, int count, int log_s,
                        void* stream) {
    if (total <= 0) return (int)cudaGetLastError();
    if (count < 1 || count > NTT_MAX_STAGES || log_h0 < 0 || log_h0 + count > log_s)
        return (int)cudaErrorInvalidValue;
    StagesArgs a;
    a.x = (const uint32_t*)x;
    a.tw = (const uint32_t*)tw;
    a.scale = (const uint32_t*)scale;
    a.out = (uint32_t*)out;
    a.total = (size_t)total;
    a.log_h0 = log_h0;
    a.count = count;
    a.log_s = log_s;
    a.lo = stages_lo(log_h0, count);
    size_t bytes = 0;
    if (count > NTT_STAGES_EB) {
        bytes = ((size_t)1 << NTT_SLAB_BITS) * NTT_ELEM_BYTES;
        cudaError_t err = cudaFuncSetAttribute(
            butterfly_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    size_t blocks = stages_blocks(a.total, log_h0, count);
    butterfly_stages_kernel<<<(unsigned)blocks, ntt_threads(NTT_SLAB_BITS, NTT_STAGES_EB), bytes,
                              (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

// Blocks of the kernel an SM holds at once for a launch of `count` stages
// (the occupancy calculator's answer, for chip_smoke.py), or -1.
int fr_butterfly_stages_blocks_per_sm(int count) {
    int blocks = -1;
    size_t bytes = count > NTT_STAGES_EB ? ((size_t)1 << NTT_SLAB_BITS) * NTT_ELEM_BYTES : 0;
    if (bytes)
        cudaFuncSetAttribute(butterfly_stages_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, butterfly_stages_kernel, ntt_threads(NTT_SLAB_BITS, NTT_STAGES_EB), bytes);
    return blocks;
}

}  // extern "C"
