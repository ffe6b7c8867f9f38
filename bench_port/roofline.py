"""Peaks of one H100 SXM and the work of the benchmark's calls, counted from
their shapes alone: never from the program's plan, window size or kernels,
so that the count stays the same whatever implements the call.

Memory: 3.35 TB/s (NVIDIA's data sheet).  Integer: the data sheet gives
67 TFLOP/s of float32, which is 128 lanes x 132 SMs x 1.98 GHz x 2 (a fused
multiply-add counts twice); 64 of an SM's 128 lanes take 32-bit integer
multiply-adds, so the card does 67e12 / 2 / 2 = 16.75e12 of them a second.
That is derived, not a published integer rate.  A 32 x 32 -> 64-bit
multiply-add takes two of those slots (the low and the high half).  Both
rates assume the card's full power limit of 700 W; a share is stated with
the card's limit beside it.

A Montgomery product on W 32-bit words takes 2 W^2 + W wide multiply-adds
(the product, the reduction, one m a word): 300 for Fq (W = 12), 136 for Fr
(W = 8).  Additions, carries, selects and addresses are not counted.
"""

from __future__ import annotations

MEM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 2 / 2
SLOTS_PER_WIDE_MAD = 2
LIMB_BYTES = 2                  # a 16-bit limb, as the function must move it

FR_BITS = 255
WINDOW_BITS = 16
FQ_PRODUCTS_PER_MIXED_ADD = 11
FQ_LIMBS, FR_LIMBS = 24, 16


def mul_mads(words: int) -> int:
    return 2 * words * words + words


def least_ms(bytes_moved: float, wide_mads: float) -> float:
    """Least milliseconds for the work: the larger of its bytes over the
    memory rate and its multiply-add slots over the integer rate."""
    t_bytes = bytes_moved / MEM_BYTES_PER_S
    t_ops = wide_mads * SLOTS_PER_WIDE_MAD / INT32_MAD_PER_S
    return max(t_bytes, t_ops) * 1e3


def commit_work(points: int) -> tuple[int, int]:
    """(bytes, wide multiply-adds) of committing ``points`` scalars: a mixed
    addition a scalar for each of its ceil(255 / 16) = 16 windows, each 11 Fq
    products; the affine bases (96 bytes) and the scalars (32 bytes) read
    once."""
    windows = -(-FR_BITS // WINDOW_BITS)
    mads = points * windows * FQ_PRODUCTS_PER_MIXED_ADD * mul_mads(FQ_LIMBS // 2)
    nbytes = points * (2 * FQ_LIMBS + FR_LIMBS) * LIMB_BYTES
    return nbytes, mads


def transform_work(n: int, batch: int = 1, coset: bool = False) -> tuple[int, int]:
    """(bytes, wide multiply-adds) of ``batch`` transforms of length n: the
    radix-2 ladder's (n/2) log2 n butterfly products less the n - 1 by
    w^0 = 1, plus n products for a coset's shift; n Fr elements read once
    and written once."""
    log_n = n.bit_length() - 1
    products = (n // 2) * log_n - (n - 1) + (n if coset else 0)
    return batch * n * FR_LIMBS * LIMB_BYTES * 2, batch * products * mul_mads(FR_LIMBS // 2)
