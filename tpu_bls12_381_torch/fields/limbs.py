"""Limb codecs: python int <-> 16-bit-limb arrays <-> little-endian bytes.

Own copy of the JAX package's ``fields/limbs.py`` (numpy only).  The
layout at every public function is the JAX package's: a field element is a
vector of 16-bit limbs, little-endian limb order, **limbs-first** shape
``(K, *batch)``.  With the batch axis last, neighbouring CUDA threads read
neighbouring addresses of one limb plane, so the loads coalesce as they are.
The kernels repack pairs of limbs into 32-bit words in registers.

Montgomery R is 2^(16*K): 2^256 for Fr (K=16) and 2^384 for Fq (K=24), so
Montgomery-form images are the same bits whatever the inner radix.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, k: int) -> np.ndarray:
    """Non-negative int -> (k,) uint32 array of 16-bit limbs, little-endian."""
    if x < 0:
        raise ValueError("negative")
    out = np.empty(k, dtype=np.uint32)
    for i in range(k):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("int does not fit in limbs")
    return out


def limbs_to_int(limbs) -> int:
    """(k,) limb array -> python int."""
    x = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in range(arr.shape[0] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(arr[i])
    return x


def ints_to_limbs(xs, k: int) -> np.ndarray:
    """Iterable of ints -> (k, n) uint32 limbs-first array."""
    xs = list(xs)
    out = np.empty((k, len(xs)), dtype=np.uint32)
    for j, x in enumerate(xs):
        out[:, j] = int_to_limbs(x, k)
    return out


def limbs_to_ints(limbs) -> list:
    """(k, n) limbs-first array -> list of n python ints."""
    arr = np.asarray(limbs)
    if arr.ndim == 1:
        return [limbs_to_int(arr)]
    flat = arr.reshape(arr.shape[0], -1)
    return [limbs_to_int(flat[:, j]) for j in range(flat.shape[1])]


def limbs_to_bytes_le(limbs) -> bytes:
    """(k, n) limbs-first -> concatenated little-endian 2-byte-per-limb images.

    For K=24 (Fq) this is the 48-byte little-endian wire layout, identical to
    the raw memory image of the reference's 6x64-bit little-endian limbs —
    the property ``core/types.rs:89-108`` asserts for its zero-copy casts.
    """
    arr = np.asarray(limbs, dtype=np.uint32)
    if arr.ndim == 1:
        arr = arr[:, None]
    le16 = arr.astype("<u2")  # (k, n)
    return le16.T.tobytes()  # element-major: n blocks of k*2 bytes


def bytes_le_to_limbs(data: bytes, k: int) -> np.ndarray:
    """Inverse of limbs_to_bytes_le -> (k, n) uint32."""
    a = np.frombuffer(data, dtype="<u2").reshape(-1, k)
    return a.T.astype(np.uint32)
