"""Element-wise field vector operations over Fr/Fq (Montgomery domain).

Counterpart of the JAX package's ``vecops.py``: add/sub/mul/scalar-mul/
scalar-add, the modular sum, the bit-reverse permutation, and batch inversion
by Montgomery's trick.  The field ops go through ``fields/fast.py``, so on
CUDA tensors every add, sub and product is one of the port's kernels (a
scalar is read as a (K, 1) column, never laid out as a vector); what lies
between them (slices, concatenations, gathers, selects) is plain torch.  The
modular sum is one reduction (``cuda_ops.field_sum``: one or two launches on
the card) where the JAX package makes a halving round of adds a launch.

Batch inversion keeps the JAX package's three phases (inclusive prefix
products down the rows of an (R, L) tiling, one Fermat inversion of the grand
product with log-depth lane scans stitching the columns, the unwind back up
the rows).  On the card each phase is one kernel that keeps its chain of
products in registers (``csrc/batch_inverse.cu``: three launches a call, the
tile from the tuning profile); on the CPU the phases are Python loops over
the rows of the plain product (``batch_inverse_plain``), the JAX package's
two ``lax.scan`` loops written out.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields import cuda_ops, fast, ops
from .fields.field import FieldSpec
from .tuning import CUDA_BATCH_INVERSE_LANES_LOG


# -- elementwise wrappers (the public vecops surface) --------------------------

def vector_add(spec: FieldSpec, a, b):
    return fast.add(spec, a, b)


def vector_sub(spec: FieldSpec, a, b):
    return fast.sub(spec, a, b)


def vector_mul(spec: FieldSpec, a, b):
    return fast.mont_mul(spec, a, b)


def _scalar_col(spec: FieldSpec, s, v):
    return s.reshape((spec.num_limbs,) + (1,) * (v.dim() - 1))


def scalar_vec_mul(spec: FieldSpec, s, v):
    """Broadcast one scalar s (K,) over the vector v (K, n)."""
    return fast.mont_mul(spec, _scalar_col(spec, s, v), v)


def scalar_vec_add(spec: FieldSpec, s, v):
    return fast.add(spec, _scalar_col(spec, s, v), v)


def vector_sum(spec: FieldSpec, v):
    """Modular sum of a field vector (K, ..., n) -> (K, ...).

    One reduction along the last axis (``cuda_ops.field_sum``; on the CPU its
    plain version, the JAX package's tree of log2(n) halving rounds).  A
    sum is exact, so the limbs are the tree's whatever the association.
    n == 1 returns ``v[..., 0]`` and launches nothing, as the tree does.
    """
    if v.shape[-1] == 1:
        return v[..., 0]
    return cuda_ops.field_sum(spec, v.contiguous())


# -- bit reverse ---------------------------------------------------------------

def bit_reverse_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


# The index tensor per (log_n, device), made once: an NTT permutes at one or
# two sizes, thousands of times.  2^22 indices are 32 MB; release_bit_reverse
# drops them.
_INDEX_CACHE: dict = {}


def _bit_reverse_index(log_n: int, device) -> torch.Tensor:
    key = (log_n, torch.device(device))
    idx = _INDEX_CACHE.get(key)
    if idx is None:
        idx = torch.from_numpy(
            bit_reverse_indices(log_n).astype(np.int64)).to(key[1])
        _INDEX_CACHE[key] = idx
    return idx


def release_bit_reverse() -> None:
    """Drop the cached index tensors."""
    _INDEX_CACHE.clear()


def bit_reverse(x, axis: int = -1):
    """Permute the given power-of-two axis into bit-reversed order."""
    n = x.shape[axis]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("bit_reverse needs a power-of-two axis")
    return torch.index_select(x, axis, _bit_reverse_index(log_n, x.device))


# -- batch inversion (Montgomery's trick) --------------------------------------

def batch_inverse_tile(n: int) -> tuple[int, int]:
    """The (R, L) tile of the batch-inversion kernels for n elements:
    L = min(2^CUDA_BATCH_INVERSE_LANES_LOG, n) columns, R rows."""
    L = max(1, min(1 << CUDA_BATCH_INVERSE_LANES_LOG, n))
    return -(-n // L), L


def batch_inverse(spec: FieldSpec, x):
    """Elementwise Montgomery-form inverse of x (K, ..., n) with ONE field
    inversion.  inv(0) = 0: zeros are taken as one and written back as 0.

    On the card: the three kernels of ``csrc/batch_inverse.cu``, three
    launches, raising if one fails.  On the CPU: ``batch_inverse_plain``.
    Inverses are unique and canonical, so both give the same limbs."""
    if not x.is_cuda:
        return batch_inverse_plain(spec, x)
    flat = x.reshape(spec.num_limbs, -1).contiguous()
    _, L = batch_inverse_tile(flat.shape[-1])
    return cuda_ops.batch_inverse(spec, flat, L).reshape(x.shape)


def batch_inverse_plain(spec: FieldSpec, x):
    """Plain version of the batch-inversion kernels: the three phases over
    the plain product (``fields/ops.py``), on the JAX package's tile of 4096
    columns."""
    return batch_inverse_loop(spec, x, ops.mont_mul, ops.mont_sqr)


def batch_inverse_loop(spec: FieldSpec, x, mul, sqr):
    """The three phases as a loop of elementwise products ``mul`` and
    squares ``sqr`` (the JAX package's ``batch_inverse``, its scans written
    out).  With ``fields/fast.py``'s product and square on the card this is
    one ``mont_mul`` or ``mont_sqr`` launch a step, the route of the port
    before the kernels."""
    K = spec.num_limbs
    flat = x.reshape(K, -1)
    n = flat.shape[-1]
    dev = flat.device
    zero_mask = ops.is_zero(spec, flat)
    xs = ops.cmov(zero_mask, ops.one_mont(spec, (n,), dev), flat)

    # tile into (R, L); pad with ones
    L = min(4096, 1 << max(0, (n - 1).bit_length()))
    R = -(-n // L)
    pad = R * L - n
    if pad:
        xs = torch.cat([xs, ops.one_mont(spec, (pad,), dev)], dim=-1)
    rows = xs.reshape(K, R, L).unbind(1)               # R rows of (K, L)

    # Phase 1: inclusive prefix products down the rows
    prefix = []
    carry = ops.one_mont(spec, (L,), dev)
    for row in rows:
        carry = mul(spec, carry, row)
        prefix.append(carry)
    colprod = carry                                     # (K, L)

    # Phase 2: inclusive products along the lanes, from either end (log-depth)
    def lane_scan(v, reverse: bool):
        acc = v
        d = 1
        while d < L:
            ones = ops.one_mont(spec, (d,), dev)
            if reverse:
                shifted = torch.cat([acc[:, d:], ones], dim=-1)
            else:
                shifted = torch.cat([ones, acc[:, :-d]], dim=-1)
            acc = mul(spec, acc, shifted)
            d *= 2
        return acc

    pre_incl = lane_scan(colprod, reverse=False)
    suf_incl = lane_scan(colprod, reverse=True)
    ginv = ops.pow_const(spec, pre_incl[:, -1:], spec.modulus - 2,
                         mul=mul, sqr=sqr)              # the one inversion

    # inv(colprod[l]) = ginv * pre_excl[l] * suf_excl[l]
    one_col = ops.one_mont(spec, (1,), dev)
    pre_excl = torch.cat([one_col, pre_incl[:, :-1]], dim=-1)
    suf_excl = torch.cat([suf_incl[:, 1:], one_col], dim=-1)
    iv = mul(spec, mul(spec, pre_excl, suf_excl), ginv)    # (K, L)

    # Phase 3: unwind the rows backward.
    # inv(x[r]) = inv(prefix[r]) * prefix[r-1]; iv walks up: iv *= x[r]
    inv_rows = [None] * R
    for r in range(R - 1, -1, -1):
        pprev = prefix[r - 1] if r else ops.one_mont(spec, (L,), dev)
        inv_rows[r] = mul(spec, iv, pprev)
        iv = mul(spec, iv, rows[r])
    invx = torch.stack(inv_rows, dim=1).reshape(K, R * L)[:, :n]

    out = ops.cmov(zero_mask, torch.zeros_like(invx), invx)
    return out.reshape(x.shape)
