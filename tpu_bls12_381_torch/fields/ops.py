"""Batched Montgomery field arithmetic over 16-bit limbs (plain PyTorch).

Counterpart of the JAX package's ``fields/ops.py``, and the plain version of
the CUDA kernels in ``fields/cuda_ops.py``: the CPU tests run it, and on the
card the kernels are held against it bit for bit.

Tensor convention: a field-element batch is an ``int32`` tensor of shape
``(K, *batch)``: limbs-first, little-endian limb order, canonical (every
limb < 2^16, value < p).  ``int32`` is the one stored dtype of the port
(``LIMB_DTYPE``).  PyTorch has no arithmetic, shifts or ordering for
``uint32`` on the CPU, so the arithmetic here runs in ``int64``: a limb
product is < 2^32 and a column of up to 2K products plus carries stays below
2^39, far inside ``int64``, so carries are deferred without the low/high
split the JAX code needs in ``uint32``.

Results are canonical, so they equal the JAX package's limb for limb
whatever the order of the inner sums.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import resolve_device
from .field import FieldSpec
from .limbs import LIMB_BITS, LIMB_MASK, int_to_limbs

LIMB_DTYPE = torch.int32
_WORK = torch.int64
MASK = LIMB_MASK


@lru_cache(maxsize=None)
def _const_cached(limbs: tuple, device: torch.device, dtype):
    return torch.tensor(limbs, dtype=dtype, device=device)


def _const_limbs(arr, batch_ndim: int, device, dtype=_WORK):
    """(K,) constant -> (K, 1, 1, ...) tensor for broadcasting (cached)."""
    t = _const_cached(tuple(int(x) for x in arr), torch.device(device), dtype)
    return t.reshape(t.shape + (1,) * batch_ndim)


def zeros(spec: FieldSpec, batch_shape=(), device=None):
    return torch.zeros((spec.num_limbs,) + tuple(batch_shape),
                       dtype=LIMB_DTYPE, device=resolve_device(device))


def broadcast_constant(spec: FieldSpec, limbs: np.ndarray, batch_shape=(),
                       device=None):
    """Constant (K,) -> (K, *batch) tensor (materialised, contiguous)."""
    batch_shape = tuple(batch_shape)
    col = _const_limbs(limbs, len(batch_shape), resolve_device(device),
                       LIMB_DTYPE)
    return col.expand((spec.num_limbs,) + batch_shape).contiguous()


def constant_column(spec: FieldSpec, limbs: np.ndarray, device=None):
    """Constant (K,) -> one (K, 1) element, cached on its device (shared:
    read it, never write it).  ``cuda_ops.mont_mul`` reads such a factor once
    a thread instead of a plane."""
    return _const_limbs(limbs, 1, resolve_device(device), LIMB_DTYPE)


def one_mont(spec: FieldSpec, batch_shape=(), device=None):
    return broadcast_constant(spec, spec.one_mont_limbs, batch_shape, device)


# -----------------------------------------------------------------------------
# Limb-level helpers
# -----------------------------------------------------------------------------

def _wide(a):
    return a.to(_WORK)


def _bcast(a, b):
    """Broadcast two (K, *batch) tensors over their batch axes."""
    bshape = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    return a.expand(a.shape[:1] + bshape), b.expand(b.shape[:1] + bshape)


def _carry_chain(s, k: int):
    """Deferred column sums ``s`` (>= k rows) -> (k normalized rows, carry).

    The carry is signed: an arithmetic shift floors, so a negative column
    borrows from the next one and a negative final carry is a borrow out.
    Rows past ``k`` are not read.
    """
    cols = s.unbind(0)
    out = []
    v = cols[0]
    for i in range(k):
        out.append(v & MASK)
        carry = v >> LIMB_BITS
        if i + 1 < k:
            v = cols[i + 1] + carry
    return torch.stack(out), carry


def _reduce_once(spec: FieldSpec, s):
    """Column sums of a value in [0, 2p) -> canonical limbs in [0, p).

    ``s`` has K rows, or K+1 with the overflow column on top.  One carry
    chain runs over the value and over value + (2^(16K) - p) side by side:
    the second one carries out of limb K exactly when value >= p, and its
    low K limbs are then value - p.
    """
    K = spec.num_limbs
    comp = _const_limbs(int_to_limbs((1 << (LIMB_BITS * K)) - spec.modulus, K),
                        s.dim() - 1, s.device)
    both = torch.stack([s[:K], s[:K] + comp], dim=1)      # (K, 2, *batch)
    rows, carry = _carry_chain(both, K)
    top = carry[1]
    if s.shape[0] > K:
        top = top + s[K]
    return torch.where((top > 0)[None], rows[:, 1], rows[:, 0])


# -----------------------------------------------------------------------------
# Public ops
# -----------------------------------------------------------------------------

def add(spec: FieldSpec, a, b):
    """(a + b) mod p, canonical in/out."""
    a, b = _bcast(_wide(a), _wide(b))
    return _reduce_once(spec, a + b).to(LIMB_DTYPE)


def sub(spec: FieldSpec, a, b):
    """(a - b) mod p, canonical in/out."""
    K = spec.num_limbs
    a, b = _bcast(_wide(a), _wide(b))
    d = a - b
    n = _const_limbs(spec.modulus_limbs, d.dim() - 1, d.device)
    rows, borrow = _carry_chain(torch.stack([d, d + n], dim=1), K)
    return torch.where((borrow[0] < 0)[None], rows[:, 1],
                       rows[:, 0]).to(LIMB_DTYPE)


def neg(spec: FieldSpec, a):
    """(-a) mod p, canonical in/out: p - a, and 0 stays 0."""
    return sub(spec, torch.zeros_like(a), a)


def is_zero(spec: FieldSpec, a):
    """bool tensor over batch: a == 0."""
    return (a == 0).all(dim=0)


def eq(spec: FieldSpec, a, b):
    return (a == b).all(dim=0)


def cmov(mask, a, b):
    """Select a where mask else b; mask has batch shape."""
    return torch.where(mask[None], a, b)


def double(spec: FieldSpec, a):
    return add(spec, a, a)


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a*b*R^-1 mod p, R = 2^(16K), canonical in/out.

    Word-serial CIOS over the limb axis, as the JAX package's
    ``mont_mul_cios_impl``, with the product columns and the reduction
    columns both deferred in one (2K+1)-row accumulator: step i adds
    a_i * b at rows i..i+K-1, then m_i * p with m_i chosen so that row i
    becomes 0 mod 2^16, and pushes row i's carry into row i+1.
    """
    K = spec.num_limbs
    a, b = _bcast(_wide(a), _wide(b))
    n_col = _const_limbs(spec.modulus_limbs, a.dim() - 1, a.device)
    n0 = spec.n0_inv
    t = torch.zeros((2 * K + 1,) + a.shape[1:], dtype=_WORK, device=a.device)
    n_col = n_col.expand_as(b)
    for i in range(K):
        t[i:i + K].addcmul_(a[i], b)
    for i in range(K):
        m = (t[i] * n0) & MASK
        t[i:i + K].addcmul_(m, n_col)
        t[i + 1] += t[i] >> LIMB_BITS
    return _reduce_once(spec, t[K:]).to(LIMB_DTYPE)


def mont_sqr(spec: FieldSpec, a):
    """Montgomery square (the CIOS product a*a, as in the JAX package)."""
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a):
    """Standard -> Montgomery form: a * R^2 * R^-1 = a*R."""
    r2 = _const_limbs(spec.r2_limbs, a.dim() - 1, a.device, LIMB_DTYPE)
    return mont_mul(spec, a, r2)


def from_mont(spec: FieldSpec, a):
    """Montgomery -> standard form: a * 1 * R^-1."""
    one = torch.zeros_like(a)
    one[0] = 1
    return mont_mul(spec, a, one)


def pow_const(spec: FieldSpec, a, exponent: int, *, mul=None, sqr=None):
    """Montgomery-form a^exponent for a Python-int exponent >= 0.

    Square-and-multiply over the exponent's bits, most significant first, as
    the JAX package's loop does it: every step squares, and multiplies where
    the bit is set.  ``mul`` and ``sqr`` are the product and the square to
    use, ``mont_mul`` and ``mont_sqr`` of this module unless given
    (``fields/fast.py`` passes the device-routed ones).
    """
    mont_mul_, mont_sqr_ = mul or mont_mul, sqr or mont_sqr
    if exponent < 0:
        raise ValueError("pow_const: the exponent must not be negative")
    acc = one_mont(spec, a.shape[1:], a.device)
    if exponent == 0:
        return acc
    for bit in bin(exponent)[2:]:
        acc = mont_sqr_(spec, acc)
        if bit == "1":
            acc = mont_mul_(spec, acc, a)
    return acc


def inv_mont(spec: FieldSpec, a):
    """Montgomery-form inverse by Fermat, a^(p-2); inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)
