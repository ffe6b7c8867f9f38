"""Device-routed field ops: CUDA kernels for CUDA tensors, plain PyTorch for
CPU tensors.

Counterpart of the JAX package's ``fields/fast.py``.  The route is decided by
where the tensor lives and by nothing else: there is no switch that sends a
CUDA tensor to the plain version.

The kernel wrappers take contiguous operands of one shape and raise on
anything else; the functions here broadcast and lay out for them, so a caller
may pass views and operands that broadcast, as the JAX package's callers do.
An operand of the product, the add or the sub that is one element is passed
as a (K, 1) column, which the kernel reads once a thread: it is never laid
out as a plane.  The doubling and the negation are one-operand launches.
"""

from __future__ import annotations

import torch

from . import cuda_ops, ops
from .field import FieldSpec
from .limbs import int_to_limbs


def _one_element(c, other) -> bool:
    """``c`` is one element that broadcasts over ``other``: as many axes, all
    of its batch axes of size 1."""
    return c.dim() == other.dim() and all(d == 1 for d in c.shape[1:])


def _as_column(spec: FieldSpec, c):
    return c.reshape(spec.num_limbs, 1).contiguous()


def mont_mul(spec: FieldSpec, a, b):
    if _one_element(a, b) and not _one_element(b, a):
        a, b = b, a                                  # the product commutes
    if _one_element(b, a):
        return cuda_ops.mont_mul(spec, a.contiguous(), _as_column(spec, b))
    a, b = torch.broadcast_tensors(a, b)
    return cuda_ops.mont_mul(spec, a.contiguous(), b.contiguous())


def mont_sqr(spec: FieldSpec, a):
    return cuda_ops.mont_sqr(spec, a.contiguous())


def add(spec: FieldSpec, a, b):
    if _one_element(a, b) and not _one_element(b, a):
        a, b = b, a                                  # the sum commutes
    if _one_element(b, a):
        return cuda_ops.add(spec, a.contiguous(), _as_column(spec, b))
    a, b = torch.broadcast_tensors(a, b)
    return cuda_ops.add(spec, a.contiguous(), b.contiguous())


def sub(spec: FieldSpec, a, b):
    if _one_element(b, a) and not _one_element(a, b):
        return cuda_ops.sub(spec, a.contiguous(), _as_column(spec, b))
    if _one_element(a, b) and not _one_element(b, a):
        return cuda_ops.sub(spec, _as_column(spec, a), b.contiguous())
    a, b = torch.broadcast_tensors(a, b)
    return cuda_ops.sub(spec, a.contiguous(), b.contiguous())


def double(spec: FieldSpec, a):
    """a + a, one launch reading one plane on the card."""
    return cuda_ops.double(spec, a.contiguous())


def neg(spec: FieldSpec, a):
    """0 - a (0 for 0), one launch reading one plane on the card."""
    return cuda_ops.neg(spec, a.contiguous())


def butterfly(spec: FieldSpec, even, odd, w):
    """(even + w*odd, even - w*odd), one fused kernel on the card."""
    even, odd, w = torch.broadcast_tensors(even, odd, w)
    return cuda_ops.butterfly(spec, even.contiguous(), odd.contiguous(),
                              w.contiguous())


def inv_mont(spec: FieldSpec, a):
    """Montgomery-form inverse by Fermat, a^(p-2); inv(0) = 0: one
    ``field_inv`` launch on the card (the limbs equal the JAX package's
    ladder's, ``cuda_ops.field_inv`` says why)."""
    return cuda_ops.field_inv(spec, a.contiguous())


def from_mont(spec: FieldSpec, a):
    """Montgomery -> standard form via the multiply (a * 1 * R^-1), the 1 a
    (K, 1) column."""
    one = ops.constant_column(spec, int_to_limbs(1, spec.num_limbs), a.device)
    return cuda_ops.mont_mul(spec, a.contiguous(), one)
