"""Device-routed field ops: CUDA kernels for CUDA tensors, plain PyTorch for
CPU tensors.

Counterpart of the JAX package's ``fields/fast.py``.  The route is decided by
where the tensor lives and by nothing else: there is no switch that sends a
CUDA tensor to the plain version.

The kernel wrappers take contiguous operands of one shape and raise on
anything else; the functions here broadcast and lay out for them, so a caller
may pass views and operands that broadcast, as the JAX package's callers do.
"""

from __future__ import annotations

import torch

from . import cuda_ops, ops
from .field import FieldSpec


def mont_mul(spec: FieldSpec, a, b):
    a, b = torch.broadcast_tensors(a, b)
    return cuda_ops.mont_mul(spec, a.contiguous(), b.contiguous())


def mont_sqr(spec: FieldSpec, a):
    return cuda_ops.mont_sqr(spec, a.contiguous())


def add(spec: FieldSpec, a, b):
    a, b = torch.broadcast_tensors(a, b)
    return cuda_ops.add(spec, a.contiguous(), b.contiguous())


def sub(spec: FieldSpec, a, b):
    a, b = torch.broadcast_tensors(a, b)
    return cuda_ops.sub(spec, a.contiguous(), b.contiguous())


def butterfly(spec: FieldSpec, even, odd, w):
    """(even + w*odd, even - w*odd), one fused kernel on the card."""
    even, odd, w = torch.broadcast_tensors(even, odd, w)
    return cuda_ops.butterfly(spec, even.contiguous(), odd.contiguous(),
                              w.contiguous())


def inv_mont(spec: FieldSpec, a):
    """Montgomery-form inverse by Fermat, a^(p-2); inv(0) = 0."""
    return ops.pow_const(spec, a, spec.modulus - 2, mul=mont_mul, sqr=mont_sqr)


def from_mont(spec: FieldSpec, a):
    """Montgomery -> standard form via the multiply (a * 1 * R^-1)."""
    a = a.contiguous()
    one = torch.zeros_like(a)
    one[0] = 1
    return cuda_ops.mont_mul(spec, a, one)
