"""Device-routed field ops: CUDA kernels for CUDA tensors, plain PyTorch for
CPU tensors.

Counterpart of the JAX package's ``fields/fast.py``.  The route is decided by
where the tensor lives and by nothing else: there is no switch that sends a
CUDA tensor to the plain version.  ``add`` and ``sub`` have no kernel of their
own yet (inside the fused group-law kernels they are device code), so they are
plain PyTorch on either device.

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
    return ops.add(spec, a, b)


def sub(spec: FieldSpec, a, b):
    return ops.sub(spec, a, b)


def from_mont(spec: FieldSpec, a):
    """Montgomery -> standard form via the multiply (a * 1 * R^-1)."""
    a = a.contiguous()
    one = torch.zeros_like(a)
    one[0] = 1
    return cuda_ops.mont_mul(spec, a, one)
