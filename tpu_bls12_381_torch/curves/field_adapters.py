"""Field-ops adapter: the interface the group law is written against.

Counterpart of the JAX package's ``curves/field_adapters.py``.  Only the base
field adapter exists so far; the Fq2 adapter comes with G2.  Fq elements are
``int32`` tensors ``(K, *batch)``.
"""

from __future__ import annotations

import torch

from ..fields import FQ, fast, ops


class FqAdapter:
    """Base-field ops over a FieldSpec (Montgomery domain)."""

    # Cost facts read by the MSM tuner (msm/pippenger.py): one Fq product
    # per multiply, one limb plane per coordinate.
    fq_muls_per_mul = 1
    limb_planes = 1

    def __init__(self, spec):
        self.spec = spec
        self.limb_shape = (spec.num_limbs,)

    # -- arithmetic (device-routed: CUDA kernels for CUDA tensors) -----------
    def add(self, a, b):
        return fast.add(self.spec, a, b)

    def sub(self, a, b):
        return fast.sub(self.spec, a, b)

    def mul(self, a, b):
        return fast.mont_mul(self.spec, a, b)

    def sqr(self, a):
        return fast.mont_sqr(self.spec, a)

    def neg(self, a):
        return ops.neg(self.spec, a)

    def double(self, a):
        return ops.add(self.spec, a, a)

    # -- predicates / selection ----------------------------------------------
    def is_zero(self, a):
        return ops.is_zero(self.spec, a)

    def eq(self, a, b):
        return ops.eq(self.spec, a, b)

    def cmov(self, mask, a, b):
        return torch.where(mask[None], a, b)

    # -- constants -------------------------------------------------------------
    def zero(self, batch_shape=(), device=None):
        return ops.zeros(self.spec, batch_shape, device)

    def one(self, batch_shape=(), device=None):
        return ops.one_mont(self.spec, batch_shape, device)

    def batch_shape(self, a):
        return tuple(a.shape[1:])


class PlainFqAdapter(FqAdapter):
    """The same interface with every op plain PyTorch, wherever the tensor
    lives: what the kernels' plain versions are written against."""

    def add(self, a, b):
        return ops.add(self.spec, a, b)

    def sub(self, a, b):
        return ops.sub(self.spec, a, b)

    def mul(self, a, b):
        return ops.mont_mul(self.spec, a, b)

    def sqr(self, a):
        return ops.mont_sqr(self.spec, a)


FQ_ADAPTER = FqAdapter(FQ)
FQ_PLAIN = PlainFqAdapter(FQ)
