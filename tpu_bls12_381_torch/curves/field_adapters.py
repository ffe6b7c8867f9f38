"""Field-ops adapters: one interface over Fq and Fq2 = Fq[u]/(u^2+1), which
the group law and the MSM pipeline are written against.

Counterpart of the JAX package's ``curves/field_adapters.py``.

Layouts.  An Fq batch is an ``int32`` tensor ``(24, *batch)``, limbs first.
An Fq2 batch is ONE ``int32`` tensor ``(24, 2, *batch)``: limbs first, then
the component (index 0 is c0, index 1 is c1 of c0 + c1 u), then the batch
axes.  (The JAX package holds a ``(c0, c1)`` tuple of two ``(24, *batch)``
arrays; ``convert.fq2_from_numpy`` / ``fq2_to_numpy`` map between the two.)
In both layouts the batch axes are the trailing ones, so everything the
pipeline does along them (rolls, concatenations, gathers ``c[..., idx]``,
selects by a mask of the batch shape) is the same line for both curves, and
an Fq2 batch is at the same time an Fq batch of batch shape ``(2, *batch)``:
the componentwise operations (add, sub, neg, double, cmov) are one call of
the Fq operation on the whole tensor.  ``elem_shape`` is the shape of the
leading element axes, ``(24,)`` or ``(24, 2)``.

Fq2 multiplication is Karatsuba (three Fq products, stacked into one call),
squaring is the complex squaring (a0+a1)(a0-a1), 2 a0 a1 (two products).
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
        self.elem_shape = (spec.num_limbs,)

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
        return fast.neg(self.spec, a)

    def double(self, a):
        return fast.double(self.spec, a)

    def inv(self, a):
        """Inverse (inv(0) = 0).  From 4096 elements on by Montgomery's trick
        (``vecops.batch_inverse``: one real inversion), below that by the
        Fermat ladder, as the JAX package's adapter does."""
        if a[0].numel() >= 4096:
            from .. import vecops

            return vecops.batch_inverse(self.spec, a)
        return fast.inv_mont(self.spec, a)

    # -- predicates / selection ----------------------------------------------
    def is_zero(self, a):
        return ops.is_zero(self.spec, a)

    def eq(self, a, b):
        return ops.eq(self.spec, a, b)

    def cmov(self, mask, a, b):
        """a where mask else b; the mask has the batch shape (it broadcasts
        against the trailing axes)."""
        return torch.where(mask, a, b)

    # -- constants -------------------------------------------------------------
    def zero(self, batch_shape=(), device=None):
        return ops.zeros(self.spec, batch_shape, device)

    def one(self, batch_shape=(), device=None):
        return ops.one_mont(self.spec, batch_shape, device)

    def batch_shape(self, a):
        return tuple(a.shape[len(self.elem_shape):])


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

    def neg(self, a):
        return ops.neg(self.spec, a)

    def double(self, a):
        return ops.add(self.spec, a, a)

    def inv(self, a):
        return ops.inv_mont(self.spec, a)


class Fq2Adapter:
    """Quadratic extension ops on ``(24, 2, *batch)`` tensors, over a base
    adapter (the device-routed one, or the plain one)."""

    # Karatsuba mul = 3 Fq muls; every coordinate is two limb planes.
    fq_muls_per_mul = 3
    limb_planes = 2

    def __init__(self, base: FqAdapter):
        self.base = base
        self.spec = base.spec
        self.elem_shape = (base.spec.num_limbs, 2)

    # componentwise: the Fq op on the whole tensor
    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def double(self, a):
        return self.base.double(a)

    def cmov(self, mask, a, b):
        return torch.where(mask, a, b)

    def mul(self, a, b):
        # Karatsuba: v0 = a0 b0, v1 = a1 b1
        # real = v0 - v1; imag = (a0+a1)(b0+b1) - v0 - v1
        F = self.base
        a, b = ops._bcast(a, b)
        a0, a1, b0, b1 = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
        v = F.mul(torch.stack([a0, a1, F.add(a0, a1)], dim=1),
                  torch.stack([b0, b1, F.add(b0, b1)], dim=1))
        v0, v1, s = v[:, 0], v[:, 1], v[:, 2]
        return torch.stack([F.sub(v0, v1), F.sub(F.sub(s, v0), v1)], dim=1)

    def sqr(self, a):
        # (a0 + a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
        F = self.base
        a0, a1 = a[:, 0], a[:, 1]
        v = F.mul(torch.stack([F.add(a0, a1), a0], dim=1),
                  torch.stack([F.sub(a0, a1), a1], dim=1))
        return torch.stack([v[:, 0], F.double(v[:, 1])], dim=1)

    def inv(self, a):
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        F = self.base
        sq = F.sqr(a)
        ninv = F.inv(F.add(sq[:, 0], sq[:, 1]))
        p = F.mul(a, ninv[:, None])
        return torch.stack([p[:, 0], F.neg(p[:, 1])], dim=1)

    def is_zero(self, a):
        return (a == 0).all(dim=0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0).all(dim=0)

    def zero(self, batch_shape=(), device=None):
        return self.base.zero((2,) + tuple(batch_shape), device)

    def one(self, batch_shape=(), device=None):
        return torch.stack([self.base.one(batch_shape, device),
                            self.base.zero(batch_shape, device)], dim=1)

    def batch_shape(self, a):
        return tuple(a.shape[2:])


FQ_ADAPTER = FqAdapter(FQ)
FQ_PLAIN = PlainFqAdapter(FQ)
FQ2_ADAPTER = Fq2Adapter(FQ_ADAPTER)
FQ2_PLAIN = Fq2Adapter(FQ_PLAIN)
