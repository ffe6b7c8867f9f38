"""Complete homogeneous-projective group law (Renes-Costello-Batina 2016)
for short-Weierstrass a=0 curves, G1 only so far.

Counterpart of the JAX package's ``curves/projective.py``: the same formulas,
so with canonical field results the coordinates equal the JAX package's limb
for limb.  Independent field operations of one formula are stacked into one
batched call (the plain ops cost per call, not per lane, at small sizes).  Homogeneous coordinates (X : Y : Z),
x = X/Z, y = Y/Z, identity (0 : 1 : 0).  The formulas are exception-free on a
group of odd order, which |E(Fq)| is, so one straight-line formula serves
every input pair, doublings and identities included.

Costs (M = field mul, S = square): add (alg 7) 12M, mixed add (alg 8) 11M,
double (alg 9) 6M + 2S; the multiplications by 3b = 12 are addition chains.

A projective point is an ``(X, Y, Z)`` tuple of ``(24, *batch)`` int32
tensors; an affine batch is ``(x, y, inf)`` with a bool ``inf``.

The plain functions here are also the plain versions of the fused CUDA
kernels in ``curves/cuda_g1.py``; the ``*_fast`` routers send CUDA tensors to
those kernels and CPU tensors to the plain functions.
"""

from __future__ import annotations

import torch

from .field_adapters import FQ_ADAPTER


def _mul12(F, a):
    """12a = 4 * 3a via double/add chains (3b for G1's b = 4)."""
    t = F.add(F.double(a), a)  # 3a
    return F.double(F.double(t))


def mul_b3_g1(F, a):
    return _mul12(F, a)


# -----------------------------------------------------------------------------
# Point plumbing
# -----------------------------------------------------------------------------


def proj_identity(F, batch_shape=(), device=None):
    """(0 : 1 : 0)."""
    return (F.zero(batch_shape, device), F.one(batch_shape, device),
            F.zero(batch_shape, device))


def proj_cmov(F, mask, P, Q):
    return tuple(F.cmov(mask, p, q) for p, q in zip(P, Q))


def proj_neg(F, P):
    return (P[0], F.neg(P[1]), P[2])


def affine_to_proj(F, A):
    """(x, y, inf) -> (x : y : 1), identity -> (0 : 1 : 0)."""
    x, y, inf = A
    batch = F.batch_shape(x)
    one = F.one(batch, x.device)
    zero = F.zero(batch, x.device)
    return (
        F.cmov(inf, zero, x),
        F.cmov(inf, one, y),
        F.cmov(inf, zero, one),
    )


def proj_to_jac(F, P):
    """(X : Y : Z) homog -> (XZ, YZ^2, Z) Jacobian (same affine point;
    identity Z=0 maps to Jacobian identity Z=0)."""
    X, Y, Z = P
    Z2 = F.sqr(Z)
    return (F.mul(X, Z), F.mul(Y, Z2), Z)


# -----------------------------------------------------------------------------
# RCB16 complete formulas (a = 0); algorithm numbers from the paper.
# -----------------------------------------------------------------------------


def _stk(*xs):
    """Stack field elements along a new first batch axis: (K, m, *batch).

    The field ops are batched, so independent operations of one formula are
    served by one call on the stacked operands.  Results are canonical, so
    the limbs are the same as one call each would give.
    """
    shape = torch.broadcast_shapes(*[x.shape for x in xs])
    return torch.stack([x.expand(shape) for x in xs], dim=1)


def _triple_then_quadruple(F, s, first_only: int):
    """Row-wise 3a for the first ``first_only`` stacked rows and 12a (the
    3b = 12 chain: 3a doubled twice) for the rest."""
    t = F.add(F.double(s), s)                        # 3a
    q = F.double(F.double(t[:, first_only:]))        # 12a
    return t[:, :first_only], q


def proj_add(F, P, Q):
    """Complete addition, RCB16 algorithm 7 (a=0, 12M + 2 small)."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    # X1+Y1, Y1+Z1, X1+Z1 and the same for Q
    sums = F.add(_stk(X1, Y1, X1, X2, Y2, X2), _stk(Y1, Z1, Z1, Y2, Z2, Z2))
    a, b = sums[:, :3], sums[:, 3:]
    prod = F.mul(torch.cat([_stk(X1, Y1, Z1), a], dim=1),
                 torch.cat([_stk(X2, Y2, Z2), b], dim=1))
    t0, t1, t2 = prod[:, 0], prod[:, 1], prod[:, 2]
    # t3 = X1Y2 + X2Y1, t4 = Y1Z2 + Y2Z1, ty = X1Z2 + X2Z1
    cross = F.sub(prod[:, 3:], F.add(_stk(t0, t1, t0), _stk(t1, t2, t2)))
    t3, t4, ty = cross[:, 0], cross[:, 1], cross[:, 2]
    x3, b3 = _triple_then_quadruple(F, _stk(t0, t2, ty), 1)
    X3 = x3[:, 0]                                    # 3 X1X2
    t2, Y3 = b3[:, 0], b3[:, 1]                      # 3b Z1Z2, 3b (X1Z2 + X2Z1)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    last = F.mul(_stk(t3, t4, t1, Y3, Z3, X3), _stk(t1, Y3, Z3, X3, t4, t3))
    X3_out = F.sub(last[:, 0], last[:, 1])
    yz = F.add(_stk(last[:, 2], last[:, 4]), _stk(last[:, 3], last[:, 5]))
    return (X3_out, yz[:, 0], yz[:, 1])


def proj_add_mixed(F, P, A):
    """Complete mixed addition, RCB16 algorithm 8 (Z2 = 1, 11M + 2 small).

    ``A = (x2, y2, inf2)``: the formula is complete for every on-curve
    (x2, y2); the affine encoding cannot represent the identity, so the
    ``inf2`` mask selects P through.
    """
    X1, Y1, Z1 = P
    x2, y2, inf2 = A
    sums = F.add(_stk(X1, x2), _stk(Y1, y2))         # X1+Y1, x2+y2
    prod = F.mul(_stk(X1, Y1, sums[:, 0], x2, y2),
                 _stk(x2, y2, sums[:, 1], Z1, Z1))
    t0, t1 = prod[:, 0], prod[:, 1]
    t3 = F.sub(prod[:, 2], F.add(t0, t1))            # X1y2 + x2Y1
    t45 = F.add(prod[:, 3:], _stk(X1, Y1))           # x2 Z1 + X1, y2 Z1 + Y1
    t4, t5 = t45[:, 0], t45[:, 1]
    x3, b3 = _triple_then_quadruple(F, _stk(t0, Z1, t4), 1)
    X3 = x3[:, 0]                                    # 3 X1x2
    t2, Y3 = b3[:, 0], b3[:, 1]                      # 3b Z1, 3b (x2Z1 + X1)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    last = F.mul(_stk(t3, t5, t1, Y3, Z3, X3), _stk(t1, Y3, Z3, X3, t5, t3))
    X3_out = F.sub(last[:, 0], last[:, 1])
    yz = F.add(_stk(last[:, 2], last[:, 4]), _stk(last[:, 3], last[:, 5]))
    R = (X3_out, yz[:, 0], yz[:, 1])
    return proj_cmov(F, inf2, P, R)


def proj_add_mixed_signed(F, P, A, sign):
    """``proj_add_mixed`` with A's y negated per lane where ``sign``."""
    x2, y2, inf2 = A
    return proj_add_mixed(F, P, (x2, F.cmov(sign, F.neg(y2), y2), inf2))


def proj_double(F, P):
    """Complete doubling, RCB16 algorithm 9 (a=0, 6M + 2S + 1 small)."""
    X, Y, Z = P
    sq = F.sqr(_stk(Y, Z))
    t0 = sq[:, 0]
    yz_xy = F.mul(_stk(Y, X), _stk(Z, Y))
    t1, xy = yz_xy[:, 0], yz_xy[:, 1]
    Z3 = F.double(F.double(F.double(t0)))            # 8 Y^2
    t2 = mul_b3_g1(F, sq[:, 1])                      # 3b Z^2
    Y3 = F.add(t0, t2)
    t2_3 = F.add(F.double(t2), t2)                   # 9b Z^2
    t0 = F.sub(t0, t2_3)
    prod = F.mul(_stk(t2, t1, t0, t0), _stk(Z3, Z3, Y3, xy))
    Y3 = F.add(prod[:, 2], prod[:, 0])
    X3 = F.double(prod[:, 3])
    return (X3, Y3, prod[:, 1])


# -----------------------------------------------------------------------------
# Kernel-routed entry points: CUDA tensors go to the fused kernels of
# curves/cuda_g1.py, CPU tensors to the plain formulas above.
# -----------------------------------------------------------------------------


def _fq_fused(F, t) -> bool:
    return F is FQ_ADAPTER and t.is_cuda


def _laid_out(coords, masks=()):
    """Broadcast coordinates (K, *batch) and masks (*batch) to one batch
    shape, contiguous: what the kernel wrappers take (they copy nothing and
    raise on anything else)."""
    batch = torch.broadcast_shapes(*[t.shape[1:] for t in coords],
                                   *[m.shape for m in masks])
    K = coords[0].shape[0]
    return ([t.expand((K,) + batch).contiguous() for t in coords],
            [m.expand(batch).contiguous() for m in masks])


def proj_add_fast(F, P, Q):
    if _fq_fused(F, P[0]):
        from .cuda_g1 import padd

        c, _ = _laid_out([*P, *Q])
        return padd(tuple(c[:3]), tuple(c[3:]))
    return proj_add(F, P, Q)


def proj_add_mixed_fast(F, P, A):
    """Mixed add.  The kernel without the sign is not ported yet, so CUDA
    tensors go through the signed kernel with an all-false sign."""
    if _fq_fused(F, P[0]):
        return proj_add_mixed_signed_fast(F, P, A, torch.zeros_like(A[2]))
    return proj_add_mixed(F, P, A)


def proj_add_mixed_signed_fast(F, P, A, sign):
    """proj_add_mixed with a per-lane conditional negation of A's y folded
    in (sign=True adds -A)."""
    if _fq_fused(F, P[0]):
        from .cuda_g1 import pmadd_signed

        c, (inf2, sign) = _laid_out([*P, A[0], A[1]], [A[2], sign])
        return pmadd_signed(tuple(c[:3]), (c[3], c[4], inf2), sign)
    return proj_add_mixed_signed(F, P, A, sign)


def proj_double_fast(F, P):
    if _fq_fused(F, P[0]):
        from .cuda_g1 import pdbl

        c, _ = _laid_out(list(P))
        return pdbl(tuple(c))
    return proj_double(F, P)
