"""Complete homogeneous-projective group law (Renes-Costello-Batina 2016)
for short-Weierstrass a=0 curves: G1 over Fq and G2 over Fq2, by adapter.

Counterpart of the JAX package's ``curves/projective.py``: the same formulas,
so with canonical field results the coordinates equal the JAX package's limb
for limb.  Independent field operations of one formula are stacked into one
batched call (the plain ops cost per call, not per lane, at small sizes).
Homogeneous coordinates (X : Y : Z), x = X/Z, y = Y/Z, identity (0 : 1 : 0).
The formulas are exception-free on a group of odd order, which |E(Fq)| and
|E'(Fq2)| both are, so one straight-line formula serves every input pair,
doublings and identities included.

Costs (M = field mul, S = square): add (alg 7) 12M, mixed add (alg 8) 11M,
double (alg 9) 6M + 2S; the multiplications by 3b are addition chains: G1 has
b = 4, so 3b = 12; G2 has b' = 4(1+u), so 3b' = 12(1+u), which maps
(c0, c1) to (12(c0 - c1), 12(c0 + c1)).

A projective point is an ``(X, Y, Z)`` tuple of field-element tensors in the
adapter's layout (``(24, *batch)`` for Fq, ``(24, 2, *batch)`` for Fq2, see
``curves/field_adapters.py``); an affine batch is ``(x, y, inf)`` with a bool
``inf`` of the batch shape.

The plain functions here are also the plain versions of the fused CUDA
kernels in ``curves/cuda_g1.py`` and ``curves/cuda_g2.py``; the ``*_fast``
routers send CUDA tensors to those kernels and CPU tensors to the plain
functions.  The lane scans (``proj_lane_scan``) are the MSM tail's: the JAX
package's Hillis-Steele steps, except on the card, where one scan kernel
takes them (``proj_lane_scan_fast``, ``proj_lane_sum_fast``: ``padd_scan``
for G1, ``padd2_scan`` for G2).
"""

from __future__ import annotations

import torch

from .field_adapters import FQ2_ADAPTER, FQ_ADAPTER, Fq2Adapter


def _mul12(F, a):
    """12a = 4 * 3a via double/add chains."""
    t = F.add(F.double(a), a)  # 3a
    return F.double(F.double(t))


def mul_b3_g1(F, a):
    """3b = 12 for G1 (b = 4)."""
    return _mul12(F, a)


def mul_b3_g2(F2, a):
    """3b' = 12(1+u) for G2: (c0, c1) -> 12*(c0 - c1, c0 + c1)."""
    Fb = F2.base
    c0, c1 = a[:, 0], a[:, 1]
    return _mul12(Fb, torch.stack([Fb.sub(c0, c1), Fb.add(c0, c1)], dim=1))


def mul_b3_for(F):
    return mul_b3_g2 if isinstance(F, Fq2Adapter) else mul_b3_g1


# -----------------------------------------------------------------------------
# Point plumbing
# -----------------------------------------------------------------------------


def proj_identity(F, batch_shape=(), device=None):
    """(0 : 1 : 0)."""
    return (F.zero(batch_shape, device), F.one(batch_shape, device),
            F.zero(batch_shape, device))


def proj_is_identity(F, P):
    return F.is_zero(P[2])


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


def proj_to_affine(F, P):
    """(X : Y : Z) -> (X/Z, Y/Z, inf = Z==0)."""
    X, Y, Z = P
    inf = F.is_zero(Z)
    batch = F.batch_shape(X)
    zi = F.inv(F.cmov(inf, F.one(batch, X.device), Z))
    zero = F.zero(batch, X.device)
    return (
        F.cmov(inf, zero, F.mul(X, zi)),
        F.cmov(inf, zero, F.mul(Y, zi)),
        inf,
    )


def proj_to_jac(F, P):
    """(X : Y : Z) homog -> (XZ, YZ^2, Z) Jacobian (same affine point;
    identity Z=0 maps to Jacobian identity Z=0)."""
    X, Y, Z = P
    Z2 = F.sqr(Z)
    return (F.mul(X, Z), F.mul(Y, Z2), Z)


def jac_to_proj(F, P):
    """(X, Y, Z) Jacobian -> (XZ : Y : Z^3) homogeneous."""
    X, Y, Z = P
    Z3 = F.mul(F.sqr(Z), Z)
    J = (F.mul(X, Z), Y, Z3)
    # A Jacobian identity (Z=0) may carry any X and Y: make it (0 : 1 : 0).
    return proj_cmov(F, F.is_zero(Z),
                     proj_identity(F, F.batch_shape(X), X.device), J)


def proj_eq(F, P, Q):
    """Cross-multiplied projective equality."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    ex = F.eq(F.mul(X1, Z2), F.mul(X2, Z1))
    ey = F.eq(F.mul(Y1, Z2), F.mul(Y2, Z1))
    id1 = proj_is_identity(F, P)
    id2 = proj_is_identity(F, Q)
    return (id1 & id2) | (~id1 & ~id2 & ex & ey)


# -----------------------------------------------------------------------------
# RCB16 complete formulas (a = 0); algorithm numbers from the paper.
# -----------------------------------------------------------------------------


class _Stack:
    """Field elements stacked along a new first batch axis, so that the
    independent operations of one formula are one batched call.  The adapter
    says where that axis lies: after the element axes, (K, m, *batch) for Fq
    and (K, 2, m, *batch) for Fq2.  Results are canonical, so the limbs are
    the same as one call each would give."""

    def __init__(self, F):
        self.F = F
        self.dim = len(F.elem_shape)

    def __call__(self, *xs):
        shape = torch.broadcast_shapes(*[x.shape for x in xs])
        return torch.stack([x.expand(shape) for x in xs], dim=self.dim)

    def cat(self, *ss):
        return torch.cat(ss, dim=self.dim)

    def at(self, s, i: int):
        return s.select(self.dim, i)

    def rows(self, s, lo: int, hi: int | None = None):
        hi = s.shape[self.dim] if hi is None else hi
        return s.narrow(self.dim, lo, hi - lo)

    def triple_then_b3(self, s, first_only: int):
        """Row-wise 3a for the first ``first_only`` stacked rows and 3b*a for
        the rest."""
        F = self.F
        t = F.add(F.double(self.rows(s, 0, first_only)),
                  self.rows(s, 0, first_only))
        return t, mul_b3_for(F)(F, self.rows(s, first_only))


def proj_add(F, P, Q):
    """Complete addition, RCB16 algorithm 7 (a=0, 12M + 2 small)."""
    st = _Stack(F)
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    # X1+Y1, Y1+Z1, X1+Z1 and the same for Q
    sums = F.add(st(X1, Y1, X1, X2, Y2, X2), st(Y1, Z1, Z1, Y2, Z2, Z2))
    a, b = st.rows(sums, 0, 3), st.rows(sums, 3)
    prod = F.mul(st.cat(st(X1, Y1, Z1), a), st.cat(st(X2, Y2, Z2), b))
    t0, t1, t2 = st.at(prod, 0), st.at(prod, 1), st.at(prod, 2)
    # t3 = X1Y2 + X2Y1, t4 = Y1Z2 + Y2Z1, ty = X1Z2 + X2Z1
    cross = F.sub(st.rows(prod, 3), F.add(st(t0, t1, t0), st(t1, t2, t2)))
    t3, t4, ty = st.at(cross, 0), st.at(cross, 1), st.at(cross, 2)
    x3, b3 = st.triple_then_b3(st(t0, t2, ty), 1)
    X3 = st.at(x3, 0)                                # 3 X1X2
    t2, Y3 = st.at(b3, 0), st.at(b3, 1)              # 3b Z1Z2, 3b (X1Z2 + X2Z1)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    last = F.mul(st(t3, t4, t1, Y3, Z3, X3), st(t1, Y3, Z3, X3, t4, t3))
    X3_out = F.sub(st.at(last, 0), st.at(last, 1))
    yz = F.add(st(st.at(last, 2), st.at(last, 4)),
               st(st.at(last, 3), st.at(last, 5)))
    return (X3_out, st.at(yz, 0), st.at(yz, 1))


def proj_add_mixed(F, P, A):
    """Complete mixed addition, RCB16 algorithm 8 (Z2 = 1, 11M + 2 small).

    ``A = (x2, y2, inf2)``: the formula is complete for every on-curve
    (x2, y2); the affine encoding cannot represent the identity, so the
    ``inf2`` mask selects P through.
    """
    st = _Stack(F)
    X1, Y1, Z1 = P
    x2, y2, inf2 = A
    sums = F.add(st(X1, x2), st(Y1, y2))             # X1+Y1, x2+y2
    prod = F.mul(st(X1, Y1, st.at(sums, 0), x2, y2),
                 st(x2, y2, st.at(sums, 1), Z1, Z1))
    t0, t1 = st.at(prod, 0), st.at(prod, 1)
    t3 = F.sub(st.at(prod, 2), F.add(t0, t1))        # X1y2 + x2Y1
    t45 = F.add(st.rows(prod, 3), st(X1, Y1))        # x2 Z1 + X1, y2 Z1 + Y1
    t4, t5 = st.at(t45, 0), st.at(t45, 1)
    x3, b3 = st.triple_then_b3(st(t0, Z1, t4), 1)
    X3 = st.at(x3, 0)                                # 3 X1x2
    t2, Y3 = st.at(b3, 0), st.at(b3, 1)              # 3b Z1, 3b (x2Z1 + X1)
    Z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    last = F.mul(st(t3, t5, t1, Y3, Z3, X3), st(t1, Y3, Z3, X3, t5, t3))
    X3_out = F.sub(st.at(last, 0), st.at(last, 1))
    yz = F.add(st(st.at(last, 2), st.at(last, 4)),
               st(st.at(last, 3), st.at(last, 5)))
    R = (X3_out, st.at(yz, 0), st.at(yz, 1))
    return proj_cmov(F, inf2, P, R)


def proj_add_mixed_signed(F, P, A, sign):
    """``proj_add_mixed`` with A's y negated per lane where ``sign``."""
    x2, y2, inf2 = A
    return proj_add_mixed(F, P, (x2, F.cmov(sign, F.neg(y2), y2), inf2))


def proj_double(F, P):
    """Complete doubling, RCB16 algorithm 9 (a=0, 6M + 2S + 1 small)."""
    st = _Stack(F)
    X, Y, Z = P
    sq = F.sqr(st(Y, Z))
    t0 = st.at(sq, 0)
    yz_xy = F.mul(st(Y, X), st(Z, Y))
    t1, xy = st.at(yz_xy, 0), st.at(yz_xy, 1)
    Z3 = F.double(F.double(F.double(t0)))            # 8 Y^2
    t2 = mul_b3_for(F)(F, st.at(sq, 1))              # 3b Z^2
    Y3 = F.add(t0, t2)
    t2_3 = F.add(F.double(t2), t2)                   # 9b Z^2
    t0 = F.sub(t0, t2_3)
    prod = F.mul(st(t2, t1, t0, t0), st(Z3, Z3, Y3, xy))
    Y3 = F.add(st.at(prod, 2), st.at(prod, 0))
    X3 = F.double(st.at(prod, 3))
    return (X3, Y3, st.at(prod, 1))


def _lane_shift(F, P, d: int, toward_end: bool):
    """Shift a lane-batched point by d along the last axis, toward its end
    (slot l takes slot l - d) or its start, the vacated slots the identity
    (roll + mask)."""
    L = P[0].shape[-1]
    idx = torch.arange(L, device=P[0].device)
    ident = proj_identity(F, F.batch_shape(P[0]), P[0].device)
    rolled = tuple(torch.roll(c, d if toward_end else -d, dims=-1) for c in P)
    mask = idx >= d if toward_end else idx < (L - d)
    return proj_cmov(F, mask, rolled, ident)


def proj_lane_scan(F, P, *, reverse: bool = False, exclusive: bool = False):
    """Prefix (suffix: ``reverse``) point sums along the last axis, inclusive
    or exclusive, by Hillis-Steele steps: log2 L additions over all lanes.
    The JAX package's lane scans (its ``msm/pippenger.py``) in its order."""
    L = P[0].shape[-1]
    acc = P
    for i in range(max(L - 1, 1).bit_length() if L > 1 else 0):
        acc = proj_add_fast(F, acc, _lane_shift(F, acc, 1 << i, not reverse))
    return _lane_shift(F, acc, 1, not reverse) if exclusive else acc


def proj_scan_rows(F, x_rows, y_rows, sign_rows, inf_rows):
    """Row scan by R signed mixed adds from the identity: coordinates
    (R, *elem, *lanes), masks (R, *lanes); returns the R inclusive prefix
    rows, three tensors of the coordinates' shape."""
    acc = proj_identity(F, tuple(inf_rows.shape[1:]), x_rows.device)
    rows = []
    for r in range(x_rows.shape[0]):
        acc = proj_add_mixed_signed(
            F, acc, (x_rows[r], y_rows[r], inf_rows[r]), sign_rows[r])
        rows.append(acc)
    return tuple(torch.stack([row[c] for row in rows]) for c in range(3))


# -----------------------------------------------------------------------------
# Kernel-routed entry points: CUDA tensors go to the fused kernels of
# curves/cuda_g1.py (Fq) and curves/cuda_g2.py (Fq2), CPU tensors to the plain
# formulas above.
# -----------------------------------------------------------------------------


def _fused(F, t):
    """The kernel module that serves adapter ``F`` for tensor ``t``, or None
    where the plain formulas do (a CPU tensor, or another adapter)."""
    if not t.is_cuda:
        return None
    if F is FQ_ADAPTER:
        from . import cuda_g1

        return cuda_g1
    if F is FQ2_ADAPTER:
        from . import cuda_g2

        return cuda_g2
    return None


def _laid_out(coords, masks=(), F=FQ_ADAPTER):
    """Broadcast coordinates (*elem, *batch) and masks (*batch) to one batch
    shape, contiguous: what the kernel wrappers take (they copy nothing and
    raise on anything else)."""
    k = len(F.elem_shape)
    batch = torch.broadcast_shapes(*[t.shape[k:] for t in coords],
                                   *[m.shape for m in masks])
    shape = tuple(F.elem_shape) + tuple(batch)
    return ([t.expand(shape).contiguous() for t in coords],
            [m.expand(batch).contiguous() for m in masks])


def proj_add_fast(F, P, Q):
    mod = _fused(F, P[0])
    if mod is None:
        return proj_add(F, P, Q)
    c, _ = _laid_out([*P, *Q], F=F)
    return mod.padd(tuple(c[:3]), tuple(c[3:]))


def proj_add_mixed_fast(F, P, A):
    mod = _fused(F, P[0])
    if mod is None:
        return proj_add_mixed(F, P, A)
    c, (inf2,) = _laid_out([*P, A[0], A[1]], [A[2]], F)
    return mod.pmadd(tuple(c[:3]), (c[3], c[4], inf2))


def proj_add_mixed_signed_fast(F, P, A, sign):
    """proj_add_mixed with a per-lane conditional negation of A's y folded
    in (sign=True adds -A)."""
    mod = _fused(F, P[0])
    if mod is None:
        return proj_add_mixed_signed(F, P, A, sign)
    c, (inf2, sign) = _laid_out([*P, A[0], A[1]], [A[2], sign], F)
    return mod.pmadd_signed(tuple(c[:3]), (c[3], c[4], inf2), sign)


def proj_scan_rows_fast(F, x_rows, y_rows, sign_rows, inf_rows):
    """The MSM's row scan: per lane, R dependent signed mixed adds from the
    identity down the rows of a tile; returns the R inclusive prefix rows.
    One kernel launch on the card (``pmadd_signed_rows`` / ``pmadd2_rows``),
    R plain adds on the CPU or over another adapter."""
    mod = _fused(F, x_rows)
    if mod is None:
        return proj_scan_rows(F, x_rows, y_rows, sign_rows, inf_rows)
    return mod.pmadd_signed_rows(x_rows, y_rows, sign_rows.contiguous(),
                                 inf_rows.contiguous())


def lane_scan_kernel(F, device):
    """The lane-scan wrapper that serves adapter ``F`` on ``device``
    (``cuda_g1.padd_scan`` for G1, ``cuda_g2.padd2_scan`` for G2, on the
    card), else None (the Hillis-Steele steps).  The routers below and
    ``msm_geometry``'s launch plan both ask it."""
    if torch.device(device).type != "cuda":
        return None
    if F is FQ_ADAPTER:
        from . import cuda_g1

        return cuda_g1.padd_scan
    if F is FQ2_ADAPTER:
        from . import cuda_g2

        return cuda_g2.padd2_scan
    return None


def proj_lane_scan_fast(F, P, *, reverse: bool = False, exclusive: bool = False):
    """``proj_lane_scan`` by value: a G1 or G2 point tensor on the card goes
    to the scan kernel (``lane_scan_kernel``: some 2L additions in 3 launches,
    in another association, so other limbs), anything else to the
    Hillis-Steele steps in the JAX package's order."""
    scan = lane_scan_kernel(F, P[0].device)
    if scan is None:
        return proj_lane_scan(F, P, reverse=reverse, exclusive=exclusive)
    c, _ = _laid_out(list(P), F=F)
    return scan(tuple(c), reverse=reverse, exclusive=exclusive)


def proj_lane_sum_fast(F, P):
    """Point sum along the last axis: on the card the scan kernel's total (2
    launches), else slot 0 of the Hillis-Steele suffix scan."""
    scan = lane_scan_kernel(F, P[0].device)
    if scan is None:
        return tuple(c[..., 0] for c in proj_lane_scan(F, P, reverse=True))
    c, _ = _laid_out(list(P), F=F)
    return scan(tuple(c), total=True)


def proj_double_fast(F, P):
    mod = _fused(F, P[0])
    if mod is None:
        return proj_double(F, P)
    c, _ = _laid_out(list(P), F=F)
    return mod.pdbl(tuple(c))


def doubling_chain_kernel(F, device):
    """The wrapper that doubles a point many times in one launch for
    adapter ``F`` on ``device`` (with ``times``: ``cuda_g1.pdbl`` for G1,
    ``cuda_g2.pdbl2`` for G2, on the card), else None (a doubling at a
    time)."""
    if torch.device(device).type != "cuda":
        return None
    if F is FQ_ADAPTER:
        from . import cuda_g1

        return cuda_g1.pdbl
    if F is FQ2_ADAPTER:
        from . import cuda_g2

        return cuda_g2.pdbl2
    return None


def proj_double_n_fast(F, P, times: int):
    """2^times P: ``times`` doublings in a row.  A G1 or G2 point tensor on
    the card goes to ONE launch of the doubling chain (``cuda_g1.pdbl`` or
    ``cuda_g2.pdbl2`` with ``times``); anything else doubles ``times`` times
    (``proj_double`` on the CPU).  Limb for limb the JAX package's
    ``_double_n``: the same formula, step by step."""
    if times <= 0:
        return P
    chain = doubling_chain_kernel(F, P[0].device)
    if chain is not None:
        c, _ = _laid_out(list(P), F=F)
        return chain(tuple(c), times)
    for _ in range(times):
        P = proj_double_fast(F, P)
    return P
