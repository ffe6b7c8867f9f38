"""Generic batched Jacobian group law for short-Weierstrass a=0 curves.

Counterpart of the JAX package's ``curves/points.py``, written once against the
field-adapter interface and instantiated for G1 (Fq) and G2 (Fq2), with the
same formulas and the same order of operations, so that with canonical field
results the coordinates equal the JAX package's limb for limb.

Representations (batched, limbs first, the adapter's layout):
* Jacobian point: ``(X, Y, Z)`` field elements; identity <=> Z == 0.
* Affine point: ``(x, y, inf)`` with ``inf`` a bool batch mask.

Completeness: the generic formula is computed unconditionally, then the
doubling result, the identity or a pass-through is selected for the edge
cases (``torch.where``, no branch on data), in the JAX package's order.

Routing.  ``jac_add_fast``, ``jac_add_affine_fast`` and ``jac_double_fast``
send G1 (``FQ_ADAPTER``) on CUDA tensors to the fused kernels of
``curves/cuda_g1.py`` (``jadd``, ``madd``, ``jdbl``); G2, other adapters and
CPU tensors take the generic formulas.  ``scalar_mul`` sends G1 on the card to
``cuda_g1.jac_ladder`` (``ladder_kernel``), the whole ladder in one launch;
elsewhere it steps through the routers, a doubling and a mixed add a bit.
``sum_reduce`` makes one ``jac_add_fast`` a round.  The kernels' limbs equal
the generic formulas' (the JAX package's Pallas kernels are bit-identical to
its generic path in the same way).
"""

from __future__ import annotations

import torch

from .. import constants
from ..fields.limbs import int_to_limbs
from ..fields.ops import LIMB_DTYPE
from .field_adapters import FQ_ADAPTER
from .projective import _laid_out as _laid_out_for


def jac_identity(F, batch_shape=(), device=None):
    """Canonical identity (1 : 1 : 0) in Montgomery form."""
    return (F.one(batch_shape, device), F.one(batch_shape, device),
            F.zero(batch_shape, device))


def jac_is_identity(F, P):
    return F.is_zero(P[2])


def jac_cmov(F, mask, P, Q):
    return tuple(F.cmov(mask, p, q) for p, q in zip(P, Q))


def jac_neg(F, P):
    return (P[0], F.neg(P[1]), P[2])


def affine_neg(F, A):
    return (A[0], F.neg(A[1]), A[2])


def affine_cmov(F, mask, A, B):
    return (F.cmov(mask, A[0], B[0]), F.cmov(mask, A[1], B[1]),
            torch.where(mask, A[2], B[2]))


def jac_double(F, P):
    """dbl-2009-l, a = 0.  Complete: Z=0 in -> Z3=0 out."""
    X, Y, Z = P
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.sub(F.sub(F.sqr(F.add(X, B)), A), C)
    D = F.double(D)
    E = F.add(F.double(A), A)  # 3A
    G = F.sqr(E)
    X3 = F.sub(G, F.double(D))
    C8 = F.double(F.double(F.double(C)))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.mul(F.double(Y), Z)
    return (X3, Y3, Z3)


def jac_add(F, P, Q):
    """add-2007-bl with constant-time edge-case selection.

    Handles: P or Q identity, P == Q (doubling), P == -Q (identity).
    """
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    H = F.sub(U2, U1)
    I = F.sqr(F.double(H))
    J = F.mul(H, I)
    r = F.double(F.sub(S2, S1))
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.double(V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.double(F.mul(S1, J)))
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    R = (X3, Y3, Z3)

    idP = jac_is_identity(F, P)
    idQ = jac_is_identity(F, Q)
    x_eq = F.is_zero(H) & ~idP & ~idQ
    y_eq = F.is_zero(F.sub(S2, S1))
    # same point -> doubling
    R = jac_cmov(F, x_eq & y_eq, jac_double(F, P), R)
    # inverse point -> identity
    batch = F.batch_shape(H)
    R = jac_cmov(F, x_eq & ~y_eq, jac_identity(F, batch, H.device), R)
    R = jac_cmov(F, idP, Q, R)
    R = jac_cmov(F, idQ, P, R)
    return R


def jac_add_affine(F, P, A):
    """Mixed addition madd-2007-bl (Z2 = 1) with edge-case selection.

    ``A = (x, y, inf)``; lanes where ``inf`` return P.
    """
    X1, Y1, Z1 = P
    x2, y2, inf2 = A
    Z1Z1 = F.sqr(Z1)
    U2 = F.mul(x2, Z1Z1)
    S2 = F.mul(F.mul(y2, Z1), Z1Z1)
    H = F.sub(U2, X1)
    HH = F.sqr(H)
    I = F.double(F.double(HH))
    J = F.mul(H, I)
    r = F.double(F.sub(S2, Y1))
    V = F.mul(X1, I)
    X3 = F.sub(F.sub(F.sqr(r), J), F.double(V))
    Y3 = F.sub(F.mul(r, F.sub(V, X3)), F.double(F.mul(Y1, J)))
    Z3 = F.sub(F.sub(F.sqr(F.add(Z1, H)), Z1Z1), HH)
    R = (X3, Y3, Z3)

    idP = jac_is_identity(F, P)
    x_eq = F.is_zero(H) & ~idP & ~inf2
    y_eq = F.is_zero(F.sub(S2, Y1))
    R = jac_cmov(F, x_eq & y_eq, jac_double(F, P), R)
    batch = F.batch_shape(H)
    R = jac_cmov(F, x_eq & ~y_eq, jac_identity(F, batch, H.device), R)
    promoted = (x2, y2, F.one(batch, H.device))
    R = jac_cmov(F, idP & ~inf2, promoted, R)
    R = jac_cmov(F, inf2, P, R)
    return R


# -----------------------------------------------------------------------------
# Kernel-routed entry points: G1 on CUDA tensors goes to the fused kernels of
# curves/cuda_g1.py; everything else takes the generic formulas above.
# -----------------------------------------------------------------------------


def _fused(F, t):
    """``cuda_g1`` where the fused Jacobian kernels serve adapter ``F`` for
    tensor ``t`` (G1 on the card), else None.  The JAX package fuses no
    Jacobian G2 kernel, so neither does the port."""
    if F is FQ_ADAPTER and t.is_cuda:
        from . import cuda_g1

        return cuda_g1
    return None


def _laid_out(coords, masks=()):
    """G1 operands broadcast to one batch and made contiguous, as the
    wrappers take them."""
    return _laid_out_for(coords, masks, FQ_ADAPTER)


def jac_add_fast(F, P, Q):
    """``jac_add``, routed to the fused ``jadd`` kernel for G1 on the card
    (Q broadcast to P's batch, as the JAX kernel's wrapper does)."""
    mod = _fused(F, P[0])
    if mod is None:
        return jac_add(F, P, Q)
    c, _ = _laid_out([*P, *Q])
    return mod.jadd(tuple(c[:3]), tuple(c[3:]))


def jac_add_affine_fast(F, P, A):
    """``jac_add_affine``, routed to the fused ``madd`` kernel for G1 on the
    card."""
    mod = _fused(F, P[0])
    if mod is None:
        return jac_add_affine(F, P, A)
    c, (inf2,) = _laid_out([*P, A[0], A[1]], [A[2]])
    return mod.madd(tuple(c[:3]), (c[3], c[4], inf2))


def jac_double_fast(F, P):
    """``jac_double``, routed to the fused ``jdbl`` kernel for G1 on the
    card."""
    mod = _fused(F, P[0])
    if mod is None:
        return jac_double(F, P)
    c, _ = _laid_out(list(P))
    return mod.jdbl(tuple(c))


def ladder_kernel(F, device):
    """The wrapper that runs a whole double-and-add ladder in one launch for
    adapter ``F`` on ``device`` (``cuda_g1.jac_ladder`` for G1 on the card),
    else None (a doubling and a mixed add a bit).  The JAX package fuses no
    G2 Jacobian kernel, so G2 has none."""
    if F is FQ_ADAPTER and torch.device(device).type == "cuda":
        from . import cuda_g1

        return cuda_g1.jac_ladder
    return None


def _ladder_scalars(k, batch):
    """(16, *kbatch) limbs as the ladder takes them: one contiguous (16, 1,
    ...) column where every lane has the same scalar (the batch axes all of
    size 1 or stride 0 once broadcast: is_in_subgroup's r), else contiguous
    (16, *batch) planes."""
    k = k.expand((k.shape[0],) + tuple(batch))
    if all(s == 0 for s, d in zip(k.stride()[1:], k.shape[1:]) if d != 1):
        return k[(slice(None),) + (slice(0, 1),) * len(batch)].contiguous()
    return k.contiguous()


def jac_to_affine(F, P):
    """Jacobian -> affine: (X/Z^2, Y/Z^3, inf = Z==0)."""
    X, Y, Z = P
    inf = F.is_zero(Z)
    # inv(0) would poison the lane: put 1 where the point is the identity
    batch = F.batch_shape(X)
    zi = F.inv(F.cmov(inf, F.one(batch, X.device), Z))
    zi2 = F.sqr(zi)
    x = F.mul(X, zi2)
    y = F.mul(Y, F.mul(zi2, zi))
    zero = F.zero(batch, X.device)
    return (F.cmov(inf, zero, x), F.cmov(inf, zero, y), inf)


def affine_to_jac(F, A):
    x, y, inf = A
    batch = F.batch_shape(x)
    one = F.one(batch, x.device)
    zero = F.zero(batch, x.device)
    return (
        F.cmov(inf, one, x),
        F.cmov(inf, one, y),
        F.cmov(inf, zero, one),
    )


def jac_eq(F, P, Q):
    """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3."""
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    ex = F.eq(F.mul(X1, Z2Z2), F.mul(X2, Z1Z1))
    ey = F.eq(F.mul(F.mul(Y1, Z2), Z2Z2), F.mul(F.mul(Y2, Z1), Z1Z1))
    id1 = jac_is_identity(F, P)
    id2 = jac_is_identity(F, Q)
    return (id1 & id2) | (~id1 & ~id2 & ex & ey)


def is_on_curve_affine(F, A, b_mont):
    """y^2 == x^3 + b (identity counts as on-curve)."""
    x, y, inf = A
    lhs = F.sqr(y)
    rhs = F.add(F.mul(F.sqr(x), x), b_mont)
    return F.eq(lhs, rhs) | inf


def is_on_curve_jacobian(F, P, b_mont):
    """Y^2 == X^3 + b Z^6 (identity counts as on-curve)."""
    X, Y, Z = P
    lhs = F.sqr(Y)
    z2 = F.sqr(Z)
    z6 = F.mul(F.sqr(z2), z2)
    rhs = F.add(F.mul(F.sqr(X), X), F.mul(b_mont, z6))
    return F.eq(lhs, rhs) | jac_is_identity(F, P)


# -----------------------------------------------------------------------------
# Batched scalar multiplication and the checks built on it
# -----------------------------------------------------------------------------


def scalar_mul(F, scalars, A, num_bits=255):
    """Batched double-and-add: scalars[i] * A[i].

    ``scalars``: (16, *batch) 16-bit limbs, **standard form** (they broadcast
    against A's batch).  ``A``: affine batch.  Returns a Jacobian batch.
    Not constant-time on the card: G1 there runs the whole loop in one
    ``cuda_g1.jac_ladder`` launch, with the same limbs, which skips the add in
    a warp where no lane has the bit, so its time (not its values) depends on
    the scalars' bits.  It is meant for public scalars, as r in
    ``is_in_subgroup``.  Elsewhere (the CPU, G2) an MSB-first loop: per bit
    one doubling, one mixed add, and a per-lane select of the sum where the
    lane's bit is set (the JAX package's ``fori_loop`` body, here a Python
    loop over the bits), whose sequence of operations does not depend on the
    scalars.
    """
    x, y, inf = A
    scalars = scalars.to(device=x.device, dtype=LIMB_DTYPE)
    ladder = ladder_kernel(F, x.device)
    if ladder is not None:
        batch = torch.broadcast_shapes(x.shape[1:], y.shape[1:], inf.shape,
                                       scalars.shape[1:])
        lay = lambda t: t.expand((t.shape[0],) + batch).contiguous()
        return ladder(_ladder_scalars(scalars, batch),
                      (lay(x), lay(y), inf.expand(batch).contiguous()), num_bits)
    batch = F.batch_shape(x)
    acc = jac_identity(F, batch, x.device)
    for i in range(num_bits):
        bit_index = num_bits - 1 - i
        bit = ((scalars[bit_index // 16] >> (bit_index % 16)) & 1).bool()
        acc = jac_double_fast(F, acc)
        added = jac_add_affine_fast(F, acc, A)
        acc = jac_cmov(F, bit, added, acc)
    return acc


def is_in_subgroup(F, A, *, num_bits: int = 255):
    """Batched r-torsion membership: [r]P == O (with P on the curve).

    One 255-bit ladder per batch by ``scalar_mul`` with the public scalar r
    (G1 on the card: one ``jac_ladder`` launch that reads r from one column
    and skips the adds of r's zero bits, so its time depends on r's bits and
    on nothing secret); the identity counts as a member.  Returns a bool
    batch.
    """
    batch = F.batch_shape(A[0])
    r_limbs = torch.from_numpy(
        int_to_limbs(constants.FR_MODULUS, 16).astype("int32")).to(A[0].device)
    scalars = r_limbs.reshape((16,) + (1,) * len(batch)).expand((16,) + batch)
    rP = scalar_mul(F, scalars, A, num_bits=num_bits)
    return jac_is_identity(F, rP) | A[2]


def sum_reduce(F, P):
    """Tree-sum a Jacobian batch along its last batch axis -> batch without it.

    log2(n) rounds of pairwise ``jac_add_fast`` (n padded to a power of two
    with identities).
    """
    X = P[0]
    n = X.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        batch = F.batch_shape(X)[:-1] + (m - n,)
        ident = jac_identity(F, batch, X.device)
        P = tuple(torch.cat([c, i], dim=-1) for c, i in zip(P, ident))
    while m > 1:
        half = m // 2
        left = tuple(c[..., :half] for c in P)
        right = tuple(c[..., half:m] for c in P)
        P = jac_add_fast(F, left, right)
        m = half
    return tuple(c[..., 0] for c in P)
