"""GLV endomorphism for G1: phi(x, y) = (beta*x, y) with phi(P) = lambda*P.

Counterpart of the JAX package's ``curves/glv.py``: the endomorphism, the
scalar decomposition k = k1 + k2*lambda with both halves below 2^128, and
``scalar_mul_glv``, the batched k*P by a joint double-and-add over the two
halves (on the card one ``cuda_g1.glv_ladder`` launch, elsewhere the loop of
``_glv_steps``).

Constants are derived, not transcribed: beta is the cube root of unity in Fq
for which phi(P) = lambda*P holds (lambda = z^2 - 1 for the BLS parameter z),
checked against the host oracle when it is first used.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .. import constants
from ..fields import FQ, FR, ops
from ..fields.limbs import LIMB_BITS, LIMB_MASK, int_to_limbs
from . import projective as pj
from .field_adapters import FQ_ADAPTER

P_MOD = constants.FQ_MODULUS
R_MOD = constants.FR_MODULUS

BLS_Z = -0xD201000000010000
GLV_LAMBDA = (BLS_Z * BLS_Z - 1) % R_MOD
assert (GLV_LAMBDA * GLV_LAMBDA + GLV_LAMBDA + 1) % R_MOD == 0

# Both halves are < 2^128 (see decompose).
GLV_HALF_BITS = 128

# Barrett reciprocal for division by lambda: floor(2^384 / lambda).
# Because lambda ~ 2^128 ~ sqrt(r), plain integer division k = k2*lambda
# + k1 IS the GLV split (k1 = k mod lambda < 2^128, k2 = k//lambda <
# 2^128): exact over the integers, no mod-r lattice rounding needed.
GLV_BARRETT_SHIFT = 384
GLV_BARRETT_M = (1 << GLV_BARRETT_SHIFT) // GLV_LAMBDA


def _derive_beta() -> int:
    """The cube root of unity in Fq matching the eigenvalue lambda.

    Roots of t^2 + t + 1 mod p are (-1 +- sqrt(-3))/2; the one for which
    (beta*x_G, y_G) == lambda*G is the eigenvalue-consistent choice.
    """
    from .. import oracle

    s = pow(P_MOD - 3, (P_MOD + 1) // 4, P_MOD)  # p = 3 mod 4
    assert (s * s) % P_MOD == P_MOD - 3
    inv2 = pow(2, P_MOD - 2, P_MOD)
    candidates = [((P_MOD - 1 + s) * inv2) % P_MOD,
                  ((P_MOD - 1 - s) * inv2) % P_MOD]
    gx, gy = constants.G1_GENERATOR_X, constants.G1_GENERATOR_Y
    lam_g = oracle.jac_to_affine(
        oracle.scalar_mul(GLV_LAMBDA, (gx, gy), oracle.FQ_OPS), oracle.FQ_OPS)
    for b in candidates:
        assert pow(b, 3, P_MOD) == 1 and b != 1
        if ((b * gx) % P_MOD, gy) == lam_g:
            return b
    raise AssertionError("no eigenvalue-consistent cube root found")


_BETA: int | None = None


def beta() -> int:
    global _BETA
    if _BETA is None:
        _BETA = _derive_beta()
    return _BETA


def endomorphism(F, A):
    """phi(x, y) = (beta*x, y) on an affine batch (Montgomery form); beta is
    one (24, 1) column, which the product kernel holds in registers."""
    x, y, inf = A
    bm = ops.constant_column(FQ, int_to_limbs(FQ.to_mont(beta()), FQ.num_limbs),
                             x.device)
    return (F.mul(x, bm.reshape((FQ.num_limbs,) + (1,) * (x.dim() - 1))), y, inf)


# -----------------------------------------------------------------------------
# Limb helpers: plain (non-Montgomery) big-int ops on (K, ...) limb tensors,
# computed in int64.
# -----------------------------------------------------------------------------


def _limb_mul(a, b, Ka: int, Kb: int):
    """Schoolbook product of 16-bit-limb tensors -> (Ka+Kb) limb tensor.

    A column sums at most min(Ka, Kb) <= 24 products below 2^32, so it stays
    below 2^37 in int64 and needs no low/high split before the carry pass.
    """
    a = a.to(torch.int64)
    b = b.to(torch.int64)
    cols = torch.zeros((Ka + Kb,) + tuple(a.shape[1:]), dtype=torch.int64,
                       device=a.device)
    for i in range(Ka):
        cols[i:i + Kb] += a[i][None] * b[:Kb]
    out = torch.empty_like(cols)
    carry = torch.zeros_like(cols[0])
    for i in range(Ka + Kb):
        v = cols[i] + carry
        out[i] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return out


def _limb_sub(a, b):
    """a - b on equal-K limb tensors; returns (diff, borrow_flag)."""
    K = a.shape[0]
    d = a.to(torch.int64) - b.to(torch.int64)
    out = torch.empty_like(d)
    borrow = torch.zeros_like(d[0])
    for i in range(K):
        v = d[i] - borrow
        out[i] = v & LIMB_MASK
        borrow = (v >> LIMB_BITS) & 1
    return out, borrow.bool()


def _limb_inc_where(a, flag):
    """a + 1 on lanes where flag (carry-propagated)."""
    K = a.shape[0]
    a = a.to(torch.int64)
    out = torch.empty_like(a)
    carry = flag.to(torch.int64)
    for i in range(K):
        v = a[i] + carry
        out[i] = v & LIMB_MASK
        carry = v >> LIMB_BITS
    return out


@lru_cache(maxsize=None)
def _const_col_cached(value: int, k: int, device: torch.device):
    """The k limbs of ``value`` as one int64 (k,) tensor on ``device``, made
    once: a call after the first copies nothing from the host and waits for
    nothing, so a CUDA graph can capture it."""
    return torch.tensor([int(x) for x in int_to_limbs(value, k)],
                        dtype=torch.int64, device=device)


def _const_col(value: int, k: int, like):
    """``value``'s k limbs broadcast over the batch axes of ``like`` (a view
    of the cached column: read it, never write it)."""
    col = _const_col_cached(value, k, like.device)
    return col.reshape((k,) + (1,) * (like.dim() - 1)).expand(
        (k,) + tuple(like.shape[1:]))


def decompose(k_std):
    """Standard-form scalars (16, N) -> (k1, k2) with k = k1 + k2*lambda.

    Exact integer split by Barrett division (see GLV_BARRETT_M note):
    k2 = k // lambda (< 2^128), k1 = k mod lambda (< 2^128).  Branch-free
    limb arithmetic; the reciprocal estimate is corrected by at most two
    conditional (subtract-lambda, increment-k2) steps.  ``k1`` has 16 limbs;
    ``k2`` keeps only the limbs the shift leaves (9, the top one zero), as in
    the JAX package.
    """
    K = FR.num_limbs
    Km = (GLV_BARRETT_M.bit_length() + LIMB_BITS - 1) // LIMB_BITS - K
    m = _const_col(GLV_BARRETT_M, K + Km, k_std)
    prod = _limb_mul(k_std, m, K, K + Km)       # (2K+Km) limbs
    k2 = prod[GLV_BARRETT_SHIFT // LIMB_BITS:][:K]  # >> 384: the live limbs
    lam = _const_col(GLV_LAMBDA, K, k_std)
    k2l = _limb_mul(k2, lam, k2.shape[0], K)[:K]  # exact (true value < 2^255)
    rem, _ = _limb_sub(k_std, k2l)              # k - k2*lambda, in [0, 3*lam)
    for _ in range(2):                          # Barrett correction
        d, borrow = _limb_sub(rem, lam)
        take = ~borrow
        rem = torch.where(take[None], d, rem)
        k2 = _limb_inc_where(k2, take)
    return rem.to(ops.LIMB_DTYPE), k2.to(ops.LIMB_DTYPE)


# -----------------------------------------------------------------------------
# Batched GLV scalar multiplication
# -----------------------------------------------------------------------------


def glv_ladder_kernel(F, device):
    """The wrapper that runs ``scalar_mul_glv``'s whole joint ladder in one
    launch for adapter ``F`` on ``device`` (``cuda_g1.glv_ladder`` for G1 on
    the card), else None (the loop of ``_glv_steps``).  Monkeypatch it to
    drive the kernel route on the CPU, where the wrapper takes its plain
    version."""
    if F is FQ_ADAPTER and torch.device(device).type == "cuda":
        from . import cuda_g1

        return cuda_g1.glv_ladder
    return None


def _glv_steps(F, k1, k2, A, phiA, num_bits: int):
    """k1*A + k2*phiA by the joint double-and-add over adapter ``F``, MSB
    first, from the identity: per bit a doubling, the mixed add of A selected
    where the bit of ``k1`` is set, then that of ``phiA`` where the bit of
    ``k2`` is (a select on each lane's bit, every add computed: no branch on
    data).  ``k2`` keeps only its live limbs: a bit above them is 0.
    Returns the projective batch.

    Over ``FQ_ADAPTER`` on a CUDA tensor each step is one ``pdbl`` and two
    ``pmadd`` launches and the selects: the routed loop of elementwise
    kernels, the only caller of the mixed add without a sign.  Over
    ``FQ_PLAIN`` it is ``cuda_g1.glv_ladder_plain``."""
    acc = pj.proj_identity(F, F.batch_shape(A[0]), A[0].device)
    for bit_index in range(num_bits - 1, -1, -1):
        limb, shift = divmod(bit_index, LIMB_BITS)
        b1 = ((k1[limb] >> shift) & 1).bool()
        b2 = (((k2[limb] >> shift) & 1).bool() if limb < k2.shape[0]
              else torch.zeros_like(b1))
        acc = pj.proj_double_fast(F, acc)
        acc = pj.proj_cmov(F, b1, pj.proj_add_mixed_fast(F, acc, A), acc)
        acc = pj.proj_cmov(F, b2, pj.proj_add_mixed_fast(F, acc, phiA), acc)
    return acc


def scalar_mul_glv(scalars_std, A, num_bits: int = GLV_HALF_BITS):
    """Batched k*P over G1 via GLV: k1*P + k2*phi(P), joint double-and-add.

    ``scalars_std``: (16, N) int32 standard-form Fr limbs; ``A`` an affine G1
    batch.  ``num_bits`` doublings and 2*num_bits mixed adds, each taken or
    dropped per lane by a select on the scalar's bit: no branch on data.  On
    the card (``glv_ladder_kernel``) the whole loop is one ``glv_ladder``
    launch, so a call is the endomorphism's product, that launch and
    ``proj_to_jac``'s; elsewhere it is ``_glv_steps``.  Returns a Jacobian
    batch, limb for limb the JAX package's.
    """
    F = FQ_ADAPTER
    k1, k2 = decompose(scalars_std)
    phiA = endomorphism(F, A)
    ladder = glv_ladder_kernel(F, A[0].device)
    if ladder is None:
        return pj.proj_to_jac(F, _glv_steps(F, k1, k2, A, phiA, num_bits))
    # the wrapper copies nothing: broadcast to one batch, contiguous
    batch = torch.broadcast_shapes(
        *(t.shape[1:] for t in (k1, k2, A[0], A[1], phiA[0])), A[2].shape)
    lay = lambda t: t.expand((t.shape[0],) + batch).contiguous()
    acc = ladder(lay(k1), lay(k2), (lay(A[0]), lay(A[1]), A[2].expand(batch).contiguous()),
                 lay(phiA[0]), num_bits)
    return pj.proj_to_jac(F, acc)
