"""Plain Fr arithmetic and NTTs in PyTorch: the benchmark's frozen copy, which
imports nothing of the program under test.

Elements are stored as the program stores them: 16 limbs of 16 bits,
little-endian, limbs first ``(16, *batch)``, in Montgomery form with
R = 2^256.  Here the limbs live in int64 tensors, so a sum of 32 limb products
cannot overflow, and every operation is a handful of whole-tensor torch ops:
slow, plain, and exact.  The NTT is the textbook radix-2 decimation in time
(bit-reversed input, natural output) over the domain whose root is
``OMEGA`` squared down, the root that zkcrypto's ``bls12_381`` crate and
the reference prover use; the coset is the multiplicative generator's.
"""

from __future__ import annotations

import torch

R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
OMEGA = 0x16A2A19EDFE81F20D09B681922C813B4B63683508C2280B93829971F439F0D2B
TWO_ADICITY = 32
GENERATOR = 7          # the multiplicative generator of Fr: the coset shift
LIMBS = 16
MASK = 0xFFFF
MONT = 1 << (16 * LIMBS)
N0 = (-pow(R, -1, 1 << 16)) % (1 << 16)


def to_mont(x: int) -> int:
    return x * MONT % R


def from_mont(x: int) -> int:
    return x * pow(MONT, -1, R) % R


def root_of_unity(log_n: int) -> int:
    if log_n > TWO_ADICITY:
        raise ValueError(f"no 2^{log_n}-th root of unity in Fr")
    return pow(OMEGA, 1 << (TWO_ADICITY - log_n), R)


def limbs_of(values, device=None) -> torch.Tensor:
    """Python ints -> (16, len) int64 limbs."""
    values = list(values)
    out = torch.empty((LIMBS, len(values)), dtype=torch.int64)
    for j, v in enumerate(values):
        out[:, j] = torch.tensor([(v >> (16 * i)) & MASK for i in range(LIMBS)])
    return out.to(device)


def ints_of(limbs: torch.Tensor) -> list[int]:
    """(16, n) limbs -> Python ints."""
    cols = limbs.reshape(limbs.shape[0], -1).to("cpu", torch.int64).T.tolist()
    return [sum(int(c) << (16 * i) for i, c in enumerate(col)) for col in cols]


def _r_limbs(like: torch.Tensor, count: int = LIMBS) -> torch.Tensor:
    r = torch.tensor([(R >> (16 * i)) & MASK for i in range(count)],
                     dtype=torch.int64, device=like.device)
    return r.reshape((count,) + (1,) * (like.dim() - 1))


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry every limb but the last into the next one, in place."""
    for i in range(t.shape[0] - 1):
        t[i + 1] += t[i] >> 16
        t[i] &= MASK
    return t


def _reduce_once(t: torch.Tensor) -> torch.Tensor:
    """(17, ...) normalised limbs of a value below 2R -> (16, ...) below R."""
    d = t.clone()
    d[:LIMBS] -= _r_limbs(t)
    for i in range(LIMBS):
        borrow = (d[i] < 0).to(torch.int64)
        d[i] += borrow << 16
        d[i + 1] -= borrow
    keep = (d[LIMBS] < 0).unsqueeze(0)
    return torch.where(keep, t[:LIMBS], d[:LIMBS])


def mont_mul(a: torch.Tensor, b: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """a * b * 2^-256 mod R for canonical (16, ...) limbs that broadcast.

    ``reduce=False`` leaves out the last conditional subtraction, so the
    result is only below 2R: the lazy form a faster program could be
    tempted to return (the control of ``check.py``).
    """
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    t = torch.zeros((2 * LIMBS + 1,) + a.shape[1:], dtype=torch.int64, device=a.device)
    for i in range(LIMBS):
        t[i:i + LIMBS] += a[i] * b
    r = _r_limbs(t)
    for i in range(LIMBS):
        m = ((t[i] & MASK) * N0) & MASK
        t[i:i + LIMBS] += m * r
        t[i + 1] += t[i] >> 16
    out = _normalize(t[LIMBS:].clone())
    if not reduce:
        return out[:LIMBS]
    return _reduce_once(out)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    t = torch.zeros((LIMBS + 1,) + a.shape[1:], dtype=torch.int64, device=a.device)
    t[:LIMBS] = a + b
    return _reduce_once(_normalize(t))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod R: a + (R - b), with R - 0 taken as 0 by the reduction."""
    return add(a, _negate(b))


def _negate(b: torch.Tensor) -> torch.Tensor:
    b = b.to(torch.int64)
    t = torch.zeros((LIMBS + 1,) + b.shape[1:], dtype=torch.int64, device=b.device)
    t[:LIMBS] = _r_limbs(b) - b
    for i in range(LIMBS):
        borrow = (t[i] < 0).to(torch.int64)
        t[i] += borrow << 16
        t[i + 1] -= borrow
    zero = (b == 0).all(dim=0, keepdim=True)
    return torch.where(zero, torch.zeros_like(b), t[:LIMBS])


def powers(base: int, count: int, device=None) -> torch.Tensor:
    """[base^0 .. base^(count-1)] in Montgomery form, (16, count): two host
    tables of about sqrt(count) powers and one product of their outer grid."""
    lo_n = 1
    while lo_n * lo_n < count:
        lo_n *= 2
    hi_n = -(-count // lo_n)
    lo, hi, acc = [], [], 1
    for _ in range(lo_n):
        lo.append(to_mont(acc))
        acc = acc * base % R
    step, acc = acc, 1
    for _ in range(hi_n):
        hi.append(to_mont(acc))
        acc = acc * step % R
    lo_t = limbs_of(lo, device)
    hi_t = limbs_of(hi, device)
    grid = mont_mul(hi_t[:, :, None], lo_t[:, None, :])
    return grid.reshape(LIMBS, -1)[:, :count].contiguous()


def bit_reverse(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    idx = torch.arange(n, device=x.device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return x.index_select(-1, rev)


def _ladder(x: torch.Tensor, root: int) -> torch.Tensor:
    """Radix-2 DIT transform along the last axis: sum_j x_j root^(jk)."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    x = bit_reverse(x.to(torch.int64))
    if n == 1:
        return x
    table = powers(root, n // 2, x.device)
    batch = x.shape[1:-1]
    for s in range(1, log_n + 1):
        h = 1 << (s - 1)
        tw = table[:, ::n // (2 * h)][:, :h]
        blocks = x.reshape((LIMBS,) + batch + (n // (2 * h), 2, h))
        u = blocks[..., 0, :]
        v = mont_mul(blocks[..., 1, :], tw.reshape((LIMBS,) + (1,) * (len(batch) + 1) + (h,)))
        x = torch.stack((add(u, v), sub(u, v)), dim=-2).reshape(x.shape)
    return x


def _scale_row(x: torch.Tensor, row: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    return mont_mul(x, row.reshape((LIMBS,) + (1,) * (x.dim() - 2) + (x.shape[-1],)),
                    reduce=reduce)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT, natural order in and out: y_k = sum_j x_j w^(jk)."""
    return _ladder(x, root_of_unity(x.shape[-1].bit_length() - 1))


def intt(x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    y = _ladder(x, pow(root_of_unity(log_n), R - 2, R))
    n_inv = limbs_of([to_mont(pow(n, R - 2, R))], x.device)
    return mont_mul(y, n_inv.reshape((LIMBS,) + (1,) * (y.dim() - 1)), reduce=reduce)


def coset_ntt(x: torch.Tensor, shift: int = GENERATOR) -> torch.Tensor:
    """Evaluations on shift * <w>: the forward NTT of x_j shift^j."""
    return ntt(_scale_row(x, powers(shift, x.shape[-1], x.device)))


def coset_intt(x: torch.Tensor, shift: int = GENERATOR, reduce: bool = True) -> torch.Tensor:
    """Coefficients from evaluations on shift * <w>: the inverse NTT, then
    the j-th coefficient divided by shift^j."""
    inv = pow(shift, R - 2, R)
    return _scale_row(intt(x), powers(inv, x.shape[-1], x.device), reduce=reduce)


def vanishing_inverse(log_n: int, log_ext: int, shift: int = GENERATOR) -> list[int]:
    """1 / Z_H at the points shift * w_ext^i of the extended coset, where
    Z_H(X) = X^(2^log_n) - 1: the 2^(log_ext - log_n) values that repeat
    along the coset, in Montgomery form."""
    n = 1 << log_n
    k = 1 << (log_ext - log_n)
    w_k = root_of_unity(log_ext - log_n)
    base = pow(shift, n, R)
    return [to_mont(pow((base * pow(w_k, m, R) - 1) % R, R - 2, R)) for m in range(k)]
