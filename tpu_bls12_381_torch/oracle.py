"""Host-side big-integer oracle for BLS12-381.

Pure-Python (arbitrary-precision int) implementations of every primitive
the device path provides: Fq/Fq2/Fr arithmetic, G1/G2 Jacobian group law,
naive double-and-add scalar multiplication, naive MSM, and a radix-2 NTT.

This plays the role the host libraries (BLST ``multi_exp`` and
``midnight_curves::fft::best_fft``) play in the reference
(``core/traits/cpu_impl.rs``, ``core/ntt.rs:1479-1661``): an independent
implementation used both as the small-size CPU fallback and as the
correctness oracle that the accelerated path is validated against.

Everything here is deliberately simple and obviously-correct; speed comes
from the device path (and the optional C++ host backend).
"""

from __future__ import annotations

from .constants import (
    FQ_MODULUS,
    FR_MODULUS,
    FR_OMEGA,
    FR_TWO_ADICITY,
    G1_GENERATOR_X,
    G1_GENERATOR_Y,
    G2_GENERATOR_X,
    G2_GENERATOR_Y,
)

Q = FQ_MODULUS
R = FR_MODULUS


# =============================================================================
# Fq2 = Fq[u] / (u^2 + 1); elements are (c0, c1) tuples of ints.
# =============================================================================

def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def fq2_sqr(a):
    return fq2_mul(a, a)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_inv(a):
    # (c0 - c1 u) / (c0^2 + c1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, Q - 2, Q)
    return (a[0] * ninv % Q, (-a[1]) * ninv % Q)


def fq2_is_zero(a):
    return a[0] == 0 and a[1] == 0


class _FqOps:
    """Plain Fq as a field-ops namespace matching the Fq2 one."""

    zero = 0
    one = 1

    @staticmethod
    def add(a, b):
        return (a + b) % Q

    @staticmethod
    def sub(a, b):
        return (a - b) % Q

    @staticmethod
    def mul(a, b):
        return a * b % Q

    @staticmethod
    def sqr(a):
        return a * a % Q

    @staticmethod
    def neg(a):
        return (-a) % Q

    @staticmethod
    def inv(a):
        return pow(a, Q - 2, Q)

    @staticmethod
    def is_zero(a):
        return a == 0

    @staticmethod
    def from_small(n):
        return n % Q


class _Fq2Ops:
    zero = (0, 0)
    one = (1, 0)

    add = staticmethod(fq2_add)
    sub = staticmethod(fq2_sub)
    mul = staticmethod(fq2_mul)
    sqr = staticmethod(fq2_sqr)
    neg = staticmethod(fq2_neg)
    inv = staticmethod(fq2_inv)
    is_zero = staticmethod(fq2_is_zero)

    @staticmethod
    def from_small(n):
        return (n % Q, 0)


FQ_OPS = _FqOps()
FQ2_OPS = _Fq2Ops()


# =============================================================================
# Generic short-Weierstrass (a=0) Jacobian group law over a field-ops object.
# Points: None = identity; affine = (x, y); jacobian = (X, Y, Z).
# =============================================================================

def jac_double(P, F):
    if P is None:
        return None
    X, Y, Z = P
    if F.is_zero(Y):
        return None
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    # D = 2*((X+B)^2 - A - C)
    D = F.sub(F.sub(F.sqr(F.add(X, B)), A), C)
    D = F.add(D, D)
    E = F.add(F.add(A, A), A)  # 3A (a = 0)
    Fv = F.sqr(E)
    X3 = F.sub(Fv, F.add(D, D))
    C8 = C
    for _ in range(3):
        C8 = F.add(C8, C8)
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), C8)
    Z3 = F.mul(F.add(Y, Y), Z)
    return (X3, Y3, Z3)


def jac_add(P, Qp, F):
    if P is None:
        return Qp
    if Qp is None:
        return P
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Qp
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        if S1 == S2:
            return jac_double(P, F)
        return None
    H = F.sub(U2, U1)
    I = F.sqr(F.add(H, H))
    J = F.mul(H, I)
    rr = F.sub(S2, S1)
    rr = F.add(rr, rr)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.add(V, V))
    S1J = F.mul(S1, J)
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.add(S1J, S1J))
    # Z3 = ((Z1+Z2)^2 - Z1Z1 - Z2Z2) * H
    Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def jac_add_affine(P, A, F):
    """Mixed addition P (jacobian) + A (affine, not identity)."""
    if A is None:
        return P
    if P is None:
        return (A[0], A[1], F.one)
    return jac_add(P, (A[0], A[1], F.one), F)


def jac_neg(P, F):
    if P is None:
        return None
    return (P[0], F.neg(P[1]), P[2])


def jac_to_affine(P, F):
    if P is None or F.is_zero(P[2]):
        return None
    zinv = F.inv(P[2])
    zinv2 = F.sqr(zinv)
    x = F.mul(P[0], zinv2)
    y = F.mul(P[1], F.mul(zinv2, zinv))
    return (x, y)


def affine_to_jac(A, F):
    if A is None:
        return None
    return (A[0], A[1], F.one)


def scalar_mul(k, A, F):
    """Double-and-add k * A (A affine or None). Returns jacobian or None."""
    k %= R
    if k == 0 or A is None:
        return None
    acc = None
    for bit in bin(k)[2:]:
        acc = jac_double(acc, F)
        if bit == "1":
            acc = jac_add_affine(acc, A, F)
    return acc


def msm(scalars, bases, F):
    """Naive MSM: sum_i scalars[i] * bases[i]. Bases affine, returns jacobian."""
    acc = None
    for k, P in zip(scalars, bases):
        acc = jac_add(acc, scalar_mul(k, P, F), F)
    return acc


# Convenience G1/G2 entry points --------------------------------------------

def g1_generator():
    return (G1_GENERATOR_X, G1_GENERATOR_Y)


def g2_generator():
    return (G2_GENERATOR_X, G2_GENERATOR_Y)


def g1_msm(scalars, bases):
    return msm(scalars, bases, FQ_OPS)


def g2_msm(scalars, bases):
    return msm(scalars, bases, FQ2_OPS)


def g1_is_on_curve(A):
    if A is None:
        return True
    x, y = A
    return (y * y - (x * x * x + 4)) % Q == 0


def g2_is_on_curve(A):
    if A is None:
        return True
    x, y = A
    return fq2_sub(fq2_sqr(y), fq2_add(fq2_mul(fq2_sqr(x), x), (4, 4))) == (0, 0)


# =============================================================================
# Scalar-field NTT oracle (radix-2 Cooley-Tukey, natural order in/out).
# =============================================================================

def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root: FR_OMEGA squared down from 2-adicity 32.

    Mirrors the derivation the reference uses (``core/ntt.rs:1488-1494``):
    omega_k = ROOT_OF_UNITY ^ (2^(32-k)).
    """
    if log_n > FR_TWO_ADICITY:
        raise ValueError(f"log_n {log_n} exceeds 2-adicity {FR_TWO_ADICITY}")
    w = FR_OMEGA
    for _ in range(FR_TWO_ADICITY - log_n):
        w = w * w % R
    return w


def ntt(values, inverse: bool = False):
    """Radix-2 DIT NTT over Fr, natural order input and output."""
    n = len(values)
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("size must be a power of two")
    a = [v % R for v in values]
    # bit-reverse permutation
    for i in range(n):
        j = int(format(i, f"0{log_n}b")[::-1], 2) if log_n else 0
        if j > i:
            a[i], a[j] = a[j], a[i]
    w_n = root_of_unity(log_n)
    if inverse:
        w_n = pow(w_n, R - 2, R)
    m = 1
    while m < n:
        w_m = pow(w_n, n // (2 * m), R)
        for k in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                t = w * a[k + j + m] % R
                u = a[k + j]
                a[k + j] = (u + t) % R
                a[k + j + m] = (u - t) % R
                w = w * w_m % R
        m *= 2
    if inverse:
        n_inv = pow(n, R - 2, R)
        a = [v * n_inv % R for v in a]
    return a


def coset_ntt(values, shift: int, inverse: bool = False):
    """Coset NTT: evaluate at shift * omega^i (forward) / interpolate (inverse)."""
    if not inverse:
        n = len(values)
        s = 1
        scaled = []
        for v in values:
            scaled.append(v * s % R)
            s = s * shift % R
        return ntt(scaled, inverse=False)
    a = ntt(values, inverse=True)
    sinv = pow(shift, R - 2, R)
    s = 1
    out = []
    for v in a:
        out.append(v * s % R)
        s = s * sinv % R
    return out
