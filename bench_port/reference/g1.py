"""Plain G1 arithmetic of BLS12-381 on Python integers: the benchmark's frozen
copy, which imports nothing of the program under test.

The curve is y^2 = x^3 + 4 over the prime field of ``P``; its subgroup of
prime order ``R`` is generated by ``G``.  The constants are the published
ones (the IETF pairing-friendly-curves draft, section 4.2.1; zkcrypto's
``bls12_381`` crate).  Points are Jacobian triples (X, Y, Z) with Z = 0 for
the identity, or affine pairs (x, y) with None for the identity.
"""

from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
B = 4
G = (0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
     0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1)

# Montgomery radix of the base field as the program stores it: 24 limbs of 16 bits.
FQ_LIMBS = 24
FQ_MONT = 1 << (16 * FQ_LIMBS)
IDENTITY = (1, 1, 0)


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def double(p1):
    X, Y, Z = p1
    if Z == 0 or Y == 0:
        return IDENTITY
    A = X * X % P
    Bq = Y * Y % P
    C = Bq * Bq % P
    D = 2 * ((X + Bq) * (X + Bq) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return X3, Y3, Z3


def add(p1, p2):
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    if Z1 == 0:
        return p2
    if Z2 == 0:
        return p1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        return double(p1) if S1 == S2 else IDENTITY
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    r = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (r * r - J - 2 * V) % P
    Y3 = (r * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return X3, Y3, Z3


def from_affine(pt):
    return IDENTITY if pt is None else (pt[0], pt[1], 1)


def to_affine(p1):
    X, Y, Z = p1
    if Z == 0:
        return None
    zi = pow(Z, P - 2, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def to_affine_many(points):
    """Affine forms of Jacobian points, with one inversion for all of them."""
    zs = [p[2] for p in points if p[2]]
    prefix, acc = [], 1
    for z in zs:
        prefix.append(acc)
        acc = acc * z % P
    inv = pow(acc, P - 2, P)
    invs = [0] * len(zs)
    for i in range(len(zs) - 1, -1, -1):
        invs[i] = inv * prefix[i] % P
        inv = inv * zs[i] % P
    out, it = [], iter(invs)
    for X, Y, Z in points:
        if Z == 0:
            out.append(None)
            continue
        zi = next(it)
        zi2 = zi * zi % P
        out.append((X * zi2 % P, Y * zi2 * zi % P))
    return out


def scalar_mul(k: int, pt=G):
    """k * pt for an affine ``pt`` (Jacobian result), double-and-add."""
    k %= R
    acc = IDENTITY
    base = from_affine(pt)
    for bit in bin(k)[2:]:
        acc = double(acc)
        if bit == "1":
            acc = add(acc, base)
    return acc


def multiple(k: int, pt=G):
    """k * pt, affine."""
    return to_affine(scalar_mul(k, pt))
