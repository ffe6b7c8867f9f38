"""The G1 Jacobian ladder kernel's lane body (``g1_jac_ladder_lane``),
compiled for the host from ``csrc/host_check.cpp``, against the plain
PyTorch versions (``cuda_g1.jac_ladder_plain`` and ``points.scalar_mul``) and
the big-int oracle, with per-lane scalars and with one column read at a lane
stride of 0.  A file of its own: a plain 255-bit ladder is thousands of tiny
tensor ops (some half a minute on one core), so these cases run beside
``tests/test_torch_csrc_host.py``, which holds the other kernels' lane bodies.
"""

import ctypes
import random

import numpy as np
import pytest
import torch

from tpu_bls12_381_torch import oracle
from tpu_bls12_381_torch.curves import cuda_g1, g1, points as pt
from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER as F1
from tpu_bls12_381_torch.fields import FQ, FR
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs

from torch_shared import host_check_library, ptr as _ptr

# One intra-op thread: the plain ladders are thousands of tiny tensor ops
# (see tests/test_torch_g2.py).
torch.set_num_threads(1)

N = 96
SZ = ctypes.c_size_t
R_FR = FR.modulus


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_check_library(tmp_path_factory)


def _g1_non_members(count):
    """Curve points outside the r-torsion: x = 5, 6, ... with x^3 + 4 a
    square (p = 3 mod 4)."""
    p, out, x = FQ.modulus, [], 5
    while len(out) < count:
        rhs = (x ** 3 + 4) % p
        y = pow(rhs, (p + 1) // 4, p)
        if y * y % p == rhs:
            out.append((x, y))
        x += 1
    return out


LADDER_KS = [0, 1, R_FR - 1, R_FR, R_FR + 2, (1 << 255) - 1]


@pytest.fixture(scope="module")
def ladder_case():
    """A on N lanes (multiples of G) with the ladder's edge lanes: lane 6 A's
    inf, lanes 7 and 8 non-members; per-lane scalars: lanes 0 to 5 k = 0, 1,
    r - 1, r, r + 2 (acc = A before the last add: the P == A doubling),
    2^255 - 1; lanes 7 and 8 r and r + 2; the others random below 2^255."""
    rng = random.Random(17)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, R_FR), G, oracle.FQ_OPS),
                                oracle.FQ_OPS) for _ in range(N)]
    pts[6] = None
    pts[7:9] = _g1_non_members(2)
    ks = LADDER_KS + [rng.randrange(1 << 255)] + [R_FR, R_FR + 2]
    ks += [rng.randrange(1 << 255) for _ in range(N - len(ks))]
    k = torch.from_numpy(ints_to_limbs(ks, 16).astype(np.int32)).contiguous()
    return {"A": g1.affine_from_ints(pts, device="cpu"), "pts": pts, "ks": ks, "k": k}


@pytest.mark.parametrize("num_bits", [1, 16, 255])
@pytest.mark.parametrize("mode", ["per lane", "one column"])
def test_jac_ladder(lib, ladder_case, mode, num_bits):
    """``g1_jac_ladder_lane`` (``scalar_mul`` in one launch: the accumulator in
    registers, the add only where a warp has the bit) against
    ``cuda_g1.jac_ladder_plain`` and the port's CPU ``points.scalar_mul``,
    limb for limb, with per-lane scalars (the edge lanes of ``ladder_case``)
    or one (16, 1) column read at a lane stride of 0 (r, as
    ``is_in_subgroup`` passes it); at 255 bits also against the oracle."""
    A = ladder_case["A"]
    if mode == "per lane":
        k, planes, stride, ks = ladder_case["k"], N, 1, ladder_case["ks"]
    else:
        k = torch.from_numpy(ints_to_limbs([R_FR], 16).astype(np.int32)).contiguous()
        planes, stride, ks = 1, 0, [R_FR] * N
    out = [torch.empty_like(A[0]) for _ in range(3)]
    lib.g1_jac_ladder(_ptr(k), SZ(planes), SZ(stride), *[_ptr(t) for t in A],
                      *[_ptr(t) for t in out], SZ(N), ctypes.c_int(num_bits))
    assert all(torch.equal(o, w) for o, w in zip(out, cuda_g1.jac_ladder_plain(k, A, num_bits)))
    assert all(torch.equal(o, w) for o, w in zip(out, pt.scalar_mul(F1, k, A, num_bits)))
    got = g1.jacobian_to_ints(tuple(out))
    low = [kk % (1 << num_bits) for kk in ks]
    for i in (0, 1, 2, 3, 4, 5, 6, 9, N - 1):
        want = oracle.scalar_mul(low[i], ladder_case["pts"][i], oracle.FQ_OPS)
        assert got[i] == oracle.jac_to_affine(want, oracle.FQ_OPS)
    if num_bits == 255:
        # r kills members and the identity, not the non-members
        ident = [g is None for g in got]
        assert ident[6] and not ident[7]
        if mode == "one column":
            assert ident == [i not in (7, 8) for i in range(N)]
