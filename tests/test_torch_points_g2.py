"""G2's 255-bit ladders of the PyTorch/CUDA port (``curves/points.py``:
``scalar_mul`` and ``is_in_subgroup`` over ``FQ2_ADAPTER``) against the JAX
package and the big-int oracle, on the CPU.

A file of its own beside ``tests/test_torch_points.py`` so that the two run
side by side under ``--dist loadfile``: a plain 255-bit ladder costs some
25 s on the CPU.  ``scalar_mul`` is compared limb for limb against the JAX
package's at 40 bits (its XLA:CPU compile of the Fq2 loop body is the cost
there); ``is_in_subgroup`` runs the whole ladder, against the oracle's
membership.
"""

import random

import numpy as np
import torch

import jax.numpy as jnp

from tpu_bls12_381.curves import g2 as jg2, points as jpt
from tpu_bls12_381.curves.field_adapters import FQ2_ADAPTER as JF2

from tpu_bls12_381_torch import constants, convert, oracle
from tpu_bls12_381_torch.curves import g2, points as pt
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER as F2
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs

# One intra-op thread: the port's CPU path is thousands of tiny tensor ops
# (see tests/test_torch_g2.py).
torch.set_num_threads(1)

P_MOD = constants.FQ_MODULUS
R_MOD = constants.FR_MODULUS


def _fq2_sqrt(a):
    """A square root in Fq2 = Fq[u]/(u^2 + 1) with p = 3 mod 4, or None:
    x0^2 = (a0 +- |a|) / 2, x1 = a1 / (2 x0)."""
    sq = lambda v: pow(v, (P_MOD + 1) // 4, P_MOD)
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P_MOD
    alpha = sq(norm)
    if alpha * alpha % P_MOD != norm:
        return None
    half = pow(2, P_MOD - 2, P_MOD)
    for d in ((a0 + alpha) * half % P_MOD, (a0 - alpha) * half % P_MOD):
        x0 = sq(d)
        if x0 and x0 * x0 % P_MOD == d:
            x1 = a1 * pow(2 * x0, P_MOD - 2, P_MOD) % P_MOD
            if oracle.fq2_sqr((x0, x1)) == (a0 % P_MOD, a1 % P_MOD):
                return (x0, x1)
    return None


def _non_members(count=2):
    """Points of E'(Fq2) outside the r-torsion: x = c + u, c = 1, 2, ... with
    x^3 + 4(1+u) a square; the odds of landing in G2 are about 1/h."""
    out, c = [], 1
    while len(out) < count:
        x = (c, 1)
        y = _fq2_sqrt(oracle.fq2_add(oracle.fq2_mul(oracle.fq2_sqr(x), x), (4, 4)))
        if y is not None:
            out.append((x, y))
        c += 1
    return out


def test_g2_scalar_mul_matches_jax_limb_for_limb():
    """Five lanes, k = 0, 1, 2, random, 2^40 - 1, at 40 bits."""
    rng = random.Random(12)
    G = oracle.g2_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 20), G,
                                                  oracle.FQ2_OPS), oracle.FQ2_OPS)
           for _ in range(5)]
    ks = [0, 1, 2, rng.randrange(1 << 40), (1 << 40) - 1]
    A = g2.affine_from_ints(pts, device="cpu")
    got = pt.scalar_mul(F2, torch.from_numpy(ints_to_limbs(ks, 16).astype(np.int32)),
                        A, num_bits=40)
    want = jpt.scalar_mul(JF2, jnp.asarray(ints_to_limbs(ks, 16)),
                          jg2.affine_from_ints(pts), num_bits=40)
    for g, w in zip(got, want):
        for a, b in zip(convert.fq2_to_numpy(g), w):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert g2.jacobian_to_ints(got) == [
        oracle.jac_to_affine(oracle.scalar_mul(k, p, oracle.FQ2_OPS), oracle.FQ2_OPS)
        if k else None for k, p in zip(ks, pts)]


def test_g2_is_in_subgroup_members_non_members_identity():
    rng = random.Random(13)
    G = oracle.g2_generator()
    members = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, R_MOD), G,
                                                      oracle.FQ2_OPS), oracle.FQ2_OPS)
               for _ in range(2)]
    non = _non_members()
    A = g2.affine_from_ints(members + non + [None], device="cpu")
    assert pt.is_on_curve_affine(F2, A, g2.b_mont((5,), "cpu")).all()
    # the planted points are off the subgroup by the oracle's own ladder
    assert all(oracle.scalar_mul(R_MOD - 1, p, oracle.FQ2_OPS) is not None
               and oracle.jac_to_affine(oracle.scalar_mul(R_MOD - 1, p, oracle.FQ2_OPS),
                                        oracle.FQ2_OPS) != (p[0], oracle.fq2_neg(p[1]))
               for p in non)
    assert pt.is_in_subgroup(F2, A).tolist() == [True, True, False, False, True]
