"""Fq2 and the G2 group law of the PyTorch/CUDA port against the JAX package,
on the CPU.

The same values, made from a seed on the host, go through the JAX functions
(``curves/field_adapters.py``, ``curves/projective.py``, ``curves/points.py``,
``curves/g2.py``) and through their counterparts in
``tpu_bls12_381_torch``.  The JAX package's G2 Pallas kernels do not run on
the CPU, so the reference is its plain group law over ``FQ2_ADAPTER``, which is
what its own CPU tests use.  Field results are canonical and the formulas are
the same, so coordinates are compared limb for limb, exactly (tolerance 0:
integer arithmetic).  The G2 MSM has a file of its own,
``tests/test_torch_msm_g2.py``.

The JAX package holds an Fq2 batch as a ``(c0, c1)`` pair; the port holds one
``(24, 2, *batch)`` tensor; ``convert`` maps between them.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_bls12_381 import oracle
from tpu_bls12_381.curves import g1 as jg1, g2 as jg2, points as jpt, projective as jpj
from tpu_bls12_381.curves.field_adapters import FQ2_ADAPTER as JF2, FQ_ADAPTER as JF
from tpu_bls12_381.fields.limbs import ints_to_limbs

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import cuda_g1, cuda_g2, g1, g2, points, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import (FQ2_ADAPTER as F2, FQ2_PLAIN,
                                                       FQ_ADAPTER as F1, FQ_PLAIN)
from tpu_bls12_381_torch.fields import FQ

N = 24

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)
P_MOD = constants.FQ_MODULUS
tree_map = jax.tree_util.tree_map


def _jpair(pair):
    return tuple(jnp.asarray(c) for c in pair)


def _jpoint(P):
    """numpy point (pairs, mask) -> the JAX package's tree."""
    return tuple(_jpair(c) if isinstance(c, tuple) else jnp.asarray(c) for c in P)


def _tpoint(P):
    """numpy point (pairs, mask) -> the port's tensors on the CPU."""
    return tuple(convert.fq2_from_numpy(c, device="cpu") if isinstance(c, tuple)
                 else torch.from_numpy(np.asarray(c)) for c in P)


def _np_tree(P):
    return tuple(tuple(np.array(x) for x in c) if isinstance(c, tuple)
                 else np.array(c) for c in P)


def _assert_same(got, want):
    """Port point / Fq2 tensors against the JAX package's tree, limb for limb."""
    for g, w in zip(convert.point_g2_to_numpy(got), want):
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], np.asarray(w[0]))
            np.testing.assert_array_equal(g[1], np.asarray(w[1]))
        else:
            np.testing.assert_array_equal(g, np.asarray(w))


def _host_points(n, seed=0xB2):
    rng = random.Random(seed)
    G = oracle.g2_generator()
    base = [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 32), G, oracle.FQ2_OPS),
        oracle.FQ2_OPS) for _ in range(n)]
    return base


@pytest.fixture(scope="module")
def fq2_pairs():
    """Two Fq2 batches as (c0, c1) numpy pairs, with the lanes that carry a
    borrow or a zero: 0, 1, p-1, c0 = c1, c0 < c1, c1 = 0."""
    rng = random.Random(0xF92)
    def batch():
        c0 = [0, 1, P_MOD - 1, 5, 3, 7] + [rng.randrange(P_MOD) for _ in range(N - 6)]
        c1 = [0, 0, P_MOD - 1, 5, P_MOD - 2, 0] + [rng.randrange(P_MOD) for _ in range(N - 6)]
        return (ints_to_limbs(c0, 24), ints_to_limbs(c1, 24))
    a, b = batch(), batch()
    b = (np.roll(b[0], 5, axis=1), np.roll(b[1], 5, axis=1))
    return a, b


FQ2_OPS = {
    "add": lambda F, a, b: F.add(a, b),
    "sub": lambda F, a, b: F.sub(a, b),
    "sub_reversed": lambda F, a, b: F.sub(b, a),
    "mul": lambda F, a, b: F.mul(a, b),
    "sqr": lambda F, a, b: F.sqr(a),
    "neg": lambda F, a, b: F.neg(a),
    "double": lambda F, a, b: F.double(b),
    "inv": lambda F, a, b: F.inv(a),
}


@pytest.mark.parametrize("adapter", ["routed", "plain"])
@pytest.mark.parametrize("op", sorted(FQ2_OPS))
def test_fq2_adapter_matches_jax(fq2_pairs, op, adapter):
    a, b = fq2_pairs
    F = {"routed": F2, "plain": FQ2_PLAIN}[adapter]
    got = FQ2_OPS[op](F, convert.fq2_from_numpy(a, "cpu"), convert.fq2_from_numpy(b, "cpu"))
    want = FQ2_OPS[op](JF2, _jpair(a), _jpair(b))
    assert got.shape == (24, 2, N) and got.dtype == torch.int32
    _assert_same((got,), (want,))


def test_fq2_predicates_constants_and_cost_facts(fq2_pairs):
    a, b = fq2_pairs
    ta, tb = convert.fq2_from_numpy(a, "cpu"), convert.fq2_from_numpy(b, "cpu")
    np.testing.assert_array_equal(F2.is_zero(ta).numpy(), np.asarray(JF2.is_zero(_jpair(a))))
    assert F2.is_zero(ta).tolist()[:3] == [True, False, False]
    half = (a[0], b[1])                      # equal in c0 only
    np.testing.assert_array_equal(
        F2.eq(ta, convert.fq2_from_numpy(half, "cpu")).numpy(),
        np.asarray(JF2.eq(_jpair(a), _jpair(half))))
    mask = np.arange(N) % 2 == 0
    _assert_same((F2.cmov(torch.from_numpy(mask), ta, tb),),
                 (JF2.cmov(jnp.asarray(mask), _jpair(a), _jpair(b)),))
    _assert_same((F2.zero((3,), "cpu"), F2.one((3,), "cpu")),
                 (JF2.zero((3,)), JF2.one((3,))))
    assert F2.batch_shape(ta) == (N,) and F2.elem_shape == (24, 2)
    assert (F2.fq_muls_per_mul, F2.limb_planes) == (JF2.fq_muls_per_mul, JF2.limb_planes)
    assert (F1.fq_muls_per_mul, F1.limb_planes) == (JF.fq_muls_per_mul, JF.limb_planes)
    # converters: a pair goes in and the same pair comes out
    back = convert.fq2_to_numpy(ta)
    np.testing.assert_array_equal(back[0], a[0])
    np.testing.assert_array_equal(back[1], a[1])
    with pytest.raises(ValueError):
        convert.fq2_from_numpy((a[0], a[1][:, :3]), "cpu")


def test_fq_adapter_inv_matches_jax():
    rng = random.Random(3)
    vals = [0, 1, P_MOD - 1] + [rng.randrange(P_MOD) for _ in range(5)]
    a = ints_to_limbs(vals, 24)
    got = F1.inv(convert.field_from_numpy(a, FQ, "cpu"))
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  np.asarray(JF.inv(jnp.asarray(a))))
    plain = FQ_PLAIN.inv(convert.field_from_numpy(a, FQ, "cpu"))
    assert torch.equal(got, plain)


@pytest.fixture(scope="module")
def batch():
    """Numpy inputs shared by both sides: affine A, B (lanes 0..3 of B hold
    the identity), projective P, Q with Z != 1 and the edge lanes of the group
    law: identity + Q, P + identity, P + P, P + (-P), identity + identity."""
    base = _host_points(8)
    pts = [base[i % 8] for i in range(N)]
    rot = pts[3:] + pts[:3]
    rot[:4] = [None] * 4
    A = _np_tree(jg2.affine_from_ints(pts))
    B = _np_tree(jg2.affine_from_ints(rot))
    P = jpj.proj_double(JF2, jpj.affine_to_proj(JF2, _jpoint(A)))
    Q = jpj.proj_add(JF2, jpj.affine_to_proj(JF2, _jpoint(B)), P)
    P, Q = [list(c) for c in _np_tree(P)], [list(c) for c in _np_tree(Q)]
    ident = _np_tree(jpj.proj_identity(JF2, (N,)))
    negP = _np_tree(jpj.proj_neg(JF2, _jpoint(tuple(tuple(c) for c in P))))
    for c in range(3):
        for k in range(2):
            P[c][k][:, 0] = ident[c][k][:, 0]
            Q[c][k][:, 1] = ident[c][k][:, 1]
            Q[c][k][:, 2] = P[c][k][:, 2]
            Q[c][k][:, 3] = negP[c][k][:, 3]
            P[c][k][:, 4] = ident[c][k][:, 4]
            Q[c][k][:, 4] = ident[c][k][:, 4]
    sign = np.arange(N) % 3 == 0
    return {"pts": pts, "rot": rot, "A": A, "B": B,
            "P": tuple(tuple(c) for c in P), "Q": tuple(tuple(c) for c in Q),
            "sign": sign}


def _contig(T):
    return tuple(c.contiguous() for c in T)


def test_g2_converters_match_jax(batch):
    A = g2.affine_from_ints(batch["pts"], device="cpu")
    _assert_same(A, batch["A"])
    assert g2.affine_to_ints(A) == batch["pts"]
    B = g2.affine_from_ints(batch["rot"], device="cpu")
    _assert_same(B, batch["B"])
    assert g2.affine_to_ints(B) == batch["rot"]
    _assert_same(g2.generator_affine((3,), device="cpu"), jg2.generator_affine((3,)))
    _assert_same(g2.generator_affine((), device="cpu"), jg2.generator_affine(()))
    _assert_same((g2.b_mont((2,), device="cpu"),), (jg2.b_mont((2,)),))
    _assert_same(convert.affine_g2_from_numpy(*batch["A"], device="cpu"), batch["A"])


KERNEL_PLAINS = ["padd2", "pdbl2", "pmadd2", "pmadd2_signed", "pmadd"]


@pytest.mark.parametrize("kernel", KERNEL_PLAINS)
def test_kernel_plain_versions_match_jax(batch, kernel):
    """The plain versions beside the kernels, through the wrappers (a CPU
    tensor takes the plain version), against the JAX package's plain group
    law; identity lanes, P + P, P + (-P), inf2 and sign included."""
    P, Q, B, sign = batch["P"], batch["Q"], batch["B"], batch["sign"]
    tP, tQ, tB = _contig(_tpoint(P)), _contig(_tpoint(Q)), _contig(_tpoint(B))
    if kernel == "padd2":
        got = cuda_g2.padd2(tP, tQ)
        want = jpj.proj_add(JF2, _jpoint(P), _jpoint(Q))
        assert not convert.to_numpy(got[2])[..., 3:5].any()      # the identity
    elif kernel == "pdbl2":
        got = cuda_g2.pdbl2(tQ)
        want = jpj.proj_double(JF2, _jpoint(Q))
    elif kernel == "pmadd2":
        got = cuda_g2.pmadd2(tP, tB)
        want = jpj.proj_add_mixed(JF2, _jpoint(P), _jpoint(B))
        _assert_same(tuple(c[..., :4] for c in got),             # inf2 passes P
                     tree_map(lambda c: c[..., :4], _jpoint(P)))
    elif kernel == "pmadd2_signed":
        got = cuda_g2.pmadd2(tP, tB, torch.from_numpy(sign))
        want = jpj.proj_add_mixed_signed_fast(JF2, _jpoint(P), _jpoint(B),
                                              jnp.asarray(sign))
        assert torch.equal(got[0], pj.proj_add_mixed_signed(
            FQ2_PLAIN, tP, tB, torch.from_numpy(sign))[0])
    else:
        pts1 = [oracle.jac_to_affine(oracle.scalar_mul(3 + i, oracle.g1_generator(),
                                                       oracle.FQ_OPS), oracle.FQ_OPS)
                for i in range(6)] + [None, None]
        A1 = tuple(np.asarray(c) for c in jg1.affine_from_ints(pts1))
        P1 = jpj.proj_double(JF, jpj.affine_to_proj(JF, tuple(
            jnp.roll(jnp.asarray(c), 1, axis=-1) for c in A1)))
        got = cuda_g1.pmadd(
            tuple(convert.field_from_numpy(np.asarray(c), FQ, "cpu") for c in P1),
            convert.affine_from_numpy(*A1, device="cpu"))
        want = jpj.proj_add_mixed(JF, P1, tuple(jnp.asarray(c) for c in A1))
        for g, w in zip(convert.point_to_numpy(got), want):
            np.testing.assert_array_equal(g, np.asarray(w))
        return
    _assert_same(got, want)


def test_pmadd2_rows_matches_a_scan_of_jax_mixed_adds(batch):
    R, L = 3, N // 3
    A, sign = batch["A"], batch["sign"]
    tA = _tpoint(A)
    tile = torch.cat([tA[0].reshape(48, N), tA[1].reshape(48, N)]
                     ).reshape(96, R, L).permute(1, 0, 2).contiguous()
    xr, yr = tile[:, :48].unflatten(1, (24, 2)), tile[:, 48:].unflatten(1, (24, 2))
    inf = np.zeros((R, L), dtype=bool)
    inf[0, 1] = inf[2, 2] = True
    sg = sign.reshape(R, L).copy()
    got = cuda_g2.pmadd2_rows(xr, yr, torch.from_numpy(sg), torch.from_numpy(inf))
    acc = jpj.proj_identity(JF2, (L,))
    jA = _jpoint(A)
    for r in range(R):
        row = lambda c: c.reshape(24, R, L)[:, r]
        acc = jpj.proj_add_mixed_signed_fast(
            JF2, acc, (tree_map(row, jA[0]), tree_map(row, jA[1]), jnp.asarray(inf[r])),
            jnp.asarray(sg[r]))
        _assert_same(tuple(c[r] for c in got), acc)
    # through the router, as the MSM's scan calls it
    routed = pj.proj_scan_rows_fast(F2, xr, yr, torch.from_numpy(sg), torch.from_numpy(inf))
    assert all(torch.equal(a, b) for a, b in zip(routed, got))


@pytest.mark.parametrize("fn", ["proj_to_affine", "proj_to_jac", "jac_to_proj",
                                "jac_to_affine", "affine_to_proj", "proj_neg",
                                "proj_eq"])
@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_point_conversions_match_jax(batch, fn, curve):
    if curve == "g2":
        F, JFx, Q = F2, JF2, batch["Q"]
        tQ, jQ = _tpoint(Q), _jpoint(Q)
        tB, jB = _tpoint(batch["B"]), _jpoint(batch["B"])
        same = _assert_same
    else:
        F, JFx = F1, JF
        pts = [oracle.jac_to_affine(oracle.scalar_mul(5 + i, oracle.g1_generator(),
                                                      oracle.FQ_OPS), oracle.FQ_OPS)
               for i in range(5)] + [None]
        jB = jg1.affine_from_ints(pts)
        jQ = jpj.proj_double(JF, jpj.affine_to_proj(JF, jB))
        tB = convert.affine_from_numpy(*[np.asarray(c) for c in jB], device="cpu")
        tQ = tuple(convert.field_from_numpy(np.asarray(c), FQ, "cpu") for c in jQ)

        def same(got, want):
            for g, w in zip(convert.point_to_numpy(got), want):
                np.testing.assert_array_equal(g, np.asarray(w))
    if fn == "proj_to_affine":
        same(pj.proj_to_affine(F, tQ), jpj.proj_to_affine(JFx, jQ))
    elif fn == "proj_to_jac":
        same(pj.proj_to_jac(F, tQ), jpj.proj_to_jac(JFx, jQ))
    elif fn == "jac_to_proj":
        jJ = jpj.proj_to_jac(JFx, jQ)
        same(pj.jac_to_proj(F, pj.proj_to_jac(F, tQ)), jpj.jac_to_proj(JFx, jJ))
    elif fn == "jac_to_affine":
        jJ = jpj.proj_to_jac(JFx, jQ)
        same(points.jac_to_affine(F, pj.proj_to_jac(F, tQ)), jpt.jac_to_affine(JFx, jJ))
    elif fn == "affine_to_proj":
        same(pj.affine_to_proj(F, tB), jpj.affine_to_proj(JFx, jB))
    elif fn == "proj_neg":
        same(pj.proj_neg(F, tQ), jpj.proj_neg(JFx, jQ))
    else:
        tD, jD = pj.proj_double(F, tQ), jpj.proj_double(JFx, jQ)
        tS, jS = pj.proj_add(F, tQ, tQ), jpj.proj_add(JFx, jQ, jQ)
        np.testing.assert_array_equal(pj.proj_eq(F, tD, tS).numpy(),
                                      np.asarray(jpj.proj_eq(JFx, jD, jS)))
        assert bool(pj.proj_eq(F, tD, tS).all())
        np.testing.assert_array_equal(pj.proj_eq(F, tD, tQ).numpy(),
                                      np.asarray(jpj.proj_eq(JFx, jD, jQ)))


def test_jacobian_to_ints_inverts_where_the_point_lives(batch):
    J = pj.proj_to_jac(F2, pj.proj_add_mixed(F2, _tpoint(batch["P"]), _tpoint(batch["B"])))
    want = jg2.jacobian_to_ints(jpj.proj_to_jac(JF2, jpj.proj_add_mixed(
        JF2, _jpoint(batch["P"]), _jpoint(batch["B"]))))
    assert g2.jacobian_to_ints(J) == want
    pts1 = [oracle.jac_to_affine(oracle.scalar_mul(9 + i, oracle.g1_generator(),
                                                   oracle.FQ_OPS), oracle.FQ_OPS)
            for i in range(3)] + [None]
    J1 = pj.proj_to_jac(F1, pj.proj_double(F1, pj.affine_to_proj(
        F1, g1.affine_from_ints(pts1, device="cpu"))))
    want1 = [None if p is None else oracle.jac_to_affine(
        oracle.scalar_mul(2, p, oracle.FQ_OPS), oracle.FQ_OPS) for p in pts1]
    assert g1.jacobian_to_ints(J1) == want1
    assert g1.jacobian_to_ints(tuple(c[:, 0] for c in J1)) == want1[:1]


@pytest.mark.parametrize("bad", ["view", "shape", "dtype", "mask", "fq_layout"])
def test_g2_wrappers_refuse_what_the_kernels_do_not_take(batch, bad):
    P, Q = _contig(_tpoint(batch["P"])), _contig(_tpoint(batch["Q"]))
    B = _contig(_tpoint(batch["B"]))
    if bad == "view":
        with pytest.raises(ValueError, match="contiguous"):
            cuda_g2.padd2(tuple(c[..., ::2] for c in P), tuple(c[..., ::2] for c in Q))
    elif bad == "shape":
        with pytest.raises(ValueError):
            cuda_g2.padd2(P, tuple(c[..., :5].contiguous() for c in Q))
    elif bad == "dtype":
        with pytest.raises(TypeError):
            cuda_g2.pdbl2(tuple(c.long() for c in P))
    elif bad == "mask":
        with pytest.raises(ValueError):
            cuda_g2.pmadd2(P, (B[0], B[1], B[2][:5]))
        with pytest.raises(TypeError):
            cuda_g2.pmadd2(P, B, B[2].int())
    else:
        with pytest.raises(ValueError, match="2"):
            cuda_g2.pdbl2(tuple(c[:, 0].contiguous() for c in P))
        with pytest.raises(ValueError):
            cuda_g2.pmadd2_rows(P[0][None, :, 0], P[1][None, :, 0],
                                torch.zeros((1, N), dtype=torch.bool),
                                torch.zeros((1, N), dtype=torch.bool))
