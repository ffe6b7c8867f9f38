"""The Jacobian group law and the point checks of the PyTorch/CUDA port
(``tpu_bls12_381_torch/curves/points.py``) against the JAX package, on the CPU.

The same points, made from a seed on the host, go through the JAX package's
``curves/points.py`` and through the port.  The JAX package serves G1 on the
TPU with the fused Pallas kernels ``madd`` / ``jadd`` / ``jdbl``, which are
bit-identical to its generic formulas; on the CPU its routers take the generic
formulas, and so do its own tests, so those are the reference here.  The port
keeps the formulas and their order, so coordinates are compared limb for
limb, exactly (tolerance 0: integer arithmetic); group elements are also held
against the big-int oracle as affine ints.

Edge lanes in every group-law case: an identity operand, the affine operand's
``inf``, P == A and P == -A for the mixed add, and for the full add Q
identity, P == Q and P == -Q with Q's Z different from P's (Q scaled by
lambda: (lambda^2 X, lambda^3 Y, lambda Z)).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_bls12_381.curves import g1 as jg1, g2 as jg2, points as jpt
from tpu_bls12_381.curves.field_adapters import FQ2_ADAPTER as JF2, FQ_ADAPTER as JF

from tpu_bls12_381_torch import constants, convert, oracle
from tpu_bls12_381_torch.curves import cuda_g1, g1, g2, points as pt
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER as F2, FQ_ADAPTER as F1
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs

# One intra-op thread: the port's CPU path is thousands of tiny tensor ops
# (see tests/test_torch_g2.py).
torch.set_num_threads(1)

N = 12
P_MOD = constants.FQ_MODULUS
R_MOD = constants.FR_MODULUS


# -----------------------------------------------------------------------------
# Converters between the two packages (G1: (24, n) arrays; G2: (c0, c1) pairs)
# -----------------------------------------------------------------------------

def _is_g2(F):
    return F is F2


def _to_jax(P, F):
    """A point tuple of the port (coordinates, masks) -> the JAX package's."""
    if _is_g2(F):
        return tuple(tuple(jnp.asarray(a) for a in c) if isinstance(c, tuple)
                     else jnp.asarray(c) for c in convert.point_g2_to_numpy(P))
    return tuple(jnp.asarray(c) for c in convert.point_to_numpy(P))


def _assert_limbs_equal(got, want, F):
    """The port's coordinates equal the JAX package's, limb for limb."""
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        elif _is_g2(F):
            for a, b in zip(convert.fq2_to_numpy(g), w):
                np.testing.assert_array_equal(a, np.asarray(b))
        else:
            np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w))


def _curve(F):
    if _is_g2(F):
        return (g2, oracle.FQ2_OPS, oracle.g2_generator(), jg2, JF2)
    return (g1, oracle.FQ_OPS, oracle.g1_generator(), jg1, JF)


def _scale(F, P, lam):
    """(lambda^2 X, lambda^3 Y, lambda Z): the same point, another Z."""
    batch = F.batch_shape(P[0])
    cm = _curve(F)[0]
    if _is_g2(F):
        l = cm.affine_from_ints([((lam, 3), (1, 0))] * batch[0], device="cpu")[0]
    else:
        l = cm.affine_from_ints([(lam, 1)] * batch[0], device="cpu")[0]
    l2 = F.sqr(l)
    l3 = F.mul(l2, l)
    return (F.mul(P[0], l2), F.mul(P[1], l3), F.mul(P[2], l))


# -----------------------------------------------------------------------------
# Points with Z != 1 and the edge lanes
# -----------------------------------------------------------------------------

def _cases(F, seed):
    """(P, Q, A): Jacobian P and Q, affine A, N lanes, with the edge lanes

    0: P identity      1: Q identity / A's inf      2: P == Q / P == A
    3: P == -Q / P == -A      4: both identity      5: P identity, A's inf
    """
    cm, ops_, G, _, _ = _curve(F)
    rng = random.Random(seed)
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 40), G, ops_),
                                ops_) for _ in range(N)]
    A = cm.affine_from_ints(pts, device="cpu")
    B = cm.affine_from_ints(pts[3:] + pts[:3], device="cpu")
    # Jacobian points with Z != 1: 2B, and 2B + A
    P = [c.clone() for c in pt.jac_double(F, pt.affine_to_jac(F, B))]
    Q = [c.clone() for c in pt.jac_add(F, pt.affine_to_jac(F, A), tuple(P))]
    ident = pt.jac_identity(F, (N,), "cpu")
    Pq = _scale(F, tuple(P), 7)                     # P with another Z
    negPq = pt.jac_neg(F, Pq)
    Aj = _scale(F, pt.affine_to_jac(F, A), 5)       # A as a Jacobian point, Z = 5
    inf = torch.zeros(N, dtype=torch.bool)
    for c in range(3):
        P[c][..., 0] = ident[c][..., 0]
        Q[c][..., 1] = ident[c][..., 1]
        Q[c][..., 2] = Pq[c][..., 2]
        Q[c][..., 3] = negPq[c][..., 3]
        P[c][..., 4] = ident[c][..., 4]
        Q[c][..., 4] = ident[c][..., 4]
        P[c][..., 5] = ident[c][..., 5]
        # for the mixed add: P == A in lane 6, P == -A in lane 7
        P[c][..., 6] = Aj[c][..., 6]
        P[c][..., 7] = pt.jac_neg(F, Aj)[c][..., 7]
    inf[1] = inf[5] = True
    A = (A[0], A[1], inf)
    return tuple(c.contiguous() for c in P), tuple(c.contiguous() for c in Q), A


def _oracle_jac(P, F):
    cm, ops_, _, _, _ = _curve(F)
    return cm.jacobian_to_ints(P)


@pytest.fixture(scope="module", params=["g1", "g2"])
def curve(request):
    F = F1 if request.param == "g1" else F2
    return F, _cases(F, 3 if F is F1 else 5)


def test_double_add_and_mixed_add_match_jax_limb_for_limb(curve):
    F, (P, Q, A) = curve
    JFx = _curve(F)[4]
    jP, jQ, jA = _to_jax(P, F), _to_jax(Q, F), _to_jax(A, F)
    _assert_limbs_equal(pt.jac_double(F, P), jpt.jac_double(JFx, jP), F)
    _assert_limbs_equal(pt.jac_add(F, P, Q), jpt.jac_add(JFx, jP, jQ), F)
    _assert_limbs_equal(pt.jac_add_affine(F, P, A), jpt.jac_add_affine(JFx, jP, jA), F)


def test_group_law_edge_lanes_against_the_oracle(curve):
    F, (P, Q, A) = curve
    _, ops_, _, _, _ = _curve(F)
    cm = _curve(F)[0]
    Pi, Qi = _oracle_jac(P, F), _oracle_jac(Q, F)
    Ai = cm.affine_to_ints(A)
    to_jac = lambda a: None if a is None else oracle.affine_to_jac(a, ops_)
    aff = lambda J: None if J is None else oracle.jac_to_affine(J, ops_)
    want_add = [aff(oracle.jac_add(to_jac(p), to_jac(q), ops_)) for p, q in zip(Pi, Qi)]
    want_madd = [aff(oracle.jac_add(to_jac(p), to_jac(a), ops_)) for p, a in zip(Pi, Ai)]
    want_dbl = [aff(oracle.jac_double(to_jac(p), ops_)) for p in Pi]
    assert _oracle_jac(pt.jac_add(F, P, Q), F) == want_add
    assert _oracle_jac(pt.jac_add_affine(F, P, A), F) == want_madd
    assert _oracle_jac(pt.jac_double(F, P), F) == want_dbl
    # the lanes are the edge cases they are meant to be
    assert Qi[2] == Pi[2] and Qi[3] == (Pi[3][0], ops_.neg(Pi[3][1]))
    assert want_add[3] is None and want_madd[7] is None
    assert want_add[4] is None and want_madd[5] is None and want_madd[1] == Pi[1]


def test_routers_on_cpu_tensors_take_the_generic_formulas(curve):
    F, (P, Q, A) = curve
    assert pt._fused(F, P[0]) is None
    assert pt.ladder_kernel(F, P[0].device) is None
    eq = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    assert eq(pt.jac_add_fast(F, P, Q), pt.jac_add(F, P, Q))
    assert eq(pt.jac_add_affine_fast(F, P, A), pt.jac_add_affine(F, P, A))
    assert eq(pt.jac_double_fast(F, P), pt.jac_double(F, P))


def test_g1_wrappers_on_cpu_equal_their_plain_versions():
    """``cuda_g1.madd`` / ``jadd`` / ``jdbl`` take their plain versions for CPU
    tensors, and those are the generic formulas over plain field ops."""
    P, Q, A = _cases(F1, 3)
    eq = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    assert eq(cuda_g1.madd(P, A), pt.jac_add_affine(F1, P, A))
    assert eq(cuda_g1.jadd(P, Q), pt.jac_add(F1, P, Q))
    assert eq(cuda_g1.jdbl(P), pt.jac_double(F1, P))
    assert eq(cuda_g1.madd(P, A), cuda_g1.madd_plain(P, A))


@pytest.mark.parametrize("bad", ["strided", "shapes", "mask"])
def test_g1_wrappers_copy_nothing_and_refuse_other_layouts(bad):
    P, Q, A = _cases(F1, 3)
    if bad == "strided":
        Pb = (P[0][:, ::2], P[1][:, ::2], P[2][:, ::2])
        with pytest.raises(ValueError):
            cuda_g1.jdbl(Pb)
    elif bad == "shapes":
        with pytest.raises(ValueError):
            cuda_g1.jadd(P, tuple(c[:, :4].contiguous() for c in Q))
    else:
        with pytest.raises(TypeError):
            cuda_g1.madd(P, (A[0], A[1], A[2].int()))


def test_router_lays_out_broadcast_operands():
    """``jac_add_fast`` broadcasts Q to P's batch (the JAX ``jadd`` wrapper
    does); on the CPU the generic formula broadcasts the same way."""
    P, Q, _ = _cases(F1, 3)
    Q1 = tuple(c[:, 2:3] for c in Q)
    got = pt.jac_add_fast(F1, P, Q1)
    want = pt.jac_add(F1, P, tuple(c.expand_as(p) for c, p in zip(Q1, P)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    laid, _ = pt._laid_out([*P, *Q1])
    assert all(t.is_contiguous() and t.shape == P[0].shape for t in laid)


def test_eq_affine_to_jac_and_on_curve_match_jax(curve):
    F, (P, Q, A) = curve
    cm, _, _, jcm, JFx = _curve(F)
    jP, jQ, jA = _to_jax(P, F), _to_jax(Q, F), _to_jax(A, F)
    Pq = _scale(F, P, 11)
    got = pt.jac_eq(F, P, Pq)
    assert bool(got.all())
    _assert_limbs_equal((pt.jac_eq(F, P, Q),), (jpt.jac_eq(JFx, jP, jQ),), F)
    _assert_limbs_equal(pt.affine_to_jac(F, A), jpt.affine_to_jac(JFx, jA), F)
    # off-curve lanes: y + 1 in lanes 8 and 9 (x, and X, kept)
    one = F.one((N,), "cpu")
    off = torch.zeros(N, dtype=torch.bool)
    off[8] = off[9] = True
    Ab = (A[0], F.cmov(off, F.add(A[1], one), A[1]), A[2])
    Pb = (P[0], F.cmov(off, F.add(P[1], one), P[1]), P[2])
    b = cm.b_mont((N,), "cpu")
    jb = jcm.b_mont((N,))
    on_a = pt.is_on_curve_affine(F, Ab, b)
    on_j = pt.is_on_curve_jacobian(F, Pb, b)
    assert on_a.tolist() == [i not in (8, 9) for i in range(N)]
    assert on_j.tolist() == on_a.tolist()
    _assert_limbs_equal((on_a,), (jpt.is_on_curve_affine(JFx, _to_jax(Ab, F), jb),), F)
    _assert_limbs_equal((on_j,), (jpt.is_on_curve_jacobian(JFx, _to_jax(Pb, F), jb),), F)


def test_neg_cmov_and_affine_helpers(curve):
    F, (P, Q, A) = curve
    JFx = _curve(F)[4]
    mask = torch.tensor([i % 2 == 0 for i in range(N)])
    jmask = jnp.asarray(mask.numpy())
    _assert_limbs_equal(pt.jac_neg(F, P), jpt.jac_neg(JFx, _to_jax(P, F)), F)
    _assert_limbs_equal(pt.affine_neg(F, A), jpt.affine_neg(JFx, _to_jax(A, F)), F)
    _assert_limbs_equal(pt.jac_cmov(F, mask, P, Q),
                        jpt.jac_cmov(JFx, jmask, _to_jax(P, F), _to_jax(Q, F)), F)
    Ar = tuple(c.roll(1, -1) for c in A)
    _assert_limbs_equal(pt.affine_cmov(F, mask, A, Ar),
                        jpt.affine_cmov(JFx, jmask, _to_jax(A, F), _to_jax(Ar, F)), F)
    _assert_limbs_equal(pt.jac_identity(F, (3,), "cpu"), jpt.jac_identity(JFx, (3,)), F)
    assert pt.jac_is_identity(F, P).tolist() == [i in (0, 4, 5) for i in range(N)]


# -----------------------------------------------------------------------------
# scalar_mul, is_in_subgroup, sum_reduce
# -----------------------------------------------------------------------------

def _scalar_limbs(ks):
    return torch.from_numpy(ints_to_limbs(ks, 16).astype(np.int32))


def test_g1_scalar_mul_matches_jax_limb_for_limb():
    """Five lanes, k = 0, 1, 2, random, r - 1, at 255 bits."""
    rng = random.Random(11)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 30), G,
                                                  oracle.FQ_OPS), oracle.FQ_OPS)
           for _ in range(5)]
    ks = [0, 1, 2, rng.randrange(R_MOD), R_MOD - 1]
    A = g1.affine_from_ints(pts, device="cpu")
    got = pt.scalar_mul(F1, _scalar_limbs(ks), A)
    want = jpt.scalar_mul(JF, jnp.asarray(ints_to_limbs(ks, 16)), jg1.affine_from_ints(pts))
    _assert_limbs_equal(got, want, F1)
    assert g1.jacobian_to_ints(got) == [
        oracle.jac_to_affine(oracle.scalar_mul(k, p, oracle.FQ_OPS), oracle.FQ_OPS)
        if k else None for k, p in zip(ks, pts)]


def _non_members(count=2):
    """G1 curve points outside the r-torsion, as in the JAX package's test:
    x = 5, 6, ... with x^3 + 4 a square; the odds of landing in the subgroup
    are about 1/h."""
    out, x = [], 5
    while len(out) < count:
        rhs = (x * x * x + 4) % P_MOD
        y = pow(rhs, (P_MOD + 1) // 4, P_MOD)       # p = 3 mod 4
        if y * y % P_MOD == rhs:
            out.append((x, y))
        x += 1
    return out


@pytest.fixture(scope="module")
def subgroup_case():
    """Two members, two non-members and the identity; ``is_in_subgroup``'s
    mask on the CPU, and the [r]P limbs its generic loop (``scalar_mul``)
    computed on the way, recorded so that the ladder route's test holds its
    limbs to them without a second 255-bit loop."""
    rng = random.Random(13)
    G = oracle.g1_generator()
    members = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, R_MOD), G,
                                                      oracle.FQ_OPS), oracle.FQ_OPS)
               for _ in range(2)]
    pts = members + _non_members() + [None]
    A = g1.affine_from_ints(pts, device="cpu")
    generic, seen = pt.scalar_mul, []

    def recorded(*args, **kw):
        seen.append(generic(*args, **kw))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pt, "scalar_mul", recorded)
        mask = pt.is_in_subgroup(F1, A)
    (rP,) = seen
    return {"pts": pts, "A": A, "mask": mask, "rP": rP}


def test_g1_is_in_subgroup_members_non_members_identity(subgroup_case):
    """The mask of the JAX package's ``test_subgroup_membership``; the G2
    case is in ``tests/test_torch_points_g2.py``."""
    pts, A, got = (subgroup_case[k] for k in ("pts", "A", "mask"))
    assert pt.is_on_curve_affine(F1, A, g1.b_mont((5,), "cpu")).all()
    assert got.tolist() == [True, True, False, False, True]
    _assert_limbs_equal((got,), (jpt.is_in_subgroup(JF, jg1.affine_from_ints(pts)),), F1)


def test_g1_is_in_subgroup_through_the_ladder_route(subgroup_case, monkeypatch):
    """``ladder_kernel`` forced to ``cuda_g1.jac_ladder`` on CPU tensors, where
    the wrapper takes ``jac_ladder_plain``: ``scalar_mul`` lays A out and hands
    r over as one (16, 1) column (a lane stride of 0, never copied out to the
    batch), one ladder call for the whole check, and ``is_in_subgroup`` gives
    the masks of ``test_g1_is_in_subgroup_members_non_members_identity``; the
    ladder's limbs equal the generic loop's (``scalar_mul`` on the CPU, as
    ``is_in_subgroup`` ran it there)."""
    A = subgroup_case["A"]
    calls = []

    def ladder(k, A_, num_bits):
        calls.append((tuple(k.shape), num_bits))
        calls.append(cuda_g1.jac_ladder(k, A_, num_bits))
        return calls[-1]

    monkeypatch.setattr(pt, "ladder_kernel", lambda F, device: ladder if F is F1 else None)
    got = pt.is_in_subgroup(F1, A)
    assert got.tolist() == [True, True, False, False, True]
    assert calls[0] == ((16, 1), 255) and len(calls) == 2
    assert all(torch.equal(a, b) for a, b in zip(calls[1], subgroup_case["rP"]))


@pytest.mark.parametrize("bad", ["expanded", "shape", "bits"])
def test_jac_ladder_refuses_other_scalar_layouts(bad):
    """``cuda_g1.jac_ladder`` copies nothing: scalars are contiguous (16, *batch)
    planes or one contiguous (16, 1) column, and num_bits is 1 to 256."""
    _, _, A = _cases(F1, 3)
    r = _scalar_limbs([R_MOD])
    if bad == "expanded":
        with pytest.raises(ValueError):
            cuda_g1.jac_ladder(r.expand(16, N), A)
    elif bad == "shape":
        with pytest.raises(ValueError):
            cuda_g1.jac_ladder(_scalar_limbs([1] * (N - 1)), A)
    else:
        for num_bits in (0, 257):
            with pytest.raises(ValueError):
                cuda_g1.jac_ladder(r, A, num_bits)


@pytest.mark.parametrize("name", ["g1", "g2"])
def test_sum_reduce_of_seven_matches_jax_and_the_oracle(name):
    """n = 7 (padded to 8 with identities), one lane the identity and two
    lanes equal, so the rounds meet a doubling too."""
    F = F1 if name == "g1" else F2
    cm, ops_, G, _, JFx = _curve(F)
    rng = random.Random(14)
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 30), G, ops_),
                                ops_) for _ in range(6)]
    pts = pts[:4] + [None] + pts[4:5] + pts[4:5]
    P = pt.affine_to_jac(F, cm.affine_from_ints(pts, device="cpu"))
    S = pt.sum_reduce(F, P)
    _assert_limbs_equal(S, jpt.sum_reduce(JFx, _to_jax(P, F)), F)
    acc = None
    for p in pts:
        acc = oracle.jac_add(acc, None if p is None else oracle.affine_to_jac(p, ops_), ops_)
    got = cm.jacobian_to_ints(tuple(c[..., None] for c in S))
    assert got == [oracle.jac_to_affine(acc, ops_)]


def test_jac_to_affine_and_jacobian_to_ints_match_jax(curve, monkeypatch):
    """The affine conversion behind ``MsmContext.to_affine`` and
    ``jacobian_to_ints`` equals the JAX package's ``points.jac_to_affine``
    limb for limb (identity lanes and points with Z != 1 among the lanes),
    and its ints equal the JAX package's ``jacobian_to_ints``.  Its one
    inversion is one ``cuda_ops.field_inv`` call (a launch on the card),
    for G2 on the Fq2 norm."""
    from tpu_bls12_381_torch.fields import cuda_ops

    F, (P, Q, _) = curve
    cm, _, _, jcm, JFa = _curve(F)
    calls = []
    inv = cuda_ops.field_inv
    monkeypatch.setattr(cuda_ops, "field_inv",
                        lambda spec, a: (calls.append(tuple(a.shape)), inv(spec, a))[1])
    _assert_limbs_equal(pt.jac_to_affine(F, P), jpt.jac_to_affine(JFa, _to_jax(P, F)), F)
    assert calls == [(24, N)]
    assert cm.jacobian_to_ints(Q) == jcm.jacobian_to_ints(_to_jax(Q, F))
    assert len(calls) == 2


def test_jacobian_converters_carry_jax_points_across():
    P, _, A = _cases(F1, 3)
    back = convert.point_from_numpy(convert.point_to_numpy(P), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(P, back))
    assert torch.equal(convert.mask_from_numpy(np.asarray(A[2]), device="cpu"), A[2])
    J = jpt.jac_double(JF, _to_jax(P, F1))
    mine = convert.point_from_numpy([np.asarray(c) for c in J], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(mine, pt.jac_double(F1, P)))
    with pytest.raises(ValueError):
        convert.point_from_numpy([np.zeros((16, 2), np.uint32)] * 3, device="cpu")
