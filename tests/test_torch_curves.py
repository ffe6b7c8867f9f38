"""G1 group law and GLV of the PyTorch/CUDA port against the JAX package, on
the CPU.

The same points, made from a seed on the host, go through the JAX functions of
``curves/projective.py`` / ``curves/glv.py`` and through their counterparts in
``tpu_bls12_381_torch`` (plain PyTorch versions on CPU tensors).  On the CPU
the JAX package itself runs its plain reference, not the Pallas kernels.  The
formulas are the same and field results are canonical, so projective
coordinates are compared limb for limb, exactly.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_bls12_381 import oracle
from tpu_bls12_381.curves import g1 as jg1, glv as jglv, projective as jpj
from tpu_bls12_381.curves.field_adapters import FQ_ADAPTER as JF
from tpu_bls12_381.fields.limbs import ints_to_limbs, limbs_to_ints

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import cuda_g1, g1, glv, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER as F, FQ_PLAIN
from tpu_bls12_381_torch.fields import FQ, FR

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)

N = 64


def _host_points(n, seed=0xB15):
    rng = random.Random(seed)
    G = oracle.g1_generator()
    return [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 48), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(n)]


@pytest.fixture(scope="module")
def batch():
    """Numpy inputs shared by both sides: affine A, B (lanes 0..3 of B hold the
    identity), projective P, Q with Z != 1 and the edge lanes of the group
    law: identity + Q, P + identity, P + P, P + (-P), identity + identity."""
    pts = _host_points(N)
    rot = pts[7:] + pts[:7]
    rot[:4] = [None] * 4
    A = tuple(np.asarray(c) for c in jg1.affine_from_ints(pts))
    B = tuple(np.asarray(c) for c in jg1.affine_from_ints(rot))
    # projective inputs with Z != 1, made once by the JAX package
    P = jpj.proj_double(JF, jpj.affine_to_proj(JF, tuple(map(jnp.asarray, A))))
    Q = jpj.proj_add(JF, jpj.affine_to_proj(JF, tuple(map(jnp.asarray, B))), P)
    P = [np.array(c) for c in P]
    Q = [np.array(c) for c in Q]
    ident = [np.asarray(c) for c in jpj.proj_identity(JF, (N,))]
    negP = [np.asarray(c) for c in jpj.proj_neg(JF, tuple(map(jnp.asarray, P)))]
    for c in range(3):
        P[c][:, 0] = ident[c][:, 0]
        Q[c][:, 1] = ident[c][:, 1]
        Q[c][:, 2] = P[c][:, 2]
        Q[c][:, 3] = negP[c][:, 3]
        P[c][:, 4] = ident[c][:, 4]
        Q[c][:, 4] = ident[c][:, 4]
    sign = np.arange(N) % 3 == 0
    return {"pts": pts, "A": A, "B": B, "P": tuple(P), "Q": tuple(Q),
            "sign": sign}


def _proj(t):
    return tuple(convert.field_from_numpy(c, FQ, device="cpu") for c in t)


def _aff(t):
    return convert.affine_from_numpy(*t, device="cpu")


def _j(t):
    return tuple(jnp.asarray(c) for c in t)


def _assert_same(got, want):
    for g, w in zip(convert.point_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_affine_converters_match_jax(batch):
    A = g1.affine_from_ints(batch["pts"], device="cpu")
    _assert_same(A, batch["A"])
    assert g1.affine_to_ints(A) == batch["pts"]
    rot = g1.affine_to_ints(_aff(batch["B"]))
    assert rot[:4] == [None] * 4 and rot[4] == batch["pts"][11]
    G = g1.generator_affine((3,), device="cpu")
    _assert_same(G, jg1.generator_affine((3,)))
    _assert_same((g1.b_mont((2,), device="cpu"),), (jg1.b_mont((2,)),))


def test_point_plumbing_matches_jax(batch):
    A, P, Q = batch["A"], batch["P"], batch["Q"]
    _assert_same(pj.affine_to_proj(F, _aff(batch["B"])),
                 jpj.affine_to_proj(JF, _j(batch["B"])))
    _assert_same(pj.proj_identity(F, (5,), device="cpu"),
                 jpj.proj_identity(JF, (5,)))
    _assert_same(pj.proj_neg(F, _proj(P)), jpj.proj_neg(JF, _j(P)))
    mask = np.arange(N) % 2 == 1
    _assert_same(pj.proj_cmov(F, torch.from_numpy(mask), _proj(P), _proj(Q)),
                 jpj.proj_cmov(JF, jnp.asarray(mask), _j(P), _j(Q)))


@pytest.mark.parametrize("adapter", ["routed", "plain"])
def test_proj_add_matches_jax(batch, adapter):
    Fa = F if adapter == "routed" else FQ_PLAIN
    got = pj.proj_add(Fa, _proj(batch["P"]), _proj(batch["Q"]))
    want = jpj.proj_add(JF, _j(batch["P"]), _j(batch["Q"]))
    _assert_same(got, want)
    # P + (-P) and identity + identity are the identity: Z = 0
    assert not np.asarray(want[2])[:, 3:5].any()


def test_proj_add_mixed_matches_jax(batch):
    got = pj.proj_add_mixed(F, _proj(batch["P"]), _aff(batch["B"]))
    want = jpj.proj_add_mixed(JF, _j(batch["P"]), _j(batch["B"]))
    _assert_same(got, want)
    # same-point lanes: A added to its own projective image is the doubling
    PA = pj.affine_to_proj(F, _aff(batch["A"]))
    _assert_same(pj.proj_add_mixed(F, PA, _aff(batch["A"])),
                 jpj.proj_add_mixed(JF, jpj.affine_to_proj(JF, _j(batch["A"])),
                                    _j(batch["A"])))


def test_signed_mixed_add_matches_jax(batch):
    """Signed mixed add with inf2 lanes, P + P (sign clear) and P + (-P)
    (sign set) lanes, through every entry the port has for it."""
    A = batch["A"]
    P = [c.copy() for c in batch["P"]]
    PA = [np.asarray(c) for c in jpj.affine_to_proj(JF, _j(A))]
    x2, y2, inf2 = (c.copy() for c in batch["B"])
    sign = batch["sign"].copy()
    for lane, s in ((8, False), (9, True)):
        for c in range(3):
            P[c][:, lane] = PA[c][:, lane]
        x2[:, lane], y2[:, lane], inf2[lane], sign[lane] = \
            A[0][:, lane], A[1][:, lane], False, s
    want = jpj.proj_add_mixed_signed_fast(
        JF, _j(P), (jnp.asarray(x2), jnp.asarray(y2), jnp.asarray(inf2)),
        jnp.asarray(sign))
    assert not np.asarray(want[2])[:, 9].any()          # P + (-P) = identity
    tP, tA, ts = _proj(P), _aff((x2, y2, inf2)), torch.from_numpy(sign)
    before = dict(cuda_g1.LAUNCHES)
    _assert_same(pj.proj_add_mixed_signed(F, tP, tA, ts), want)
    _assert_same(pj.proj_add_mixed_signed_fast(F, tP, tA, ts), want)
    _assert_same(cuda_g1.pmadd_signed(tP, tA, ts), want)
    _assert_same(cuda_g1.pmadd_signed_plain(tP, tA, ts), want)
    assert cuda_g1.LAUNCHES == before  # CPU tensors launch nothing


def test_proj_double_and_to_jac_match_jax(batch):
    P = batch["P"]
    want = jpj.proj_double(JF, _j(P))
    _assert_same(pj.proj_double(F, _proj(P)), want)
    _assert_same(pj.proj_double_fast(F, _proj(P)), want)
    _assert_same(cuda_g1.pdbl(_proj(P)), want)
    _assert_same(pj.proj_to_jac(F, _proj(P)), jpj.proj_to_jac(JF, _j(P)))
    # the affine points behind the Jacobian form are the oracle's doublings
    got = g1.jacobian_to_ints(pj.proj_to_jac(F, _proj(P)))
    pts = batch["pts"]
    dbl = lambda a: oracle.jac_to_affine(
        oracle.jac_double(oracle.affine_to_jac(a, oracle.FQ_OPS), oracle.FQ_OPS),
        oracle.FQ_OPS)
    assert got[0] is None and got[4] is None
    assert got[5:9] == [dbl(a) for a in pts[5:9]]


def test_routers_and_wrappers_on_cpu_equal_plain(batch):
    P, Q = _proj(batch["P"]), _proj(batch["Q"])
    want = jpj.proj_add(JF, _j(batch["P"]), _j(batch["Q"]))
    _assert_same(pj.proj_add_fast(F, P, Q), want)
    _assert_same(cuda_g1.padd(P, Q), want)
    _assert_same(cuda_g1.padd_plain(P, Q), want)
    _assert_same(pj.proj_add_mixed_fast(F, P, _aff(batch["B"])),
                 jpj.proj_add_mixed(JF, _j(batch["P"]), _j(batch["B"])))


def test_scan_rows_equal_a_chain_of_jax_signed_adds(batch):
    """``pmadd_signed_rows`` (the looped form) on the two halves of one
    (R, 48, L) tile against R JAX signed mixed adds from the identity."""
    R, L = 4, 16
    x, y, inf = batch["B"]
    tile = np.concatenate([x, y]).reshape(48, R, L).transpose(1, 0, 2).copy()
    sign = batch["sign"].reshape(R, L)
    infr = inf.reshape(R, L).copy()
    infr[:, 5] = True                      # a column that stays the identity
    t = torch.from_numpy(tile.astype(np.int32))
    got = cuda_g1.pmadd_signed_rows(t[:, :24], t[:, 24:],
                                    torch.from_numpy(sign),
                                    torch.from_numpy(infr))
    acc = jpj.proj_identity(JF, (L,))
    for r in range(R):
        acc = jpj.proj_add_mixed_signed_fast(
            JF, acc, (jnp.asarray(tile[r, :24]), jnp.asarray(tile[r, 24:]),
                      jnp.asarray(infr[r])), jnp.asarray(sign[r]))
        _assert_same(tuple(c[r] for c in got), acc)
    assert not convert.to_numpy(got[2])[:, :, 5].any()


def test_wrappers_refuse_bad_arguments(batch):
    P, Q = _proj(batch["P"]), _proj(batch["Q"])
    with pytest.raises(TypeError):
        cuda_g1.padd(tuple(c.to(torch.int64) for c in P), Q)
    with pytest.raises(ValueError):
        cuda_g1.pdbl(tuple(c[:16] for c in P))
    x, y, inf = _aff(batch["B"])
    with pytest.raises(ValueError):
        cuda_g1.pmadd_signed_rows(x[None], y[None], inf[None, :8], inf[None])
    with pytest.raises(TypeError):
        cuda_g1.pmadd_signed_rows(x[None], y[None], inf[None].int(), inf[None])


def test_wrappers_copy_nothing_and_refuse_other_layouts(batch):
    """A wrapper takes contiguous operands of one shape and raises on a view,
    a broadcast operand or rows at two strides: it never copies."""
    P, Q = _proj(batch["P"]), _proj(batch["Q"])
    x, y, inf = _aff(batch["B"])
    sign = torch.from_numpy(batch["sign"])
    halves = tuple(c[:, ::2] for c in P)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_g1.pdbl(halves)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_g1.padd(P, tuple(c[:, :1].expand(24, N) for c in Q))
    with pytest.raises(ValueError, match="shape"):
        cuda_g1.padd(P, tuple(c[:, :1].contiguous() for c in Q))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_g1.pmadd_signed(P, (x, y, inf), sign[:1].expand(N))
    t = torch.zeros((4, 72, 16), dtype=torch.int32)
    m = torch.zeros((4, 16), dtype=torch.bool)
    cuda_g1.pmadd_signed_rows(t[:, :24], t[:, 24:48], m, m)      # one stride
    with pytest.raises(ValueError, match="row stride"):
        cuda_g1.pmadd_signed_rows(t[:, :24], t[:, 24:48].contiguous(), m, m)
    with pytest.raises(ValueError, match="row stride"):
        cuda_g1.pmadd_signed_rows(t[:, :24, ::2], t[:, 24:48, ::2],
                                  m[:, ::2].contiguous(), m[:, ::2].contiguous())


def test_routers_lay_out_views_and_broadcasts_for_the_wrappers(batch):
    """``_laid_out`` is what the routers hand the wrappers for CUDA tensors:
    one batch shape, contiguous, values unchanged, accepted by the wrapper."""
    P, Q = _proj(batch["P"]), _proj(batch["Q"])
    views = [c[:, ::2] for c in P] + [c[:, :1] for c in Q]
    mask = torch.from_numpy(batch["sign"])[:1]
    coords, (m,) = pj._laid_out(views, [mask])
    assert all(c.shape == (24, N // 2) and c.is_contiguous() for c in coords)
    assert m.shape == (N // 2,) and m.is_contiguous()
    for c, v in zip(coords, views):
        assert torch.equal(c, v.expand(24, N // 2))
    got = cuda_g1.padd(tuple(coords[:3]), tuple(coords[3:]))
    want = jpj.proj_add(JF, tuple(jnp.asarray(c.numpy().astype(np.uint32))
                                  for c in coords[:3]),
                        tuple(jnp.asarray(c.numpy().astype(np.uint32))
                              for c in coords[3:]))
    _assert_same(got, want)
    # single points, as the Horner ladder passes them
    one, _ = pj._laid_out([c[:, 7] for c in P])
    assert all(c.shape == (24,) and c.is_contiguous() for c in one)


# -----------------------------------------------------------------------------
# GLV
# -----------------------------------------------------------------------------

def _edge_scalars():
    rng = random.Random(0xB15)
    r, lam = constants.FR_MODULUS, glv.GLV_LAMBDA
    vals = [rng.randrange(r) for _ in range(N - 6)]
    # decomposition edge scalars: 0, 1, lambda +- 1, r-1, lambda
    return vals + [0, 1, lam - 1, lam + 1, r - 1, lam]


def test_glv_constants_match_jax():
    assert glv.GLV_LAMBDA == jglv.GLV_LAMBDA
    assert glv.GLV_BARRETT_M == jglv.GLV_BARRETT_M
    assert glv.GLV_HALF_BITS == jglv.GLV_HALF_BITS
    assert glv.beta() == jglv.beta()


def test_glv_decompose_matches_jax_and_recombines():
    vals = _edge_scalars()
    k = ints_to_limbs(vals, FR.num_limbs)
    jk1, jk2 = jglv.decompose(jnp.asarray(k))
    k1, k2 = glv.decompose(convert.scalars_from_numpy(k, device="cpu"))
    np.testing.assert_array_equal(convert.to_numpy(k1), np.asarray(jk1))
    np.testing.assert_array_equal(convert.to_numpy(k2), np.asarray(jk2))
    a = limbs_to_ints(convert.to_numpy(k1))
    b = limbs_to_ints(convert.to_numpy(k2))
    for v, x, y in zip(vals, a, b):
        assert x + y * glv.GLV_LAMBDA == v
        assert (x + y * glv.GLV_LAMBDA) % constants.FR_MODULUS == v
        assert x < (1 << 128) and y < (1 << 128)


def test_glv_limb_helpers_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << 16, size=(16, 40), dtype=np.uint32)
    b = rng.integers(0, 1 << 16, size=(17, 40), dtype=np.uint32)
    ta, tb = torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32))
    np.testing.assert_array_equal(
        glv._limb_mul(ta, tb, 16, 17).numpy(),
        np.asarray(jglv._limb_mul(jnp.asarray(a), jnp.asarray(b), 16, 17)))
    d, borrow = glv._limb_sub(ta, tb[:16])
    jd, jborrow = jglv._limb_sub(jnp.asarray(a), jnp.asarray(b[:16]))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(borrow.numpy(), np.asarray(jborrow))
    a[:3, 0] = 0xFFFF                       # a carry that ripples
    flag = np.arange(40) % 2 == 0
    np.testing.assert_array_equal(
        glv._limb_inc_where(torch.from_numpy(a.astype(np.int32)),
                            torch.from_numpy(flag)).numpy(),
        np.asarray(jglv._limb_inc_where(jnp.asarray(a), jnp.asarray(flag))))


def test_endomorphism_matches_jax_and_is_lambda_times_p(batch):
    got = glv.endomorphism(F, _aff(batch["B"]))
    want = jglv.endomorphism(JF, _j(batch["B"]))
    _assert_same(got, want)
    phi = g1.affine_to_ints(got)
    for p, q in list(zip(batch["pts"][7:], phi))[4:8]:
        lam_p = oracle.jac_to_affine(
            oracle.scalar_mul(glv.GLV_LAMBDA, p, oracle.FQ_OPS), oracle.FQ_OPS)
        assert q == lam_p


# -----------------------------------------------------------------------------
# The adapters' doubling and negation: values and routes
# -----------------------------------------------------------------------------

def _fq_edge_values(n, seed):
    rng = random.Random(seed)
    p = constants.FQ_MODULUS
    vals = [0, 1, p - 1, (p - 1) // 2, (p + 1) // 2] + [rng.randrange(p) for _ in range(n)]
    return ints_to_limbs(vals[:n], 24).astype(np.uint32)


@pytest.mark.parametrize("field", ["fq", "fq2"])
@pytest.mark.parametrize("adapter", ["routed", "plain"])
def test_adapter_double_neg_and_fq2_forms_match_jax(field, adapter):
    """``double`` and ``neg`` of the Fq and Fq2 adapters (the routed one and
    the plain one), and the Fq2 square and inverse that call them, equal the
    JAX package's adapters limb for limb: 0 stays 0, sums past p wrap."""
    from tpu_bls12_381.curves.field_adapters import FQ2_ADAPTER as JF2
    from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ2_PLAIN

    a0, a1 = _fq_edge_values(16, 31), _fq_edge_values(16, 32)[:, ::-1].copy()
    if field == "fq":
        Fp = F if adapter == "routed" else FQ_PLAIN
        ta = convert.field_from_numpy(a0, FQ, device="cpu")
        for op in ("double", "neg"):
            np.testing.assert_array_equal(convert.to_numpy(getattr(Fp, op)(ta)),
                                          np.asarray(getattr(JF, op)(jnp.asarray(a0))))
        return
    Fp = FQ2_ADAPTER if adapter == "routed" else FQ2_PLAIN
    ta = convert.fq2_from_numpy((a0, a1), device="cpu")
    ja = (jnp.asarray(a0), jnp.asarray(a1))
    for op in ("double", "neg", "sqr", "inv"):
        got = convert.fq2_to_numpy(getattr(Fp, op)(ta))
        want = getattr(JF2, op)(ja)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=op)


def test_adapter_doubling_and_negation_reach_the_kernel_wrappers(monkeypatch):
    """``FQ_ADAPTER.double`` / ``neg`` (and through them the Fq2 square and
    inverse, and the generic doubling's formulas) call the kernel wrappers
    ``cuda_ops.double`` / ``neg``, which launch on a CUDA tensor; the plain
    adapters ``FQ_PLAIN`` / ``FQ2_PLAIN``, which the kernels' plain versions
    are written against, call no wrapper at all."""
    from tpu_bls12_381_torch.curves import points as pt
    from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ2_PLAIN
    from tpu_bls12_381_torch.fields import cuda_ops

    calls = []
    for name in ("add", "sub", "double", "neg", "mont_mul", "mont_sqr", "field_inv"):
        fn = getattr(cuda_ops, name)
        monkeypatch.setattr(cuda_ops, name, lambda *args, f_=fn, n_=name: (
            calls.append(n_), f_(*args))[1])
    a = convert.field_from_numpy(_fq_edge_values(8, 33), FQ, device="cpu")
    a2 = torch.stack([a, a.flip(1)], dim=1)
    F.double(a)
    F.neg(a)
    assert calls == ["double", "neg"]
    calls.clear()
    FQ2_ADAPTER.sqr(a2)
    assert calls.count("double") == 1
    calls.clear()
    FQ2_ADAPTER.inv(a2)
    assert calls.count("neg") == 1
    calls.clear()
    P = pt.affine_to_jac(F, (a, a.flip(1), torch.zeros(8, dtype=torch.bool)))
    pt.jac_double(F, P)
    assert calls.count("double") == 7 and "neg" not in calls
    calls.clear()
    for Fp, x in ((FQ_PLAIN, a), (FQ2_PLAIN, a2)):
        for op in ("double", "neg", "sqr", "inv"):
            getattr(Fp, op)(x)
        Fp.mul(x, x)
        Fp.add(x, x)
        Fp.sub(x, x)
    pt.jac_double(FQ_PLAIN, P)
    assert calls == []
