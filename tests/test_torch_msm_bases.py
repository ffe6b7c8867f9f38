"""State carried across, and what is exact against the JAX package, on the
cached-bases MSM path of the PyTorch/CUDA port, on the CPU: ``expand_bases``
and the digit regrouping limb for limb (canonical field results; tolerance 0),
the JAX package's cached bases in the port's ``msm_with_bases`` and the port's
in the JAX package's, ``msm_batch`` of 2 against the JAX context's, and
``scalar_mul_glv``.  The JAX context runs one MSM and one batch, at N = 64
(an XLA:CPU compile of its staged MSM costs tens of seconds a shape); the
port's cached bases of the same points are made once for both.  The port's
own variants against the host oracle are in ``tests/test_torch_msm_context.py``;
the two files run side by side.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_bls12_381 import oracle
from tpu_bls12_381.curves import g1 as jg1, glv as jglv
from tpu_bls12_381.curves.field_adapters import FQ_ADAPTER as JF
from tpu_bls12_381.fields.limbs import ints_to_limbs
from tpu_bls12_381.msm import pippenger as jpip
from tpu_bls12_381.runtime.msm_context import (PrecomputedBases as JBases,
                                               g1_context as jax_g1_context)

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import g1, glv
from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER as F1
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.msm import pippenger as pip
from tpu_bls12_381_torch.runtime import PrecomputedBases, g1_context

N = 64

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)
R_MOD = constants.FR_MODULUS
W = 9           # window bits of the digit cases
FACTOR = 2      # the cached bases both packages carry across: GLV, factor 2


def _scalars_mont(vals):
    return ints_to_limbs([FR.to_mont(v) for v in vals], 16)


def _sc(vals):
    return convert.scalars_from_numpy(_scalars_mont(vals), device="cpu")


def _g1(P):
    return g1.jacobian_to_ints(P)[0]


@pytest.fixture(scope="module")
def data():
    """N host points (two of them the identity), two scalar sets with the GLV
    edge scalars, and the oracle MSM of the first."""
    rng = random.Random(0xC7)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 40), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(N)]
    pts[7] = pts[40] = None
    lam = glv.GLV_LAMBDA
    sets = [[rng.randrange(R_MOD) for _ in range(N)] for _ in range(2)]
    sets[0][:6] = [0, 1, lam - 1, lam + 1, R_MOD - 1, lam]
    want = [oracle.jac_to_affine(oracle.msm(sets[0], pts, oracle.FQ_OPS),
                                 oracle.FQ_OPS)]
    return {"pts": pts, "sets": sets, "want": want,
            "A": g1.affine_from_ints(pts, device="cpu"), "ctx": g1_context()}


# -----------------------------------------------------------------------------
# expand_bases and the digit regrouping: exact against the JAX package
# -----------------------------------------------------------------------------

def _jaffine(pts):
    return jg1.affine_from_ints(pts)


# Each case's JAX expansion has the shapes of a JAX expansion the file runs
# anyway, so each XLA:CPU compile serves two calls: 16 plain points are one
# of the sliced case's slices, and the N points with GLV are what the JAX
# context caches below (its default window is 7 bits at factor 2).
EXPAND_POINTS = {"plain": 16, "glv": N, "sliced": 32}


@pytest.mark.parametrize("case", ["plain", "glv", "sliced"])
def test_expand_bases_matches_jax_limb_for_limb(data, case, monkeypatch):
    pts = data["pts"][:EXPAND_POINTS[case]]
    jA, tA = _jaffine(pts), g1.affine_from_ints(pts, device="cpu")
    w, bits = 7, 255
    if case == "glv":
        jA, tA = jpip.glv_extend_bases(JF, jA), pip.glv_extend_bases(F1, tA)
        bits = 128
    if case == "sliced":
        monkeypatch.setenv("MIDNIGHT_EXPAND_CHUNK_LOG", "4")   # 16-point slices
    want = jpip.expand_bases(JF, jA, w, 2, bits)
    got = pip.expand_bases(F1, tA, w, 2, bits)
    assert got[2].shape == (2 * tA[2].shape[-1],)
    for g, w_ in zip(convert.point_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w_))
    if case == "sliced":
        monkeypatch.delenv("MIDNIGHT_EXPAND_CHUNK_LOG")
        whole = pip.expand_bases(F1, tA, w, 2, bits)
        assert all(torch.equal(a, b) for a, b in zip(got, whole))
    # block 1 holds 2^(w T') P: one lane against the host
    span = jpip.precompute_window_span(w, 2, bits) * w
    m = tA[2].shape[-1]
    lane = g1.affine_to_ints(tuple(c[..., m + 3:m + 4] for c in got))[0]
    assert lane == oracle.jac_to_affine(
        oracle.scalar_mul(1 << span, pts[3], oracle.FQ_OPS), oracle.FQ_OPS)
    assert pip.expand_bases(F1, tA, w, 1, bits) is tA


@pytest.mark.parametrize("factor,bits", [(2, 255), (2, 128), (3, 255), (4, 128)])
def test_digit_regrouping_and_block_slices_match_jax(data, factor, bits):
    vals = [v >> (255 - bits) for v in data["sets"][1]]
    std = ints_to_limbs(vals, 16)
    ja, js = jpip._digits_for_precompute(jnp.asarray(std), W, factor, bits)
    ta, ts = pip._digits_for_precompute(
        convert.scalars_from_numpy(std, device="cpu"), W, factor, bits)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja).astype(np.int64))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the batched regrouping is the unbatched one per member
    both = torch.stack([convert.scalars_from_numpy(std, device="cpu"),
                        convert.scalars_from_numpy(np.roll(std, 3, axis=1), "cpu")], dim=1)
    ba, bs = pip._digits_for_precompute(both, W, factor, bits)
    assert ba.shape == (ta.shape[0], 2, factor * N)
    assert torch.equal(ba[:, 0], ta) and torch.equal(bs[:, 0], ts)
    # slicing every factor block alike
    arr = np.arange(24 * factor * N, dtype=np.uint32).reshape(24, factor * N)
    got = pip._slice_factor_blocks(torch.from_numpy(arr.astype(np.int64)), N, 5, 21, factor)
    want = jpip._slice_factor_blocks(jnp.asarray(arr), N, 5, 21, factor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -----------------------------------------------------------------------------
# State carried across: the JAX package's cached bases in the port, and back
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(data):
    """The JAX package's context and its cached bases of the N points
    (factor 2, GLV, its default window)."""
    jctx = jax_g1_context()
    return jctx, jctx.upload_bases(_jaffine(data["pts"]), precompute_factor=FACTOR,
                                   glv=True)


@pytest.fixture(scope="module")
def port_bases(data):
    """The port's cached bases of the same points, as the JAX side's."""
    return data["ctx"].upload_bases(data["A"], precompute_factor=FACTOR, glv=True)


def test_jax_bases_run_in_the_port_and_the_ports_in_jax(data, jax_side, port_bases):
    """One JAX context call at N = 64 (factor 2, GLV, its default window):
    the expanded bases equal limb for limb, the JAX package's bases serve the
    port's ``msm_with_bases``, and both packages return the oracle's point."""
    pts, vals, want = data["pts"], data["sets"][0], data["want"][0]
    jctx, jb = jax_side
    assert (jb.n, jb.factor, jb.glv) == (N, FACTOR, True)
    ctx, tb = data["ctx"], port_bases
    assert (tb.n, tb.factor, tb.glv, tb.window_bits) == (N, FACTOR, True, jb.window_bits)
    assert tb.is_precomputed
    A_np, n, factor, w, use_glv = convert.precomputed_bases_to_numpy(tb)
    for g, w_ in zip(A_np, jb.A):
        np.testing.assert_array_equal(g, np.asarray(w_))
    # the JAX package's buffer, with its metadata, into the port
    carried = convert.precomputed_bases_from_numpy(
        tuple(np.asarray(c) for c in jb.A), jb.n, jb.factor, jb.window_bits,
        jb.glv, device="cpu")
    assert isinstance(carried, PrecomputedBases)
    assert _g1(ctx.msm_with_bases(_sc(vals), carried)) == want
    # and the port's buffer into the JAX package
    back = JBases(A=tuple(jnp.asarray(c) for c in A_np), n=n, factor=factor,
                  window_bits=w, glv=use_glv)
    jP = jctx.msm_with_bases(jnp.asarray(_scalars_mont(vals)), back)
    assert jg1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda v: v[..., None], jP))[0] == want
    with pytest.raises(ValueError):
        convert.precomputed_bases_from_numpy(
            tuple(np.asarray(c) for c in jb.A), jb.n, 1, jb.window_bits, jb.glv,
            device="cpu")


def test_msm_batch_of_2_matches_the_jax_context(data, jax_side, port_bases):
    """One JAX ``ctx.msm_batch`` call, B = 2 at N = 64, against the port's on
    the same numpy scalars and the same bases, as affine integers; the first
    member also against the oracle."""
    jctx, jb = jax_side
    sets = data["sets"]
    jout = jctx.msm_batch([jnp.asarray(_scalars_mont(v)) for v in sets], jb)
    want = [jg1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda v: v[..., None], P))[0] for P in jout]
    got = [_g1(P) for P in data["ctx"].msm_batch([_sc(v) for v in sets], port_bases)]
    assert got == want
    assert got[0] == data["want"][0]


# -----------------------------------------------------------------------------
# scalar_mul_glv: the one caller of the mixed add without a sign
# -----------------------------------------------------------------------------

def test_scalar_mul_glv_matches_jax_and_the_oracle(data):
    pts = data["pts"][4:12]                      # lane 3 is the identity
    vals = data["sets"][0][:6] + [data["sets"][1][0], 2]
    std = ints_to_limbs(vals, 16)
    got = glv.scalar_mul_glv(convert.scalars_from_numpy(std, device="cpu"),
                             g1.affine_from_ints(pts, device="cpu"))
    want = jglv.scalar_mul_glv(jnp.asarray(std), _jaffine(pts))
    # the same steps on the same formulas: the Jacobian limbs are equal
    for g, w_ in zip(convert.point_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w_))
    host = [None if (p is None or v == 0) else oracle.jac_to_affine(
        oracle.scalar_mul(v, p, oracle.FQ_OPS), oracle.FQ_OPS)
        for v, p in zip(vals, pts)]
    assert g1.jacobian_to_ints(got) == host


def test_scalar_mul_glv_through_the_ladder_route(data, monkeypatch):
    """With ``glv_ladder_kernel`` forced on the CPU, ``scalar_mul_glv`` makes
    one ladder call, with k1 (16, N), k2 (9, N), x, y, beta x contiguous
    (24, N) planes and a contiguous (N,) mask (what ``cuda_g1.glv_ladder``
    checks; on the CPU it takes ``glv_ladder_plain``), and its result is the
    oracle's."""
    from tpu_bls12_381_torch.curves import cuda_g1

    calls = []

    def ladder(k1, k2, A, phi_x, num_bits):
        calls.append((k1, k2, A, phi_x, num_bits))
        return cuda_g1.glv_ladder(k1, k2, A, phi_x, num_bits)

    monkeypatch.setattr(glv, "glv_ladder_kernel", lambda F, device: ladder)
    pts = data["pts"][4:12]                      # lane 3 is the identity
    vals = data["sets"][0][:6] + [data["sets"][1][0], 2]
    got = glv.scalar_mul_glv(convert.scalars_from_numpy(ints_to_limbs(vals, 16), device="cpu"),
                             g1.affine_from_ints(pts, device="cpu"))
    assert len(calls) == 1
    k1, k2, (x, y, inf), phi_x, num_bits = calls[0]
    assert num_bits == glv.GLV_HALF_BITS
    assert (tuple(k1.shape), tuple(k2.shape)) == ((16, 8), (9, 8))
    assert all(tuple(t.shape) == (24, 8) for t in (x, y, phi_x))
    assert tuple(inf.shape) == (8,) and inf.dtype == torch.bool
    assert all(t.is_contiguous() for t in (k1, k2, x, y, phi_x, inf))
    host = [None if (p is None or v == 0) else oracle.jac_to_affine(
        oracle.scalar_mul(v, p, oracle.FQ_OPS), oracle.FQ_OPS)
        for v, p in zip(vals, pts)]
    assert g1.jacobian_to_ints(got) == host
