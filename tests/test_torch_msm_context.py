"""The cached-bases MSM path of the PyTorch/CUDA port (``MsmContext``:
precomputed bases, chunking, the shared-bases batch) on the CPU: its
configuration and plan against the JAX package's, and every call and chunk
path against the host oracle (affine integers), which the JAX package's own
tests use as well.  What is exact against the JAX package (``expand_bases``,
the digit regrouping, its cached bases carried into the port and back, one JAX
context call) is in ``tests/test_torch_msm_bases.py``; the two files run side
by side.  A port MSM costs seconds per window on the CPU whatever N is, so the
cases use GLV and a precompute factor of 8: two windows an MSM.
"""

import random

import pytest
import torch

from tpu_bls12_381 import oracle
from tpu_bls12_381.fields.limbs import ints_to_limbs
from tpu_bls12_381.msm import pippenger as jpip
from tpu_bls12_381.runtime.config import Config as JConfig

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import g1, g2, glv
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER as F2, FQ_ADAPTER as F1
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.msm import msm_geometry, pippenger as pip
from tpu_bls12_381_torch.runtime import (AsyncHandle, MsmContext, config, g1_context,
                                         g2_context, reset_config_cache)

N = 64

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)
R_MOD = constants.FR_MODULUS
W = 9           # window bits of the port's cases: 15 windows of 128-bit halves
FACTOR = 8      # precompute factor of the shared bases: ceil(15 / 8) = 2 windows
W_G2 = 5        # the G2 case's window: 52 windows of 255 bits, 13 at factor 4, of
                # 16 buckets each: cheaper on the CPU than 9 bits' 8 of 256


def _scalars_mont(vals):
    return ints_to_limbs([FR.to_mont(v) for v in vals], 16)


def _sc(vals):
    return convert.scalars_from_numpy(_scalars_mont(vals), device="cpu")


def _oracle_msm(vals, pts):
    return oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS), oracle.FQ_OPS)


def _g1(P):
    return g1.jacobian_to_ints(P)[0]


@pytest.fixture(scope="module")
def data():
    """N host points (two of them the identity), four scalar sets with the GLV
    edge scalars, their oracle MSMs, and the port's cached bases (factor 8,
    GLV, W-bit windows: 2 windows an MSM) that most cases share."""
    rng = random.Random(0xC7)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 40), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(N)]
    pts[7] = pts[40] = None
    lam = glv.GLV_LAMBDA
    sets = [[rng.randrange(R_MOD) for _ in range(N)] for _ in range(4)]
    sets[0][:6] = [0, 1, lam - 1, lam + 1, R_MOD - 1, lam]
    want = [_oracle_msm(v, pts) for v in sets]
    A = g1.affine_from_ints(pts, device="cpu")
    ctx = g1_context()
    bases = ctx.upload_bases(A, precompute_factor=FACTOR, window_bits=W, glv=True)
    return {"pts": pts, "sets": sets, "want": want, "A": A, "ctx": ctx,
            "bases": bases}


# -----------------------------------------------------------------------------
# Configuration and the plan
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("env,factor,window", [
    ({}, 1, None),
    ({"MIDNIGHT_TPU_PRECOMPUTE": "4"}, 4, None),
    ({"MIDNIGHT_GPU_PRECOMPUTE": "2"}, 2, None),
    ({"MIDNIGHT_TPU_PRECOMPUTE": "3", "MIDNIGHT_GPU_PRECOMPUTE": "2"}, 3, None),
    ({"MIDNIGHT_TPU_PRECOMPUTE": "99"}, 8, None),
    ({"MIDNIGHT_TPU_PRECOMPUTE": "zero"}, 1, None),
    ({"MIDNIGHT_MSM_WINDOW": "13"}, 1, 13),
    ({"MIDNIGHT_MSM_WINDOW": "0"}, 1, None),
    ({"MIDNIGHT_MSM_WINDOW": "40"}, 1, 24),
])
def test_config_variables_match_jax(env, factor, window, monkeypatch):
    for k in ("MIDNIGHT_TPU_PRECOMPUTE", "MIDNIGHT_GPU_PRECOMPUTE",
              "MIDNIGHT_MSM_WINDOW"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    reset_config_cache()
    try:
        cfg, jcfg = config(), JConfig.from_env()
        assert (cfg.precompute_factor, cfg.msm_window) == (factor, window)
        assert (cfg.precompute_factor, cfg.msm_window) == (
            jcfg.precompute_factor, jcfg.msm_window)
    finally:
        for k in env:
            monkeypatch.delenv(k)
        reset_config_cache()


def test_budget_variable_is_an_upper_limit(monkeypatch):
    monkeypatch.delenv("MIDNIGHT_MSM_HBM_BUDGET_MB", raising=False)
    assert pip._budget_limit_bytes() is None
    assert pip._available_budget("cpu") == pip._CPU_BUDGET_BYTES
    monkeypatch.setenv("MIDNIGHT_MSM_HBM_BUDGET_MB", "3")
    assert pip._available_budget("cpu") == 3 << 20
    bpp = pip._msm_bytes_per_point(F1)
    geo = msm_geometry(1 << 14, glv=False, device="cpu")
    assert geo["budget_bytes"] == 3 << 20
    assert geo["pieces"] == 8 and geo["per"] == 1 << 11   # 7 needed, 8 divides
    assert pip._split_points(1 << 14, 3 << 20, bpp) == 7
    # GLV auto follows it: the doubled set of 2^10 points fits 3 MiB, 2^11 not
    assert msm_geometry(1 << 10, device="cpu")["glv"]
    assert not msm_geometry(1 << 11, device="cpu")["glv"]
    for bad in ("0", "-5"):
        monkeypatch.setenv("MIDNIGHT_MSM_HBM_BUDGET_MB", bad)
        with pytest.raises(ValueError):
            pip._available_budget("cpu")


@pytest.mark.parametrize("w,factor,bits", [(16, 2, 128), (13, 2, 255), (9, 2, 128),
                                           (9, 4, 255), (15, 1, 255), (7, 8, 128)])
def test_window_counts_match_jax(w, factor, bits):
    assert pip.num_windows(w, bits) == jpip.num_windows(w, bits)
    assert pip.precompute_window_span(w, factor, bits) == \
        jpip.precompute_window_span(w, factor, bits)


def test_geometry_of_the_cached_bases_path(monkeypatch):
    # the upload's own plan at 2^20 points, factor 2, on a roomy budget:
    # GLV on, 2^22 pipeline points, w = 16, 5 windows, tile 128 x 2^15
    geo = msm_geometry(1 << 20, F=F1, device="cpu", factor=2, cached=True)
    assert (geo["glv"], geo["n"], geo["w"], geo["T"], geo["R"], geo["L"]) == (
        True, 1 << 22, 16, 5, 128, 1 << 15)
    assert (geo["pieces"], geo["groups"], geo["scan_launches"]) == (1, 1, 5)
    # G2 never takes GLV; factor 2 halves its 20 windows
    geo2 = msm_geometry(1 << 19, F=F2, device="cpu", factor=2, cached=True)
    assert (geo2["glv"], geo2["n"], geo2["w"], geo2["T"]) == (False, 1 << 20, 14, 10)
    # MIDNIGHT_MSM_WINDOW is the upload's window where none is given
    monkeypatch.setenv("MIDNIGHT_MSM_WINDOW", "11")
    reset_config_cache()
    try:
        assert msm_geometry(N, F=F1, device="cpu", factor=2, cached=True)["w"] == 11
        assert msm_geometry(N, F=F1, device="cpu", window_bits=8, factor=2,
                            cached=True)["w"] == 8
    finally:
        monkeypatch.delenv("MIDNIGHT_MSM_WINDOW")
        reset_config_cache()
    with pytest.raises(ValueError):
        msm_geometry(N, device="cpu", factor=2)
    # the batch: groups by members, then pieces by points (the JAX rule)
    C, Wd = 24, 48
    n_eff = 4 * N                                  # factor 2, GLV
    kw = dict(glv=True, F=F1, device="cpu", window_bits=W, factor=2, cached=True)
    roomy = msm_geometry(N, batch=4, **kw)
    assert (roomy["pieces"], roomy["groups"], roomy["per_group"], roomy["T"]) == (1, 1, 4, 8)
    monkeypatch.setattr(pip, "_available_budget",
                        lambda device: 4 * Wd * n_eff + 2 * 4 * (Wd + 5 * C) * n_eff)
    by_members = msm_geometry(N, batch=4, **kw)
    assert (by_members["pieces"], by_members["groups"], by_members["per_group"]) == (1, 2, 2)
    assert by_members["scan_launches"] == 16
    monkeypatch.setattr(pip, "_available_budget",
                        lambda device: (4 * Wd * n_eff + 4 * (Wd + 5 * C) * n_eff) // 2)
    by_points = msm_geometry(N, batch=4, **kw)
    assert (by_points["pieces"], by_points["per"], by_points["n"]) == (4, 32, 64)
    assert by_points["scan_launches"] == 8 * 4 * by_points["groups"]


# -----------------------------------------------------------------------------
# The context's calls against the oracle
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["msm_with_bases", "msm_with_bases_async",
                                  "msm_batch_of_1", "msm_batch_of_4",
                                  "msm_batch_async", "msm"])
def test_context_calls_match_the_oracle(data, call, monkeypatch):
    ctx, bases, sets, want = data["ctx"], data["bases"], data["sets"], data["want"]
    assert (bases.n, bases.factor, bases.window_bits, bases.glv) == (N, FACTOR, W, True)
    assert bases.A[2].shape == (2 * FACTOR * N,)
    if call == "msm_with_bases":
        assert _g1(ctx.msm_with_bases(_sc(sets[1]), bases)) == want[1]
    elif call == "msm_with_bases_async":
        h = ctx.msm_with_bases_async(_sc(sets[2]), bases)
        assert isinstance(h, AsyncHandle) and h.is_ready()
        assert _g1(h.wait()) == want[2]
    elif call == "msm_batch_of_1":
        outs = ctx.msm_batch([_sc(sets[3])], bases)
        assert len(outs) == 1 and _g1(outs[0]) == want[3]
    elif call == "msm_batch_of_4":
        outs = ctx.msm_batch([_sc(v) for v in sets], bases)
        assert all(tuple(c.shape) == (24,) for P in outs for c in P)
        assert [_g1(P) for P in outs] == want
    elif call == "msm_batch_async":
        h = ctx.msm_batch_async([_sc(sets[0]), _sc(sets[3])], bases)
        assert [_g1(P) for P in h.wait()] == [want[0], want[3]]
    else:
        # ad-hoc bases: the context hands them to ``pippenger.msm`` (which
        # tests/test_torch_msm_cases.py holds against the oracle) with
        # MIDNIGHT_MSM_WINDOW as the window where the caller names none
        seen = []

        def fake_msm(F, scalars, A, **kw):
            seen.append((F, A, kw))
            return A

        monkeypatch.setattr(pip, "msm", fake_msm)
        monkeypatch.setenv("MIDNIGHT_MSM_WINDOW", "11")
        reset_config_cache()
        try:
            assert ctx.msm(_sc(sets[1]), data["A"]) is data["A"]
            h = ctx.msm_async(_sc(sets[1]), data["A"], window_bits=7,
                              scalars_montgomery=False)
            assert isinstance(h, AsyncHandle) and h.wait() is data["A"]
        finally:
            monkeypatch.delenv("MIDNIGHT_MSM_WINDOW")
            reset_config_cache()
        assert [(F, kw["window_bits"], kw["scalars_montgomery"])
                for F, _, kw in seen] == [(F1, 11, True), (F1, 7, False)]
        aff = ctx.to_affine(tuple(c[..., :2] for c in
                                  pj_affine_to_jac(data["A"])))
        assert g1.affine_to_ints(aff) == data["pts"][:2]


def pj_affine_to_jac(A):
    """(x, y, inf) -> the Jacobian point (x, y, 1) of finite points."""
    from tpu_bls12_381_torch.curves import projective as pj

    return pj.proj_to_jac(F1, pj.affine_to_proj(F1, A))


@pytest.mark.parametrize("path", ["precomputed_pieces", "batch_member_groups",
                                  "batch_point_pieces"])
def test_chunk_paths_equal_the_one_shot_result(data, path, monkeypatch):
    """Every chunk path under a small budget returns what the one-shot call
    returns (which the case above holds against the oracle)."""
    ctx, bases, sets, want = data["ctx"], data["bases"], data["sets"], data["want"]
    C, Wd, n_eff = 24, 48, 2 * FACTOR * N
    bpp = pip._msm_bytes_per_point(F1)
    kw = dict(glv=True, F=F1, device="cpu", window_bits=W, factor=FACTOR, cached=True)
    if path == "precomputed_pieces":
        monkeypatch.setattr(pip, "_available_budget", lambda device: n_eff * bpp // 2)
        geo = msm_geometry(N, **kw)
        assert (geo["pieces"], geo["T"], geo["scan_launches"]) == (2, 2, 4)
        assert _g1(ctx.msm_with_bases(_sc(sets[0]), bases)) == want[0]
    elif path == "batch_member_groups":
        monkeypatch.setattr(
            pip, "_available_budget",
            lambda device: 4 * Wd * n_eff + 2 * 4 * (Wd + 5 * C) * n_eff)
        geo = msm_geometry(N, batch=3, **kw)
        assert (geo["pieces"], geo["groups"], geo["per_group"]) == (1, 2, 2)
        outs = ctx.msm_batch([_sc(v) for v in sets[:3]], bases)
        assert [_g1(P) for P in outs] == want[:3]
    else:
        monkeypatch.setattr(
            pip, "_available_budget",
            lambda device: 4 * Wd * n_eff + 4 * (Wd + 5 * C) * n_eff - 1)
        geo = msm_geometry(N, batch=2, **kw)
        assert (geo["pieces"], geo["per"], geo["groups"]) == (4, 32, 1)
        outs = ctx.msm_batch([_sc(sets[2]), _sc(sets[1])], bases)
        assert [_g1(P) for P in outs] == [want[2], want[1]]


def test_factor_1_without_glv_is_the_plain_msm(data, monkeypatch):
    """``upload_bases`` with factor 1 and no GLV keeps the caller's tensors, and
    ``msm_with_bases`` against them is ``msm`` with GLV off."""
    ctx = data["ctx"]
    plain = ctx.upload_bases(data["A"], precompute_factor=1, window_bits=W,
                             glv=False)
    assert plain.A[0] is data["A"][0] and not plain.is_precomputed
    assert (plain.factor, plain.glv, plain.window_bits) == (1, False, W)
    seen = {}

    def fake_msm(F, scalars, A, **kw):
        seen.update(kw, F=F, A=A)
        return "sentinel"

    monkeypatch.setattr(pip, "msm", fake_msm)
    assert ctx.msm_with_bases(_sc(data["sets"][3]), plain) == "sentinel"
    assert seen["F"] is F1 and seen["A"] is plain.A
    assert (seen["glv"], seen["window_bits"], seen["scalars_montgomery"]) == (
        False, W, True)


def test_msm_batch_checks_the_scalar_count(data):
    ctx, bases = data["ctx"], data["bases"]
    with pytest.raises(ValueError, match="scalar count"):
        ctx.msm_batch([_sc(data["sets"][0]), _sc(data["sets"][1][:N - 1])], bases)
    with pytest.raises(ValueError, match="scalar count"):
        ctx.msm_batch([_sc(data["sets"][0][:5])], bases)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_window_sums_add_up_across_chunks(data, curve):
    """``_r_ws_add`` adds stacked window sums point by point, T axis first, in
    either field's layout: what folds the pieces of a chunked MSM."""
    from tpu_bls12_381_torch.curves import projective as pj

    if curve == "g1":
        F, A = F1, data["A"]
    else:
        F, A = F2, g2.generator_affine((14,), device="cpu")
    P = pj.proj_double(F, pj.affine_to_proj(F, tuple(c[..., :6] for c in A)))
    Q = pj.affine_to_proj(F, tuple(c[..., 8:14] for c in A))
    stack = lambda T: tuple(c.movedim(-1, 0).contiguous() for c in T)   # (T, *elem)
    got = pip._r_ws_add(F, stack(P), stack(Q))
    want = pj.proj_add(F, P, Q)
    assert got[0].shape == (6,) + tuple(F.elem_shape)
    assert all(torch.equal(g, w.movedim(-1, 0)) for g, w in zip(got, want))
    # sliced bases keep every factor block's points [s, e)
    x = A[0][..., :12]
    sl = pip._slice_factor_blocks(x, 4, 1, 3, 3)
    assert torch.equal(sl, torch.cat([x[..., 1:3], x[..., 5:7], x[..., 9:11]], dim=-1))


@pytest.mark.parametrize("factor", [1, 4])
def test_warmup_runs_on_the_device_asked_for(factor, monkeypatch):
    """``warmup`` makes n generator points with scalar 1 on the device asked for
    and runs them through the path the factor selects; without a device it
    raises (no card here) and never carries on on the CPU."""
    ctx = g1_context()
    if factor == 1:
        seen = {}

        def fake_msm(F, scalars, A, **kw):
            seen.update(kw, n=A[2].shape[-1], device=A[2].device.type,
                        limb0=scalars[0].tolist())
            return A

        monkeypatch.setattr(pip, "msm", fake_msm)
        ctx.warmup(8, factor=1, window_bits=W, device="cpu")
        assert seen == {"window_bits": W, "scalars_montgomery": True, "n": 8,
                        "device": "cpu", "limb0": [1] * 8}
    else:
        ctx.warmup(8, factor=4, window_bits=W, device="cpu")    # runs the MSM
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctx.warmup(8, factor=factor)


def test_g2_context_is_the_same_class_over_fq2():
    rng = random.Random(0xC8)
    G = oracle.g2_generator()
    pts = [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 30), G, oracle.FQ2_OPS),
        oracle.FQ2_OPS) for _ in range(8)]
    pts[2] = None
    vals = [rng.randrange(R_MOD) for _ in range(6)] + [0, R_MOD - 1]
    want = oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ2_OPS), oracle.FQ2_OPS)
    ctx = g2_context()
    assert isinstance(ctx, MsmContext) and ctx.F is F2 and ctx.name == "g2"
    A = g2.affine_from_ints(pts, device="cpu")
    bases = ctx.upload_bases(A, precompute_factor=4, window_bits=W_G2, glv=True)
    assert not bases.glv and bases.A[0].shape == (24, 2, 32)    # G2: no GLV
    P = ctx.msm_with_bases(_sc(vals), bases)
    assert g2.jacobian_to_ints(tuple(c[..., None] for c in P))[0] == want
    aff = ctx.to_affine(tuple(c[..., None] for c in P))
    assert g2.affine_to_ints(aff)[0] == want
