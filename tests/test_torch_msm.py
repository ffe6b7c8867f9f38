"""Single-shot G1 Pippenger MSM of the PyTorch/CUDA port, on the CPU.

The slice as a whole: the same scalars and points, made from a seed on the
host, go through the JAX package's ``msm_g1`` (one call with default
arguments) and through ``tpu_bls12_381_torch.msm.msm_g1`` on CPU tensors,
where every kernel wrapper takes its plain version.  MSM results are compared
as affine integers: the sort's tie order may differ, which moves points
between slots and changes Z, never the point.  The window keys and the tuning
heuristics are compared exactly.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_bls12_381 import oracle
from tpu_bls12_381.curves import g1 as jg1
from tpu_bls12_381.msm import msm_g1 as jax_msm_g1, pippenger as jpip

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import g1
from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER
from tpu_bls12_381_torch.curves.glv import GLV_LAMBDA
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
from tpu_bls12_381_torch.msm import msm_g1, msm_geometry, pippenger as pip

N = 64
R_MOD = constants.FR_MODULUS
VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


@pytest.fixture(autouse=True)
def _one_thread():
    # tiny tensors: intra-op threads only add overhead next to other workers
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _host_points(n, seed=0xB15):
    rng = random.Random(seed)
    G = oracle.g1_generator()
    return [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 48), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(n)]


@pytest.fixture(scope="module")
def points():
    return _host_points(N)


def _scalars_np(vals):
    """Montgomery-form (16, n) uint32 limbs, as the JAX package takes them."""
    return ints_to_limbs([FR.to_mont(v % R_MOD) for v in vals], FR.num_limbs)


def _port_msm(vals, pts, **kw):
    A = g1.affine_from_ints(pts, device="cpu")
    sc = convert.scalars_from_numpy(_scalars_np(vals), device="cpu")
    P = msm_g1(sc, A, **kw)
    assert all(tuple(c.shape) == (24,) and c.dtype == torch.int32 for c in P)
    return g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]


def _oracle_msm(vals, pts):
    return oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS),
                                oracle.FQ_OPS)


# -----------------------------------------------------------------------------
# Heuristics and keys: exact against the JAX package
# -----------------------------------------------------------------------------

def test_heuristics_match_jax():
    for n in (1, 2, 16, 64, 128, 1000, 1 << 12, 1 << 16, 1 << 20, 1 << 21,
              1 << 22, 1 << 24):
        assert pip.window_bits_for(n, FQ_ADAPTER, device="cpu") == \
            jpip.window_bits_for(n, jpip.FQ_ADAPTER)
        assert pip.lane_tile_for(n, FQ_ADAPTER, device="cpu") == \
            jpip.lane_tile_for(n, jpip.FQ_ADAPTER)
    for w in range(4, 17):
        assert pip.triangle_lb(1 << (w - 1)) == jpip.triangle_lb(1 << (w - 1))
        for bits in (255, 128):
            assert pip.num_windows(w, bits) == jpip.num_windows(w, bits)
    assert pip.window_bits_for(0) == 4
    # the main path's shapes: 2^20 points, GLV on
    geo = msm_geometry(1 << 20, True, device="cpu")
    assert (geo["n"], geo["w"], geo["T"], geo["nb"]) == (1 << 21, 15, 9, 1 << 14)
    assert geo["L"] * geo["R"] == 1 << 21


@pytest.mark.parametrize("num_bits", [255, 128])
@pytest.mark.parametrize("w", [6, 9, 15])
def test_window_keys_match_jax(w, num_bits):
    rng = random.Random(w * 1000 + num_bits)
    top = R_MOD if num_bits == 255 else 1 << 128
    vals = [rng.randrange(top) for _ in range(N - 6)]
    vals += [0, 1, top - 1, GLV_LAMBDA - 1, (1 << (w - 1)), (1 << w) - 1]
    k = ints_to_limbs(vals, FR.num_limbs)
    want = np.asarray(jpip.decompose_window_keys(jnp.asarray(k), w, num_bits))
    got = pip.decompose_window_keys(
        convert.scalars_from_numpy(k, device="cpu"), w, num_bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.shape[0] == pip.num_windows(w, num_bits)
    # the digits recombine to the scalar
    d, s = pip.decompose_signed_digits(
        convert.scalars_from_numpy(k, device="cpu"), w, num_bits)
    for j, v in enumerate(vals):
        acc = sum((-int(d[t, j]) if bool(s[t, j]) else int(d[t, j])) << (w * t)
                  for t in range(d.shape[0]))
        assert acc == v


def test_sort_tile_matches_jax(points):
    """The sort + gather + tiling stage, slot for slot (both sorts are
    stable), pad slots and identity points included."""
    n, R, L = 56, 8, 8                      # 8 pad slots
    rng = random.Random(3)
    pts = [None if i % 9 == 0 else p for i, p in enumerate(points[:n])]
    vals = [0 if i % 7 == 0 else rng.randrange(R_MOD) for i in range(n)]
    k = ints_to_limbs(vals, FR.num_limbs)
    jA = jg1.affine_from_ints(pts)
    jkeys = jpip.decompose_window_keys(jnp.asarray(k), 6)
    jem = jpip._stage_pack_rows(jpip.FQ_ADAPTER, jA[0], jA[1])
    want = jpip._stage_sort_tile(jpip.FQ_ADAPTER, jkeys[2], R, L, jem, jA[2])
    A = g1.affine_from_ints(pts, device="cpu")
    keys = pip.decompose_window_keys(
        convert.scalars_from_numpy(k, device="cpu"), 6)
    em = pip._stage_pack_rows(FQ_ADAPTER, A[0], A[1])
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem)[:, :48])
    got = pip._stage_sort_tile(FQ_ADAPTER, keys[2], R, L, em, A[2])
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w_).astype(np.int64))


def test_glv_split_and_extend_match_jax(points):
    rng = random.Random(4)
    vals = [rng.randrange(R_MOD) for _ in range(16)]
    k = ints_to_limbs(vals, FR.num_limbs)
    jk, jbits = jpip.glv_split_scalars(jnp.asarray(k))
    gk, bits = pip.glv_split_scalars(convert.scalars_from_numpy(k, device="cpu"))
    assert bits == jbits == 128
    np.testing.assert_array_equal(convert.to_numpy(gk), np.asarray(jk))
    jA = jg1.affine_from_ints(points[:16])
    A = g1.affine_from_ints(points[:16], device="cpu")
    for g, w_ in zip(pip.glv_extend_bases(FQ_ADAPTER, A),
                     jpip.glv_extend_bases(jpip.FQ_ADAPTER, jA)):
        np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(w_))


# -----------------------------------------------------------------------------
# The slice as a whole
# -----------------------------------------------------------------------------

def test_msm_matches_jax_msm_and_oracle(points):
    """One JAX ``msm_g1`` call with default arguments against the port on the
    same numpy inputs, both against the big-int oracle, as affine ints."""
    rng = random.Random(0xB15)
    vals = [rng.randrange(R_MOD) for _ in range(N)]
    sc_np = _scalars_np(vals)
    jA = jg1.affine_from_ints(points)
    A_np = tuple(np.asarray(c) for c in jA)
    jP = jax_msm_g1(jnp.asarray(sc_np), jA)
    want = jg1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], jP))[0]

    P = msm_g1(convert.scalars_from_numpy(sc_np, device="cpu"),
               convert.affine_from_numpy(*A_np, device="cpu"))
    got = g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]
    assert got == want
    assert got == _oracle_msm(vals, points)


CASES = {
    "glv_on_window_6": dict(kw=dict(glv=True, window_bits=6)),
    # 255-bit windows: the r-1 edge scalar takes the signed-digit top carry
    "glv_off_window_9": dict(kw=dict(glv=False, window_bits=9)),
    "all_zero_scalars": dict(kw=dict(glv=True, window_bits=9), zeros=True),
    "identity_points": dict(kw=dict(glv=True, window_bits=9), holes=True),
    "scalar_r_minus_1": dict(kw=dict(glv=True, window_bits=9), rm1=True),
    "standard_form_window_9": dict(
        kw=dict(glv=True, window_bits=9, scalars_montgomery=False)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_msm_matches_oracle(points, case):
    cfg = CASES[case]
    kw = cfg["kw"]
    rng = random.Random(len(case))
    pts = list(points)
    vals = [rng.randrange(R_MOD) for _ in range(N - 6)]
    # GLV decomposition edge scalars ride along in every case
    vals += [0, 1, GLV_LAMBDA - 1, GLV_LAMBDA + 1, R_MOD - 1, GLV_LAMBDA]
    if cfg.get("zeros"):
        vals = [0] * N
    if cfg.get("holes"):
        pts = [None if i % 5 == 0 else p for i, p in enumerate(pts)]
        vals = [0 if i % 3 == 0 else v for i, v in enumerate(vals)]
    if cfg.get("rm1"):
        vals = [R_MOD - 1] + [0] * (N - 1)
    if kw.get("scalars_montgomery", True):
        got = _port_msm(vals, pts, **kw)
    else:
        A = g1.affine_from_ints(pts, device="cpu")
        sc = convert.scalars_from_numpy(ints_to_limbs(vals, 16), device="cpu")
        got = g1.jacobian_to_ints(
            tuple(c[:, None] for c in msm_g1(sc, A, **kw)))[0]
    if cfg.get("zeros"):
        assert got is None
    elif cfg.get("rm1"):
        x, y = pts[0]
        assert got == (x, (-y) % constants.FQ_MODULUS)
    else:
        assert got == _oracle_msm(vals, pts)


def test_golden_vector_1024():
    with open(os.path.join(VEC_DIR, "msm_g1_vectors.json")) as f:
        case = next(c for c in json.load(f)["cases"] if c["n"] == 1024)
    vals = [int(s, 16) for s in case["scalars"]]
    pts = [(int(p["x"], 16), int(p["y"], 16)) for p in case["points"]]
    got = _port_msm(vals, pts)
    assert got == (int(case["expected"]["x"], 16), int(case["expected"]["y"], 16))


@pytest.mark.parametrize("flag,mode", [("0", "off"), ("off", "off"),
                                       ("on", "on"), ("1", "on"),
                                       ("auto", "auto"), ("bogus", "auto")])
def test_env_flag_routes_glv(flag, mode, monkeypatch):
    from tpu_bls12_381_torch.runtime import config, reset_config_cache

    monkeypatch.setenv("MIDNIGHT_MSM_GLV", flag)
    reset_config_cache()
    try:
        assert config().msm_glv == mode
        # auto: on while the doubled set fits the budget in one shot
        want = {"off": False, "on": True, "auto": True}[mode]
        assert msm_geometry(N, device="cpu")["glv"] is want
        assert pip._resolve_glv(False, N, 1 << 40, 1320) is False
        assert pip._resolve_glv(True, N, 1, 1320) is True
    finally:
        monkeypatch.delenv("MIDNIGHT_MSM_GLV")
        reset_config_cache()


def test_msm_chunks_when_the_budget_needs_more_than_one_piece(points, monkeypatch):
    A = g1.affine_from_ints(points, device="cpu")
    sc = convert.scalars_from_numpy(_scalars_np([1] * N), device="cpu")
    bpp = pip._msm_bytes_per_point(FQ_ADAPTER)
    assert pip._split_points(N, N * bpp, bpp) == 1
    assert pip._split_points(N, (N // 4) * bpp, bpp) == 4
    # room for a quarter of the points: the port chunks as the JAX package
    # does (it used to refuse), folds the pieces' window sums and runs the
    # Horner ladder once; nothing is truncated
    monkeypatch.setattr(pip, "_available_budget", lambda device: (N // 4) * bpp)
    geo = msm_geometry(N, glv=False, device="cpu")
    assert (geo["pieces"], geo["per"], geo["n"]) == (4, N // 4, N // 4)
    # with GLV forced on, the doubled set of a budget for N points runs in
    # two pieces of N/2 input points, N pipeline points each
    monkeypatch.setattr(pip, "_available_budget", lambda device: N * bpp)
    geo = msm_geometry(N, glv=True, device="cpu", window_bits=9)
    assert (geo["pieces"], geo["per"], geo["n"], geo["T"]) == (2, N // 2, N, 15)
    vals = [3 + 5 * i for i in range(N)]
    sc = convert.scalars_from_numpy(_scalars_np(vals), device="cpu")
    got = g1.jacobian_to_ints(msm_g1(sc, A, glv=True, window_bits=9))[0]
    assert got == _oracle_msm(vals, points)
    monkeypatch.setattr(pip, "_available_budget", lambda device: (N // 4) * bpp)
    # GLV "auto" follows the same budget: on only while 2n points fit
    assert not msm_geometry(N, device="cpu")["glv"]
    monkeypatch.setattr(pip, "_available_budget", lambda device: 2 * N * bpp)
    assert msm_geometry(N, device="cpu")["glv"]


def test_msm_refuses_bad_inputs(points):
    A = g1.affine_from_ints(points[:8], device="cpu")
    sc = convert.scalars_from_numpy(_scalars_np([1] * 8), device="cpu")
    with pytest.raises(TypeError):
        msm_g1(sc.to(torch.int64), A)
    with pytest.raises(ValueError):
        msm_g1(sc[:, :4], A)
    with pytest.raises(TypeError):
        msm_g1(sc, (A[0], A[1], A[2].to(torch.int32)))
    with pytest.raises(NotImplementedError):
        pip.msm(object(), sc, A)
