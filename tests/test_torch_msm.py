"""Single-shot G1 Pippenger MSM of the PyTorch/CUDA port, on the CPU.

The slice as a whole: the same scalars and points, made from a seed on the
host, go through the JAX package's ``msm_g1`` (one call with default
arguments) and through ``tpu_bls12_381_torch.msm.msm_g1`` on CPU tensors,
where every kernel wrapper takes its plain version.  MSM results are compared
as affine integers: the sort's tie order may differ, which moves points
between slots and changes Z, never the point.  The window keys and the tuning
heuristics are compared exactly.  The port's edge cases against the oracle
are in ``tests/test_torch_msm_cases.py``, which runs beside this file.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_bls12_381.curves import g1 as jg1
from tpu_bls12_381.msm import msm_g1 as jax_msm_g1, pippenger as jpip

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import g1
from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER
from tpu_bls12_381_torch.curves.glv import GLV_LAMBDA
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
from tpu_bls12_381_torch.msm import msm_g1, msm_geometry, pippenger as pip

from torch_shared import fr_mont_limbs, host_g1_points, oracle_msm_g1, port_msm_g1

N = 64
R_MOD = constants.FR_MODULUS
VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def points():
    return host_g1_points(N)


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
    sc_np = fr_mont_limbs(vals)
    jA = jg1.affine_from_ints(points)
    A_np = tuple(np.asarray(c) for c in jA)
    jP = jax_msm_g1(jnp.asarray(sc_np), jA)
    want = jg1.jacobian_to_ints(
        jax.tree_util.tree_map(lambda c: c[..., None], jP))[0]

    P = msm_g1(convert.scalars_from_numpy(sc_np, device="cpu"),
               convert.affine_from_numpy(*A_np, device="cpu"))
    got = g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]
    assert got == want
    assert got == oracle_msm_g1(vals, points)


def test_golden_vector_1024():
    with open(os.path.join(VEC_DIR, "msm_g1_vectors.json")) as f:
        case = next(c for c in json.load(f)["cases"] if c["n"] == 1024)
    vals = [int(s, 16) for s in case["scalars"]]
    pts = [(int(p["x"], 16), int(p["y"], 16)) for p in case["points"]]
    got = port_msm_g1(vals, pts)
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


def test_msm_refuses_bad_inputs(points):
    A = g1.affine_from_ints(points[:8], device="cpu")
    sc = convert.scalars_from_numpy(fr_mont_limbs([1] * 8), device="cpu")
    with pytest.raises(TypeError):
        msm_g1(sc.to(torch.int64), A)
    with pytest.raises(ValueError):
        msm_g1(sc[:, :4], A)
    with pytest.raises(TypeError):
        msm_g1(sc, (A[0], A[1], A[2].to(torch.int32)))
    with pytest.raises(NotImplementedError):
        pip.msm(object(), sc, A)
