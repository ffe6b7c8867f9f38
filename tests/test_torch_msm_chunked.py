"""``msm_chunked`` of the PyTorch/CUDA port, the D chunks as one batch, on
the CPU.

The JAX package's ``msm_chunked`` with ``mapper="vmap"`` maps every stage over
the chunk axis; the port folds that axis between the element axes and the
lanes, as its shared-bases batch does, with each chunk gathering from its own
point table.  Here:

* each chunk's limbs against the port's one-device call on that chunk at the
  same window bits (``msm`` for factor 1, ``msm_precomputed`` on the chunk's
  expanded bases for factor > 1; ``torch.equal``: every plain operation on the
  path computes a member as it computes one alone), and the chunks' sum
  against the oracle;
* the batched sort keys, extended bases and sort tile limb for limb against
  ``jax.vmap`` of the JAX package's stages;
* the plan of ``msm_geometry(..., chunks=D)`` under a monkeypatched memory
  budget (groups of chunks, a chunk in pieces), the launches the batched
  call makes with the lane scans on the scan kernel's route, and the
  group's operands as views of the caller's tensors;
* the cached GLV constant columns.

A port MSM on the CPU costs some 0.5 s a window whatever D is (the batch
rides in the lanes), and the one-device references cost that again a chunk,
so the cases cut windows with GLV and precompute factors, with D = 2: G1 at
w = 6 (fewer windows than w = 5, without the wider bucket tiles of w = 8),
G2 at factor 8 and w = 5 (7 windows, 16 buckets each: less on the CPU than
the 5 windows of 128 buckets at w = 8).  D = 4
holds its keys against JAX's here, its groups against the call in one group,
and its chunks against the one-device calls on the card (``chip_smoke.py``).
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_bls12_381 import oracle as joracle
from tpu_bls12_381.curves import g1 as jg1
from tpu_bls12_381.msm import pippenger as jpip

from tpu_bls12_381_torch import constants
from tpu_bls12_381_torch.curves import cuda_g1, g1, g2, glv, points as pt, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
from tpu_bls12_381_torch.msm import (msm, msm_chunked, msm_geometry, msm_precomputed,
                                     pippenger as pip)
from tpu_bls12_381_torch.parallel.msm import chunk_msm_inputs

torch.set_num_threads(1)

R_MOD = constants.FR_MODULUS
N = 16                          # points of a case, cut into D chunks


def _points(n, seed, curve="g1"):
    rng = random.Random(seed)
    G, ops = ((joracle.g2_generator(), joracle.FQ2_OPS) if curve == "g2"
              else (joracle.g1_generator(), joracle.FQ_OPS))
    pts = [joracle.jac_to_affine(joracle.scalar_mul(rng.randrange(1, 1 << 48), G, ops), ops)
           for _ in range(n)]
    vals = [rng.randrange(R_MOD) for _ in range(n)]
    vals[3] = 0                                   # a zero scalar: sentinel keys
    return pts, vals


def _limbs(vals, mont=True):
    return torch.from_numpy(ints_to_limbs([FR.to_mont(v) if mont else v for v in vals],
                                          16).astype(np.int32))


@pytest.fixture(scope="module")
def g1_set():
    pts, vals = _points(N, 0xC1)
    return pts, vals, g1.affine_from_ints(pts, device="cpu"), _limbs(vals)


def _bases(pts, w, factor, glv_, curve="g1"):
    """Affine bases as ``precompute`` lays them out (GLV-extend, then
    ``expand_bases``: block j holds 2^(w T' j) times every point), the
    multiples taken on the host: affine limbs are canonical, so they are
    ``expand_bases``' limbs, at a fraction of its cost on the CPU."""
    ops, mod = ((joracle.FQ2_OPS, g2) if curve == "g2" else (joracle.FQ_OPS, g1))
    if glv_:
        pts = pts + [None if p is None else (glv.beta() * p[0] % constants.FQ_MODULUS, p[1])
                     for p in pts]
    span = pip.precompute_window_span(w, factor, 128 if glv_ else 255) * w
    blocks = [None if p is None else joracle.jac_to_affine(
        joracle.scalar_mul(1 << (span * j), p, ops), ops)
        for j in range(factor) for p in pts]
    return mod.affine_from_ints(blocks, device="cpu")


def _segments(factor, glv_):
    return factor * (2 if glv_ else 1) if factor > 1 else 1


CASES = {
    # name: (curve, D, w, factor, glv)
    "g1 factor 1 glv": ("g1", 2, 6, 1, True),
    "g1 factor 2 glv": ("g1", 2, 6, 2, True),
    "g2 factor 8": ("g2", 2, 5, 8, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_chunks_equal_the_one_device_call(name, g1_set):
    """Each chunk's limbs are the one-device call's on that chunk at the
    same window bits; the chunks sum to the oracle's MSM."""
    curve, D, w, factor, glv_ = CASES[name]
    if curve == "g1":
        F, ops, ints = FQ_ADAPTER, joracle.FQ_OPS, g1.jacobian_to_ints
        pts, vals, A, sc = g1_set
    else:
        F, ops, ints = FQ2_ADAPTER, joracle.FQ2_OPS, g2.jacobian_to_ints
        pts, vals = _points(N // 2, 0xC2, "g2")
        A, sc = g2.affine_from_ints(pts, device="cpu"), _limbs(vals)
    Ab = _bases(pts, w, factor, glv_, curve) if factor > 1 else A
    sc_c, A_c = chunk_msm_inputs(sc, Ab, D, segments=_segments(factor, glv_))
    got = msm_chunked(F, sc_c, A_c, window_bits=w, glv=glv_, factor=factor)
    assert all(tuple(c.shape) == (D,) + tuple(F.elem_shape) for c in got)
    for d in range(D):
        A_d = tuple(c[d] for c in A_c)
        one = (msm(F, sc_c[d], A_d, window_bits=w, glv=glv_) if factor == 1 else
               msm_precomputed(F, sc_c[d], A_d, window_bits=w, factor=factor, glv=glv_))
        assert all(torch.equal(g[d], o) for g, o in zip(got, one)), (name, d)
    total = pt.sum_reduce(F, tuple(c.movedim(0, -1).contiguous() for c in got))
    want = joracle.jac_to_affine(joracle.msm(vals, pts, ops), ops)
    assert ints(tuple(c[..., None] for c in total))[0] == want


class _Stop(Exception):
    pass


def test_batched_keys_and_bases_match_jax_vmap(g1_set, monkeypatch):
    """What the batched prelude hands the window loop (GLV at factor 1): the
    sort keys (T, D, 2m) and the extended bases (*elem, D, 2m) are
    ``jax.vmap`` of the JAX package's prelude (the GLV split, then
    ``decompose_window_keys``) and of its ``glv_extend_bases`` over the chunk
    axis, limb for limb."""
    pts, vals, A, _ = g1_set
    D, w = 4, 6
    sc_std = _limbs(vals, mont=False)
    sc_c, A_c = chunk_msm_inputs(sc_std, A, D)
    seen = {}

    def stop(F, keys, A_, w_):
        seen.update(keys=keys, A=A_)
        raise _Stop

    monkeypatch.setattr(pip, "_window_sums_from_keys", stop)
    with pytest.raises(_Stop):
        msm_chunked(FQ_ADAPTER, sc_c, A_c, window_bits=w, glv=True, scalars_montgomery=False)
    keys = jax.vmap(lambda s: jpip.decompose_window_keys(
        jpip.glv_split_scalars(s)[0], w, 128))(jnp.asarray(sc_c.numpy().astype(np.uint32)))
    np.testing.assert_array_equal(seen["keys"].numpy(),
                                  np.asarray(keys).astype(np.int64).transpose(1, 0, 2))
    jx, jy, jinf = jax.vmap(lambda x, y, i: jpip.glv_extend_bases(jpip.FQ_ADAPTER, (x, y, i)))(
        *(jnp.asarray(c.numpy().astype(np.uint32) if c.dtype == torch.int32 else c.numpy())
          for c in A_c))
    x, y, inf = seen["A"]
    np.testing.assert_array_equal(x.numpy().transpose(1, 0, 2), np.asarray(jx).astype(np.int32))
    np.testing.assert_array_equal(y.numpy().transpose(1, 0, 2), np.asarray(jy).astype(np.int32))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(jinf))


def test_sort_tile_with_a_table_a_chunk_matches_jax_vmap():
    """Two chunks with different tables (other points, other scalars, pad
    slots, identity points and zero digits): the batched sort tile is
    ``jax.vmap(_stage_sort_tile)`` slot for slot, the packed tables the JAX
    package's rows one chunk after the other."""
    n, R, L, D = 56, 8, 8, 2
    rng = random.Random(5)
    G = joracle.g1_generator()
    pts = [None if i % 9 == 0 else joracle.jac_to_affine(
        joracle.scalar_mul(rng.randrange(1, 1 << 32), G, joracle.FQ_OPS), joracle.FQ_OPS)
        for i in range(D * n)]
    vals = [0 if i % 7 == 0 else rng.randrange(R_MOD) for i in range(D * n)]
    k = ints_to_limbs(vals, FR.num_limbs).reshape(16, D, n)
    jA = jg1.affine_from_ints(pts)
    jA = tuple(jnp.moveaxis(c.reshape(c.shape[:-1] + (D, n)), -2, 0) for c in jA)
    jkeys = jax.vmap(lambda s: jpip.decompose_window_keys(s, 6)[2])(
        jnp.asarray(np.moveaxis(k, 1, 0)))
    jem = jax.vmap(lambda x, y: jpip._stage_pack_rows(jpip.FQ_ADAPTER, x, y))(jA[0], jA[1])
    want = jax.vmap(lambda ks, em, i: jpip._stage_sort_tile(jpip.FQ_ADAPTER, ks, R, L, em, i))(
        jkeys, jem, jA[2])
    A = g1.affine_from_ints(pts, device="cpu")
    A = tuple(c.reshape(c.shape[:-1] + (D, n)) for c in A)
    keys = pip.decompose_window_keys(torch.from_numpy(k.astype(np.int32)), 6)[2]
    em = pip._stage_pack_rows(FQ_ADAPTER, A[0], A[1])
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem)[..., :48].reshape(D * n, 48))
    ks, xr, yr, sr, ir = pip._stage_sort_tile(FQ_ADAPTER, keys, R, L, em, A[2])
    mine = (ks, xr.permute(2, 0, 1, 3), yr.permute(2, 0, 1, 3), sr.transpose(0, 1),
            ir.transpose(0, 1))
    for g, w_ in zip(mine, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w_).astype(np.int64))
    # each member is the unbatched stage on its own table
    one = pip._stage_sort_tile(FQ_ADAPTER, keys[1], R, L, em[n:], A[2][1])
    assert torch.equal(one[1], xr[:, :, 1]) and torch.equal(one[3], sr[:, 1])


# -----------------------------------------------------------------------------
# The plan, the budget and the launches
# -----------------------------------------------------------------------------

BPP = pip._msm_bytes_per_point(FQ_ADAPTER)


def _budget(monkeypatch, points):
    monkeypatch.setattr(pip, "_available_budget", lambda device: points * BPP)


def test_chunked_plan(monkeypatch):
    """``msm_geometry(..., chunks=D)``: one group while all D chunks fit,
    groups of chunks as they fit, groups of one chunk in pieces where one
    does not; ``scan_launches`` = T x groups x pieces."""
    n, D = 1 << 10, 4
    roomy = msm_geometry(n, True, device="cpu", window_bits=8, chunks=D)
    one = msm_geometry(n, True, device="cpu", window_bits=8)
    assert (roomy["groups"], roomy["per_group"], roomy["pieces"]) == (1, D, 1)
    assert {k: roomy[k] for k in ("w", "T", "L", "R", "nb", "lb_bits")} == {
        k: one[k] for k in ("w", "T", "L", "R", "nb", "lb_bits")}
    assert roomy["scan_launches"] == one["T"]
    _budget(monkeypatch, 3 * 2 * n)                  # room for 3 chunks' working sets
    two = msm_geometry(n, True, device="cpu", window_bits=8, chunks=D)
    assert (two["groups"], two["per_group"], two["pieces"]) == (2, 2, 1)
    assert two["scan_launches"] == 2 * two["T"]
    _budget(monkeypatch, n)                          # half a chunk
    cut = msm_geometry(n, True, device="cpu", window_bits=8, chunks=D)
    assert (cut["groups"], cut["per_group"], cut["pieces"], cut["per"]) == (D, 1, 2, n // 2)
    assert cut["n"] == n and cut["scan_launches"] == D * 2 * cut["T"]
    # factor > 1 counts the expanded points and slices a factor block's
    f4 = msm_geometry(n, True, device="cpu", window_bits=8, factor=4, chunks=D)
    assert (f4["groups"], f4["pieces"], f4["per"]) == (D, 8, 2 * n // 8)
    assert f4["T"] == pip.precompute_window_span(8, 4, 128)
    with pytest.raises(ValueError, match="chunks plan msm_chunked"):
        msm_geometry(n, True, device="cpu", chunks=D, cached=True)


@pytest.fixture
def scan_on_the_cpu(monkeypatch):
    """G1 lane scans on ``padd_scan_plain`` for CPU tensors, as they go to
    the kernel on the card, counted as the wrapper counts its launches (3 a
    scan, 2 a total), and the adds counted."""
    counts = {"padd_scan": 0, "padd": 0}

    def scan(P, **kw):
        counts["padd_scan"] += 2 if kw.get("total") else 3
        return cuda_g1.padd_scan_plain(P, **kw)

    add = pj.proj_add_fast

    def counted_add(F, P, Q):
        counts["padd"] += F is FQ_ADAPTER
        return add(F, P, Q)

    monkeypatch.setattr(pj, "lane_scan_kernel",
                        lambda F, device: scan if F is FQ_ADAPTER else None)
    monkeypatch.setattr(pj, "proj_add_fast", counted_add)
    monkeypatch.setattr(pip, "g_add", counted_add)
    return counts


W_B, F_B = 5, 8                 # the budget cases: GLV, factor 8, 4 windows a run


@pytest.fixture(scope="module")
def budget_set(g1_set):
    pts, vals, A, sc = g1_set
    return chunk_msm_inputs(sc, _bases(pts, W_B, F_B, True), 4, segments=2 * F_B)


def _chunked(sc_c, A_c):
    return msm_chunked(FQ_ADAPTER, sc_c, A_c, window_bits=W_B, glv=True, factor=F_B)


def test_the_batched_call_makes_one_chunks_launches(budget_set, scan_on_the_cpu, monkeypatch):
    """With the lane scans on the scan kernel's route, 4 chunks in one group
    make one chunk's 12 x T scan launches (not 4 times that) and the plan's
    adds; in groups of 2 under a budget for 2, twice the scans, the same
    limbs."""
    sc_c, A_c = budget_set
    n = sc_c.shape[-1]
    plan = msm_geometry(n, True, device="cpu", window_bits=W_B, factor=F_B, chunks=4)
    assert (plan["groups"], plan["pieces"]) == (1, 1)
    whole = _chunked(sc_c, A_c)
    assert scan_on_the_cpu == plan["tail_launches"]
    assert plan["tail_launches"]["padd_scan"] == 12 * plan["T"]
    _budget(monkeypatch, 2 * n * 2 * F_B)
    plan2 = msm_geometry(n, True, device="cpu", window_bits=W_B, factor=F_B, chunks=4)
    assert (plan2["groups"], plan2["per_group"], plan2["pieces"]) == (2, 2, 1)
    scan_on_the_cpu.update(padd_scan=0, padd=0)
    grouped = _chunked(sc_c, A_c)
    assert scan_on_the_cpu == plan2["tail_launches"]
    assert all(torch.equal(a, b) for a, b in zip(grouped, whole))


def test_groups_take_views_of_the_inputs(budget_set, monkeypatch):
    """Under a budget for 2 of the 4 chunks, each group's coordinates and
    mask reach the window sums as views of the caller's tensors at the
    group's first chunk (the chunk axis moved behind the element axes,
    nothing copied): the only copies of the bases are the group's own
    working set, which the plan counts."""
    sc_c, A_c = budget_set
    n = sc_c.shape[-1]
    _budget(monkeypatch, 2 * n * 2 * F_B)
    seen = []

    def record(F, sc, A, w, factor, num_bits, per):
        seen.append(A)
        T = pip.precompute_window_span(w, factor, num_bits)
        zero = torch.zeros((T,) + tuple(F.elem_shape) + (sc.shape[1],), dtype=torch.int32)
        return zero, zero, zero

    monkeypatch.setattr(pip, "_sliced_window_sums", record)
    monkeypatch.setattr(pip, "_horner_to_jac", lambda F, Ws, w: tuple(c[0] for c in Ws))
    out = _chunked(sc_c, A_c)
    assert all(tuple(c.shape) == (4, 24) for c in out)
    assert len(seen) == 2
    for g, A in enumerate(seen):
        for got, src in zip(A, A_c):
            assert got.data_ptr() == src[2 * g].data_ptr(), g
            mine = got if got.dim() == 2 else got.movedim(-2, 0)
            assert torch.equal(mine, src[2 * g:2 * g + 2]), g


def test_a_chunk_in_pieces(budget_set, monkeypatch):
    """A budget below one chunk's working set: each chunk runs in pieces, as
    the one-device call on it under the same budget does, limb for limb."""
    sc_c, A_c = budget_set
    sc_c, A_c = sc_c[:2], tuple(c[:2] for c in A_c)
    n = sc_c.shape[-1]
    _budget(monkeypatch, n * 2 * F_B // 2 + 1)
    plan = msm_geometry(n, True, device="cpu", window_bits=W_B, factor=F_B, chunks=2)
    assert (plan["groups"], plan["pieces"]) == (2, 2)
    cut = _chunked(sc_c, A_c)
    for d in range(2):
        one = msm_precomputed(FQ_ADAPTER, sc_c[d], tuple(c[d] for c in A_c),
                              window_bits=W_B, factor=F_B, glv=True)
        assert all(torch.equal(c[d], o) for c, o in zip(cut, one))


def test_glv_constant_columns_are_cached():
    """``glv.decompose`` makes its two constant columns once a device: a
    second call reuses them (no copy from the host), and the split is
    k = k1 + k2 lambda with both halves below 2^128, as before."""
    rng = random.Random(9)
    vals = [0, 1, R_MOD - 1, glv.GLV_LAMBDA, glv.GLV_LAMBDA - 1] + [
        rng.randrange(R_MOD) for _ in range(11)]
    k = _limbs(vals, mont=False).reshape(16, 4, 4)
    glv._const_col_cached.cache_clear()
    k1, k2 = glv.decompose(k)
    assert glv._const_col_cached.cache_info().misses == 2
    col = glv._const_col(glv.GLV_LAMBDA, 16, k)
    assert glv._const_col_cached.cache_info().hits == 1
    k1b, k2b = glv.decompose(k[:, :1])
    info = glv._const_col_cached.cache_info()
    assert (info.misses, info.hits) == (2, 3)
    assert col.data_ptr() == glv._const_col(glv.GLV_LAMBDA, 16, k2).data_ptr()
    as_int = lambda t: [sum(int(t[i, j]) << (16 * i) for i in range(t.shape[0]))
                        for j in range(t.shape[1])]
    k1, k2 = k1.reshape(16, -1), k2.reshape(k2.shape[0], -1)
    for v, a, b in zip(vals, as_int(k1), as_int(k2)):
        assert (a, b) == (v % glv.GLV_LAMBDA, v // glv.GLV_LAMBDA)
    assert torch.equal(k1b, k1.reshape(16, 4, 4)[:, :1])
    assert torch.equal(k2b, k2.reshape(-1, 4, 4)[:, :1])
