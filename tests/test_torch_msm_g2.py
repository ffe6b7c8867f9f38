"""The G2 MSM of the PyTorch/CUDA port on the CPU: its plan against the JAX
package's heuristics, one window of the pipeline stage by stage against the
JAX package's staged functions over ``FQ2_ADAPTER`` (limb for limb), and the
golden vector ``tests/vectors/msm_g2_vectors.json`` as affine integers.  A
file of its own, so that the one full-width G2 MSM (over a minute on one core)
runs beside the other files' tests, not after them.
"""

import json
import os
import random

import numpy as np
import torch

import jax.numpy as jnp

from tpu_bls12_381 import oracle
from tpu_bls12_381.curves import g2 as jg2
from tpu_bls12_381.curves.field_adapters import FQ2_ADAPTER as JF2
from tpu_bls12_381.fields.limbs import ints_to_limbs
from tpu_bls12_381.msm import pippenger as jpip

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import g2, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER as F2, FQ_ADAPTER as F1
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.msm import msm_g2, msm_geometry, pippenger as pip

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)


def _scalars_mont(vals):
    return ints_to_limbs([FR.to_mont(v) for v in vals], 16)


def _port_msm_g2(vals, pts, **kw):
    A = g2.affine_from_ints(pts, device="cpu")
    sc = convert.scalars_from_numpy(_scalars_mont(vals), device="cpu")
    P = msm_g2(sc, A, **kw)
    assert all(tuple(c.shape) == (24, 2) and c.dtype == torch.int32 for c in P)
    return g2.jacobian_to_ints(tuple(c[..., None] for c in P))[0]


def test_msm_g2_geometry_follows_the_adapter():
    geo = msm_geometry(1 << 20, F=F2, device="cpu")
    assert (geo["glv"], geo["w"], geo["T"], geo["L"], geo["R"], geo["nb"]) == (
        False, 14, 20, 1 << 14, 64, 1 << 13)
    assert msm_geometry(1 << 20, glv=True, F=F2, device="cpu")["glv"] is False
    assert pip._msm_bytes_per_point(F2) == 2 * pip._msm_bytes_per_point(F1)
    assert pip._coord_planes(F2) == 48 and pip._coord_planes(F1) == 24
    for n in (16, 1 << 10, 1 << 16, 1 << 22):
        from tpu_bls12_381.msm import pippenger as jpip
        assert pip.window_bits_for(n, F2, "cpu") == jpip.window_bits_for(n, JF2)
        assert pip.lane_tile_for(n, F2, "cpu") == jpip.lane_tile_for(n, JF2)


def _assert_fq2_equal(got, want, lead=0):
    """Port coordinates (*lead, 24, 2, *batch) against the JAX package's
    (c0, c1) pairs of (*lead, 24, *batch), limb for limb."""
    for c, (j0, j1) in zip(got, want):
        a = c.numpy()
        np.testing.assert_array_equal(np.take(a, 0, axis=lead + 1), np.asarray(j0))
        np.testing.assert_array_equal(np.take(a, 1, axis=lead + 1), np.asarray(j1))


def test_g2_window_stages_match_jax_limb_for_limb():
    """One window of the G2 pipeline at n = 16, the same seeded points and
    scalars through both packages: the packed 96-column rows, the sort tile
    (2 pad slots, an identity point, a zero scalar), the row scan, the stitch
    and the Fq2 boundary.  Integer arithmetic with canonical results: the
    tolerance is 0.  The JAX stages run their plain formulas on the CPU."""
    n, w, R, L = 16, 4, 3, 6
    nb = 1 << (w - 1)
    rng = random.Random(0x62)
    G = oracle.g2_generator()
    pts = [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 30), G, oracle.FQ2_OPS),
        oracle.FQ2_OPS) for _ in range(n)]
    pts[5] = None
    pts[9] = pts[2]                               # one point twice in a bucket run
    vals = [rng.randrange(constants.FR_MODULUS) for _ in range(n)]
    vals[3] = 0
    k = ints_to_limbs(vals, 16)
    t = 2                                         # the window compared

    jA = jg2.affine_from_ints(pts)
    jkey = jpip.decompose_window_keys(jnp.asarray(k), w)[t]
    jem = jpip._stage_pack_rows(JF2, jA[0], jA[1])
    jtile = jpip._stage_sort_tile(JF2, jkey, R, L, jem, jA[2])
    jtotal, jprefix = jpip._stage_scan(JF2, *jtile[1:])
    jcarry = jpip._stage_stitch(JF2, jtotal)
    jbuckets = jpip._boundary_core(JF2, jtile[0], jcarry, nb, jprefix)

    A = g2.affine_from_ints(pts, device="cpu")
    key = pip.decompose_window_keys(convert.scalars_from_numpy(k, device="cpu"), w)[t]
    em = pip._stage_pack_rows(F2, A[0], A[1])
    # the port's rows hold a coordinate as (limb, component), the JAX
    # package's as (component, limb): the same 96 values a point
    np.testing.assert_array_equal(
        em.numpy().reshape(n, 2, 24, 2).transpose(0, 1, 3, 2).reshape(n, 96),
        np.asarray(jem))
    tile = pip._stage_sort_tile(F2, key, R, L, em, A[2])
    np.testing.assert_array_equal(tile[0].numpy(), np.asarray(jtile[0]).astype(np.int64))
    _assert_fq2_equal(tile[1:3], jtile[1:3], lead=1)
    np.testing.assert_array_equal(tile[3].numpy(), np.asarray(jtile[3]))
    np.testing.assert_array_equal(tile[4].numpy(), np.asarray(jtile[4]))
    total, prefix = pip._stage_scan(F2, *tile[1:])
    _assert_fq2_equal(prefix, jprefix, lead=1)
    _assert_fq2_equal(total, jtotal)
    carry = pip._stage_stitch(F2, total)
    _assert_fq2_equal(carry, jcarry)
    buckets = pip._boundary_core(F2, tile[0], carry, nb, prefix)
    assert tuple(buckets[0].shape) == (24, 2, nb)
    _assert_fq2_equal(buckets, jbuckets)
    # and the buckets are the right ones: bucket b sums the points whose
    # signed digit in this window is +-b
    d, sg = pip.decompose_signed_digits(convert.scalars_from_numpy(k, device="cpu"), w)
    for b in range(1, nb + 1):
        want = None
        for i, pt in enumerate(pts):
            if pt is not None and int(d[t, i]) == b:
                term = oracle.scalar_mul(
                    constants.FR_MODULUS - 1 if bool(sg[t, i]) else 1, pt, oracle.FQ2_OPS)
                want = term if want is None else oracle.jac_add(want, term, oracle.FQ2_OPS)
        got = g2.jacobian_to_ints(pj.proj_to_jac(
            F2, tuple(c[..., b - 1:b] for c in buckets)))[0]
        assert got == (None if want is None
                       else oracle.jac_to_affine(want, oracle.FQ2_OPS))


def test_msm_g2_golden_vector_1024():
    """The one full-width G2 MSM of this file (a port MSM costs seconds per
    window on the CPU, three times G1's over Fq2).  The identity among the
    points and the scalars 0 and r - 1 are held against the host oracle
    through the G2 context, at 13 windows an MSM, and the fold of a chunked
    MSM's pieces over Fq2 on its own, in ``tests/test_torch_msm_context.py``;
    the JAX package's whole ``msm_g2`` is not called (its first call costs
    over 200 s of XLA:CPU compile): its stages are held above."""
    with open(os.path.join(VEC_DIR, "msm_g2_vectors.json")) as f:
        c = json.load(f)["cases"][0]
    _i = lambda s: int(s, 16)
    vals = [_i(s) for s in c["scalars"]]
    pts = [((_i(p["x"][0]), _i(p["x"][1])), (_i(p["y"][0]), _i(p["y"][1])))
           for p in c["points"]]
    exp = c["expected"]
    assert _port_msm_g2(vals, pts, window_bits=10) == (
        (_i(exp["x"][0]), _i(exp["x"][1])), (_i(exp["y"][0]), _i(exp["y"][1])))
