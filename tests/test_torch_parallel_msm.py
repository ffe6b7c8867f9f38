"""The sharded MSMs of the PyTorch/CUDA port (``parallel/msm.py``), on the
CPU in one process, held by value (affine integers: the chunks' association
changes Z) to the port's one-device MSM and the oracle; the JAX package's
sharded MSM is not compiled (minutes on XLA:CPU).  A port MSM on the CPU
costs about a second a window, whatever the chunk count (the chunks ride in
the lanes), so the cases pick windows, GLV and factors that keep the window
count low.  The layouts, tables and the sharded NTT are
``test_torch_parallel.py``; the multi-rank runs are in
``test_torch_parallel_dist.py``.
"""

import random

import pytest
import torch

from tpu_bls12_381 import oracle as joracle

from tpu_bls12_381_torch import constants
from tpu_bls12_381_torch.curves import g1, g2
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER
from tpu_bls12_381_torch.msm import expand_bases, msm_chunked, msm_g1, msm_precomputed
from tpu_bls12_381_torch.msm.pippenger import glv_extend_bases
from tpu_bls12_381_torch.parallel import msm_g1_sharded, msm_g2_sharded
from tpu_bls12_381_torch.parallel.mesh import Mesh
from tpu_bls12_381_torch.parallel.msm import chunk_msm_inputs

from torch_shared import fr_mont_limbs, limbs_to_tensor as T

torch.set_num_threads(1)

R_MOD = constants.FR_MODULUS
CPU = torch.device("cpu")


N_G1 = 32


def _g1_ints(P):
    return g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]


@pytest.fixture(scope="module")
def g1_case():
    """32 points and scalars, the oracle's MSM and the port's one-device
    ``msm_g1`` (GLV, window 5: 26 windows)."""
    rng = random.Random(0x5A4D)
    G = joracle.g1_generator()
    pts = [joracle.jac_to_affine(joracle.scalar_mul(rng.randrange(1, 1 << 48), G,
                                                    joracle.FQ_OPS), joracle.FQ_OPS)
           for _ in range(N_G1)]
    vals = [rng.randrange(R_MOD) for _ in range(N_G1)]
    A = g1.affine_from_ints(pts, device="cpu")
    sc = T(fr_mont_limbs(vals))
    want = joracle.jac_to_affine(joracle.msm(vals, pts, joracle.FQ_OPS), joracle.FQ_OPS)
    single = _g1_ints(msm_g1(sc, A, window_bits=5, glv=True))
    assert single == want
    return sc, A, want


def test_msm_g1_sharded_over_two_chunks(g1_case):
    """D = 2, GLV off, factor 4 (13 windows a chunk at w = 5, where factor 1
    takes 51).  GLV at factor 1, where a chunk extends its own bases, is the
    multi-rank file's case."""
    sc, A, want = g1_case
    w, factor = 5, 4
    sc_c, A_c = chunk_msm_inputs(sc, expand_bases(FQ_ADAPTER, A, w, factor), 2,
                                 segments=factor)
    assert _g1_ints(msm_g1_sharded(sc_c, A_c, window_bits=w, glv=False,
                                   factor=factor)) == want


def test_msm_g1_sharded_factor2_over_four_chunks(g1_case):
    """D = 4, factor 2 with GLV, laid out as ``precompute`` does: GLV-extend,
    expand, then 4 segments a chunk (11 windows a chunk at w = 6)."""
    sc, A, want = g1_case
    w, factor = 6, 2
    Ae = expand_bases(FQ_ADAPTER, glv_extend_bases(FQ_ADAPTER, A), w, factor, 128)
    sc_c, A_c = chunk_msm_inputs(sc, Ae, 4, segments=2 * factor)
    got = msm_g1_sharded(sc_c, A_c, window_bits=w, glv=True, factor=factor)
    assert _g1_ints(got) == want


def test_msm_g2_sharded_matches_one_device_and_oracle():
    """G2 over 2 chunks at factor 8 and w = 5 (7 windows a chunk where
    factor 1 takes 52; cheaper on the CPU than the 5 windows of 128 buckets
    at w = 8): held to the oracle and to the one-device precomputed MSM on
    the same expanded bases."""
    n, w, factor = 16, 5, 8
    rng = random.Random(0x6232)
    G2 = joracle.g2_generator()
    pts = [joracle.jac_to_affine(joracle.scalar_mul(rng.randrange(1, 1 << 48), G2,
                                                    joracle.FQ2_OPS), joracle.FQ2_OPS)
           for _ in range(n)]
    vals = [rng.randrange(R_MOD) for _ in range(n)]
    A = g2.affine_from_ints(pts, device="cpu")
    sc = T(fr_mont_limbs(vals))
    want = joracle.jac_to_affine(joracle.msm(vals, pts, joracle.FQ2_OPS), joracle.FQ2_OPS)
    Ae = expand_bases(FQ2_ADAPTER, A, w, factor)
    sc_c, A_c = chunk_msm_inputs(sc, Ae, 2, segments=factor)
    got = msm_g2_sharded(sc_c, A_c, window_bits=w, factor=factor)
    ints = lambda P: g2.jacobian_to_ints(tuple(c[..., None] for c in P))[0]
    assert ints(got) == want
    assert ints(msm_precomputed(FQ2_ADAPTER, sc, Ae, window_bits=w, factor=factor)) == want


def test_msm_sharded_refuses_inputs_it_cannot_run():
    sc = torch.zeros(2, 16, 4, dtype=torch.int32)
    A = (torch.zeros(2, 24, 4, dtype=torch.int32), torch.zeros(2, 24, 4, dtype=torch.int32),
         torch.ones(2, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="disagree on the chunk count"):
        msm_chunked(FQ_ADAPTER, sc[:1], A)
    with pytest.raises(ValueError, match="not on the mesh's device"):
        msm_g1_sharded(sc, A, Mesh(None, 0, 1, torch.device("meta")))
    with pytest.raises(ValueError, match="msm_sharded: a mesh of 2 ranks has no process"):
        msm_g1_sharded(sc[:1], tuple(c[:1] for c in A), Mesh(None, 1, 2, CPU))
