"""The G1 MSM of the PyTorch/CUDA port on the CPU against the big-int
oracle: its edge cases (GLV on and off, zero scalars, identity points, the
scalar r - 1, standard-form scalars) and a point set that the memory budget
cuts into pieces.  ``tests/test_torch_msm.py`` holds the port against the JAX
package; the two files run side by side (a port MSM on the CPU costs about
a second a window, and each case here is one MSM).
"""

import random

import pytest
import torch

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import g1
from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER
from tpu_bls12_381_torch.curves.glv import GLV_LAMBDA
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
from tpu_bls12_381_torch.msm import msm_g1, msm_geometry, pippenger as pip

from torch_shared import fr_mont_limbs, host_g1_points, oracle_msm_g1, port_msm_g1

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)

N = 64
R_MOD = constants.FR_MODULUS


@pytest.fixture(scope="module")
def points():
    return host_g1_points(N)


# At N = 64 windows of 5 to 7 bits cost least on the CPU, though they are
# more: a window of 8 or 9 bits sums four to eight times the buckets.
CASES = {
    "glv_on_window_6": dict(kw=dict(glv=True, window_bits=6)),
    # 255-bit windows: at w = 5 the r-1 edge scalar carries its signed digit
    # into the extra top window
    "glv_off_window_5": dict(kw=dict(glv=False, window_bits=5)),
    "all_zero_scalars": dict(kw=dict(glv=True, window_bits=6), zeros=True),
    "identity_points": dict(kw=dict(glv=True, window_bits=6), holes=True),
    "scalar_r_minus_1": dict(kw=dict(glv=True, window_bits=6), rm1=True),
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
        got = port_msm_g1(vals, pts, **kw)
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
        assert got == oracle_msm_g1(vals, pts)


def test_msm_chunks_when_the_budget_needs_more_than_one_piece(points, monkeypatch):
    A = g1.affine_from_ints(points, device="cpu")
    sc = convert.scalars_from_numpy(fr_mont_limbs([1] * N), device="cpu")
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
    sc = convert.scalars_from_numpy(fr_mont_limbs(vals), device="cpu")
    got = g1.jacobian_to_ints(msm_g1(sc, A, glv=True, window_bits=9))[0]
    assert got == oracle_msm_g1(vals, points)
    monkeypatch.setattr(pip, "_available_budget", lambda device: (N // 4) * bpp)
    # GLV "auto" follows the same budget: on only while 2n points fit
    assert not msm_geometry(N, device="cpu")["glv"]
    monkeypatch.setattr(pip, "_available_budget", lambda device: 2 * N * bpp)
    assert msm_geometry(N, device="cpu")["glv"]
