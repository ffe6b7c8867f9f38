"""``msm_traceable`` of the PyTorch/CUDA port on the CPU.

The port's counterpart of the JAX package's one-trace MSM: ``msm``'s
contract with every shape taken from the inputs' shapes, no GLV, no memory
budget and no point pieces.  It is held here by value against the big-int
oracle and the golden vector, limb for limb against the port's ``msm(...,
glv=False)`` at the same window, and by the inputs it hands the window loop
(its sort keys against the JAX package's ``decompose_window_keys``, and
against those of ``msm(..., glv=False)``).  The JAX package's own
``msm_traceable`` is never called: XLA compiles its one graph for a very long
time on the CPU.

A port MSM on the CPU costs some 0.4 to 1 s a window, whatever N is;
without GLV at N = 64, w = 5 (52 windows of 16 buckets) costs less than
w = 8 (33 windows of 128), and at w = 5 the signed digit of r - 1 carries
into the extra top window.  The full calls here are five: the edge case
through both entries and in standard form, all-zero scalars, and the golden
vector (at the window the JAX package's heuristic picks).  Every case (r - 1
alone too) in both scalar forms also compares what the two entries hand the
shared window loop, which is cheap.  The G2 form is held by that comparison
here and by value on the card (``chip_smoke.py``'s ``msm_traceable`` phase:
2^16 tiled points against the host, the golden n = 1024 vector, eager and
replayed from a CUDA graph); a G2 MSM of even 8 points costs some 90 s on
one core.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_bls12_381 import oracle
from tpu_bls12_381.msm import pippenger as jpip

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch import msm as msm_pkg
from tpu_bls12_381_torch.curves import g1, g2
from tpu_bls12_381_torch.curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
from tpu_bls12_381_torch.msm import msm, msm_traceable, pippenger as pip

# The port's CPU path is thousands of tiny tensor ops: one thread is the
# fastest setting beside other test workers.
torch.set_num_threads(1)

N = 64
W = 5
R_MOD = constants.FR_MODULUS
VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def _host_points(n, seed=0xB15):
    rng = random.Random(seed)
    G = oracle.g1_generator()
    return [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 48), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(n)]


def _oracle_msm(vals, pts):
    return oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS), oracle.FQ_OPS)


def _scalars(vals, montgomery=True):
    limbs = ints_to_limbs([FR.to_mont(v) if montgomery else v for v in vals],
                          FR.num_limbs)
    return convert.scalars_from_numpy(limbs, device="cpu")


def _ints(P):
    return g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]


# Random scalars with every edge the cases name riding along: zero scalars,
# 1, r - 1 (its top window takes the signed-digit carry), digits at the
# signed boundary 2^(w-1) and 2^w - 1; identity points on every fifth lane.
_rng = random.Random(0x7ACE)
VALS = [_rng.randrange(R_MOD) for _ in range(N - 7)]
VALS += [0, 1, R_MOD - 1, 1 << (W - 1), (1 << W) - 1, 0, R_MOD - 1]
PTS = [None if i % 5 == 0 else p for i, p in enumerate(_host_points(N))]
CASES = {
    "edges": VALS,
    "all_zero": [0] * N,
    "r_minus_1": [0, R_MOD - 1] + [0] * (N - 2),
}


@pytest.fixture(scope="module")
def A():
    return g1.affine_from_ints(PTS, device="cpu")


@pytest.fixture(scope="module")
def msm_no_glv(A):
    """The port's msm with GLV off at w = 5 on the edge case: the limbs that
    msm_traceable must give."""
    return msm(FQ_ADAPTER, _scalars(VALS), A, window_bits=W, glv=False)


@pytest.fixture(scope="module")
def traceable(A):
    """msm_traceable on the edge case, with a memory budget of 1 MiB, GLV
    forced on, and the plan and the budget raising if they are asked: none
    of it may reach the call."""
    def refuse(*args, **kw):
        raise AssertionError("msm_traceable asked the MSM plan or the budget")

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MIDNIGHT_MSM_HBM_BUDGET_MB", "1")
        mp.setenv("MIDNIGHT_MSM_GLV", "on")
        mp.setattr(pip, "msm_geometry", refuse)
        mp.setattr(pip, "_available_budget", refuse)
        mp.setattr(pip, "_resolve_glv", refuse)
        return msm_traceable(FQ_ADAPTER, _scalars(VALS), A, window_bits=W)


class _Stop(Exception):
    pass


def _window_loop_inputs(monkeypatch, fn):
    """What ``fn()`` hands the window loop: (keys, A, w).  The loop itself
    does not run."""
    seen = []

    def record(F, keys, A, w):
        seen.append((F, keys, A, w))
        raise _Stop

    monkeypatch.setattr(pip, "_window_sums_from_keys", record)
    with pytest.raises(_Stop):
        fn()
    monkeypatch.undo()
    (F, keys, A, w), = seen
    return F, keys, A, w


def test_exported_from_the_msm_package():
    assert msm_pkg.msm_traceable is pip.msm_traceable
    assert "msm_traceable" in msm_pkg.__all__


def test_equals_the_oracle(traceable):
    assert all(tuple(c.shape) == (24,) and c.dtype == torch.int32 for c in traceable)
    assert _ints(traceable) == _oracle_msm(VALS, PTS)


def test_limbs_equal_msm_without_glv(traceable, msm_no_glv):
    for a, b in zip(traceable, msm_no_glv):
        assert torch.equal(a, b)


def test_standard_form_scalars(A, msm_no_glv):
    P = msm_traceable(FQ_ADAPTER, _scalars(VALS, montgomery=False), A,
                      window_bits=W, scalars_montgomery=False)
    for a, b in zip(P, msm_no_glv):
        assert torch.equal(a, b)
    assert _ints(P) == _oracle_msm(VALS, PTS)


def test_all_zero_scalars_give_the_identity(A):
    assert _ints(msm_traceable(FQ_ADAPTER, _scalars(CASES["all_zero"]), A,
                               window_bits=W)) is None


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("montgomery", [True, False])
def test_window_loop_gets_msm_without_glv_inputs(monkeypatch, A, case, montgomery):
    """Every case, in both scalar forms: msm_traceable hands the window loop
    the sort keys, points and window of msm(..., glv=False), and the keys are
    the JAX package's decompose_window_keys at 255 bits.  Both entries then
    run the one window loop and ``_horner_to_jac`` on those inputs."""
    vals = CASES[case]
    sc = _scalars(vals, montgomery)
    kw = dict(window_bits=W, scalars_montgomery=montgomery)
    F, keys, At, w = _window_loop_inputs(
        monkeypatch, lambda: msm_traceable(FQ_ADAPTER, sc, A, **kw))
    Fm, keys_m, Am, wm = _window_loop_inputs(
        monkeypatch, lambda: msm(FQ_ADAPTER, sc, A, glv=False, **kw))
    assert F is Fm is FQ_ADAPTER and w == wm == W
    assert torch.equal(keys, keys_m)
    assert all(torch.equal(a, b) for a, b in zip(At, Am))
    want = jpip.decompose_window_keys(
        jnp.asarray(ints_to_limbs([v % R_MOD for v in vals], FR.num_limbs)), W)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want).astype(np.int64))


def test_g2_window_loop_gets_msm_g2_inputs(monkeypatch):
    """G2: the same inputs to the window loop as msm over FQ2_ADAPTER, at
    the window the JAX package's heuristic gives n (its msm_traceable's)."""
    rng = random.Random(0x62)
    G2 = oracle.g2_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 16), G2,
                                                  oracle.FQ2_OPS), oracle.FQ2_OPS)
           for _ in range(8)]
    A2 = g2.affine_from_ints(pts, device="cpu")
    sc = _scalars([rng.randrange(R_MOD) for _ in range(8)])
    F, keys, At, w = _window_loop_inputs(
        monkeypatch, lambda: msm_traceable(FQ2_ADAPTER, sc, A2))
    Fm, keys_m, Am, wm = _window_loop_inputs(
        monkeypatch, lambda: msm(FQ2_ADAPTER, sc, A2))
    assert F is Fm is FQ2_ADAPTER
    assert w == wm == jpip.window_bits_for(8, jpip.FQ2_ADAPTER)
    assert torch.equal(keys, keys_m)
    assert all(torch.equal(a, b) for a, b in zip(At, Am))


def test_golden_vector_1024():
    """The reference's published point, at the window msm_traceable picks
    for n = 1024 (the JAX package's heuristic)."""
    with open(os.path.join(VEC_DIR, "msm_g1_vectors.json")) as f:
        case = next(c for c in json.load(f)["cases"] if c["n"] == 1024)
    vals = [int(s, 16) for s in case["scalars"]]
    pts = [(int(p["x"], 16), int(p["y"], 16)) for p in case["points"]]
    assert pip.window_bits_for(1024, FQ_ADAPTER, "cpu") == \
        jpip.window_bits_for(1024, jpip.FQ_ADAPTER)
    P = msm_traceable(FQ_ADAPTER, _scalars(vals), g1.affine_from_ints(pts, device="cpu"))
    assert _ints(P) == (int(case["expected"]["x"], 16), int(case["expected"]["y"], 16))


def test_refuses_what_msm_refuses(A):
    sc = _scalars([1] * N)
    with pytest.raises(TypeError):
        msm_traceable(FQ_ADAPTER, sc.to(torch.int64), A)
    with pytest.raises(ValueError):
        msm_traceable(FQ_ADAPTER, sc[:, :4], A)
    with pytest.raises(NotImplementedError):
        msm_traceable(object(), sc, A)
