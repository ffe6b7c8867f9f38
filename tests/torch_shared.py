"""Helpers that test files of the PyTorch/CUDA port share: the host build of
``csrc/host_check.cpp`` (``test_torch_csrc_host.py``,
``test_torch_csrc_jac_ladder.py``, ``test_torch_chains.py``,
``test_torch_pdbl_pallas.py``), and, for the layers whose costly tests sit
in a second file of few tests (``--dist loadfile`` hands files of many tests
out first, ahead of the JAX package's long ``tests/test_msm.py``), the seeded
G1 point set and the port's and the oracle's MSM (``test_torch_msm.py``,
``test_torch_msm_cases.py``) and the Montgomery limbs of Fr scalars
(``test_torch_parallel.py``, ``test_torch_parallel_msm.py``).  Not a test
module: pytest collects nothing here.
"""

import ctypes
import os
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_bls12_381 import oracle
from tpu_bls12_381.fields.limbs import ints_to_limbs

from tpu_bls12_381_torch import constants, convert
from tpu_bls12_381_torch.curves import g1
from tpu_bls12_381_torch.fields import FR
from tpu_bls12_381_torch.msm import msm_g1

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tpu_bls12_381_torch", "csrc")


def host_check_library(tmp_path_factory):
    """``csrc/host_check.cpp`` built with the host's C++ compiler into this
    worker's temporary directory and loaded (the test is skipped where the
    host has no compiler)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler (g++ / c++) on this machine")
    out = tmp_path_factory.mktemp("host_check") / "libhost_check.so"
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(out), os.path.join(CSRC, "host_check.cpp")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


def ptr(t):
    """A tensor's data as a C pointer (its last axis unit-strided)."""
    assert t.is_contiguous() or t.stride(-1) == 1
    return ctypes.c_void_p(t.data_ptr())


def host_g1_points(n, seed=0xB15):
    """n affine multiples of G by random 48-bit scalars, as host integers."""
    rng = random.Random(seed)
    G = oracle.g1_generator()
    return [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 48), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(n)]


def fr_mont_limbs(vals):
    """Montgomery-form (16, n) uint32 limbs of Fr scalars (reduced mod r
    first), as the JAX package takes them."""
    return ints_to_limbs([FR.to_mont(v % constants.FR_MODULUS) for v in vals],
                         FR.num_limbs)


def limbs_to_tensor(a):
    """numpy limbs -> the port's int32 tensor on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


def oracle_msm_g1(vals, pts):
    """The big-int oracle's G1 MSM, affine (None for the identity)."""
    return oracle.jac_to_affine(oracle.msm(vals, pts, oracle.FQ_OPS), oracle.FQ_OPS)


def port_msm_g1(vals, pts, **kw):
    """The port's ``msm_g1`` on CPU tensors, affine (None for the identity)."""
    A = g1.affine_from_ints(pts, device="cpu")
    P = msm_g1(convert.scalars_from_numpy(fr_mont_limbs(vals), device="cpu"), A, **kw)
    assert all(tuple(c.shape) == (24,) and c.dtype == torch.int32 for c in P)
    return g1.jacobian_to_ints(tuple(c[:, None] for c in P))[0]
