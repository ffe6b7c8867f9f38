"""The doubling chain of the PyTorch/CUDA port against the TPU kernel it
replaces: ``cuda_g1.pdbl`` with ``times`` (its lane body compiled for the host
from ``csrc/host_check.cpp``) against the JAX package's Pallas ``pdbl``
(``curves/pallas_g1.py``, ``_pdbl_kernel``) in interpret mode, applied
``times`` times, limb for limb.

A file of its own: compiling the Pallas kernel in interpret mode takes one
to two minutes on the CPU, which ``--dist loadfile`` then runs beside the
other files.  ``tests/test_torch_chains.py`` holds the same chain against the
plain versions and the JAX package's ``proj_double``.
"""

import ctypes
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bls12_381.curves import pallas_g1

from tpu_bls12_381_torch import oracle
from tpu_bls12_381_torch.curves import cuda_g1, g1, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import FQ_PLAIN

from torch_shared import host_check_library

torch.set_num_threads(1)

N = 8
TIMES = (1, 2, 15)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_check_library(tmp_path_factory)


@pytest.fixture(scope="module")
def points():
    """Projective G1 points with Z != 1 on N lanes; lane 0 the identity."""
    rng = random.Random(23)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 40), G,
                                                  oracle.FQ_OPS), oracle.FQ_OPS)
           for _ in range(N)]
    A = g1.affine_from_ints(pts, device="cpu")
    P = [c.clone() for c in pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, A))]
    ident = pj.proj_identity(FQ_PLAIN, (N,), "cpu")
    for c in range(3):
        P[c][:, 0] = ident[c][:, 0]
    return tuple(c.contiguous() for c in P)


@pytest.fixture(scope="module")
def pallas_chain(points):
    """The Pallas ``pdbl`` applied 1 to max(TIMES) times: times -> coords."""
    J = tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in points)
    out = {}
    for t in range(1, max(TIMES) + 1):
        J = jax.block_until_ready(pallas_g1.pdbl(J))
        if t in TIMES:
            out[t] = tuple(np.asarray(c) for c in J)
    return out


@pytest.mark.parametrize("times", TIMES)
def test_pdbl_chain_matches_the_pallas_kernel(lib, points, pallas_chain, times):
    """One chain of ``times`` doublings in the port's kernel body equals
    ``times`` launches of the TPU kernel, limb for limb (the identity lane
    included)."""
    out = [torch.empty_like(points[0]) for _ in range(3)]
    lib.g1_pdbl(*[ctypes.c_void_p(t.data_ptr()) for t in (*points, *out)],
                ctypes.c_size_t(N), ctypes.c_int(times))
    for o, w in zip(out, pallas_chain[times]):
        np.testing.assert_array_equal(o.numpy().astype(np.uint32), w)
    assert all(torch.equal(o, w) for o, w in zip(out, cuda_g1.pdbl_plain(points, times)))
