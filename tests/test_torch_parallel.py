"""The scale-out layer of the PyTorch/CUDA port (``parallel/``,
``msm_chunked``) against the JAX package, on the CPU in one process.

Layouts and tables are compared limb for limb: ``split_sizes``,
``chunk_msm_inputs`` (the JAX package's eager reshapes), each rank's rows of
the step twiddles (the port's mesh at rank r of p, the JAX package's on p of
conftest's CPU devices), and ``ntt_sharded`` on a one-rank mesh against the
JAX package's on two devices, natural and transposed (the global layout does
not depend on p).  The inverse, coset and batch forms are held to the JAX
package's single-device NTTs.  The sharded MSMs are ``test_torch_parallel_msm.py``,
which runs beside this file; the multi-rank runs are in
``test_torch_parallel_dist.py``.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_bls12_381.ntt import coset_intt as j_coset_intt, coset_ntt as j_coset_ntt
from tpu_bls12_381.ntt import intt as j_intt, ntt as j_ntt
from tpu_bls12_381.parallel import build_step_twiddles as j_step_twiddles
from tpu_bls12_381.parallel import default_mesh as j_default_mesh
from tpu_bls12_381.parallel import ntt_sharded as j_ntt_sharded
from tpu_bls12_381.parallel.msm import chunk_msm_inputs as j_chunk_msm_inputs
from tpu_bls12_381.parallel.ntt import split_sizes as j_split_sizes

import tpu_bls12_381_torch.parallel as parallel
from tpu_bls12_381_torch import constants
from tpu_bls12_381_torch.parallel import (build_step_twiddles, coset_intt_sharded,
                                          coset_ntt_sharded, default_mesh, init_distributed,
                                          intt_sharded, ntt_batch_sharded, ntt_sharded)
from tpu_bls12_381_torch.parallel.mesh import Mesh, local_block
from tpu_bls12_381_torch.parallel.msm import chunk_msm_inputs, shard_msm_inputs
from tpu_bls12_381_torch.parallel.ntt import coset_powers_sharded, split_sizes
from tpu_bls12_381_torch.runtime import Accelerator, Config, config, reset_config_cache

from torch_shared import fr_mont_limbs, limbs_to_tensor as T

torch.set_num_threads(1)

R_MOD = constants.FR_MODULUS
SHIFT = constants.FR_MULTIPLICATIVE_GENERATOR
LOG_N = 8
CPU = torch.device("cpu")


def U(t):
    """The port's limbs -> numpy uint32, the JAX package's dtype."""
    return t.numpy().astype(np.uint32)


def _fr_vector(seed, n):
    rng = np.random.default_rng(seed)
    return fr_mont_limbs([int.from_bytes(rng.bytes(32), "little") for _ in range(n)])


def _one_rank():
    return default_mesh(device="cpu")


# -----------------------------------------------------------------------------
# Layouts and tables, limb for limb
# -----------------------------------------------------------------------------

def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:          # log_n below log2(p): a negative shift
        return type(e)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_split_sizes_match_jax(p):
    for log_n in range(1, 25):
        assert _outcome(split_sizes, log_n, p) == _outcome(j_split_sizes, log_n, p), log_n


@pytest.mark.parametrize("segments", [1, 2, 4])
def test_chunk_msm_inputs_match_jax(segments):
    rng = np.random.default_rng(segments)
    n_sc, D = 16, 4
    n_pts = n_sc * segments
    sc = rng.integers(0, 1 << 16, size=(16, n_sc), dtype=np.int32)
    x = rng.integers(0, 1 << 16, size=(24, n_pts), dtype=np.int32)
    y = rng.integers(0, 1 << 16, size=(24, n_pts), dtype=np.int32)
    inf = rng.integers(0, 2, size=n_pts).astype(bool)
    got_sc, got_A = chunk_msm_inputs(torch.from_numpy(sc), tuple(
        torch.from_numpy(a) for a in (x, y, inf)), D, segments=segments)
    want_sc, want_A = j_chunk_msm_inputs(jnp.asarray(sc), tuple(
        jnp.asarray(a) for a in (x, y, inf)), D, segments=segments)
    assert np.array_equal(got_sc.numpy(), np.asarray(want_sc))
    for g, w in zip(got_A, want_A):
        assert g.shape == w.shape and np.array_equal(g.numpy(), np.asarray(w))
    # shard_msm_inputs is this rank's chunk, from the full arrays or its own block
    for rank in range(D):
        mesh = Mesh(None, rank, D, CPU)
        one_sc, one_A = shard_msm_inputs(torch.from_numpy(sc), tuple(
            torch.from_numpy(a) for a in (x, y, inf)), mesh, segments=segments)
        assert torch.equal(one_sc, got_sc[rank:rank + 1])
        assert all(torch.equal(a, b[rank:rank + 1]) for a, b in zip(one_A, got_A))
        # a rank that holds only its own block lays it out as one chunk
        own_sc, own_A = chunk_msm_inputs(got_sc[rank], tuple(c[rank] for c in got_A), 1,
                                         segments=segments)
        assert torch.equal(own_sc, one_sc)
        assert all(torch.equal(a, b) for a, b in zip(own_A, one_A))


@pytest.mark.parametrize("n_sc,n_pts,D,segments", [(16, 16, 3, 1), (16, 18, 2, 2),
                                                   (15, 30, 2, 2), (8, 12, 4, 4)])
def test_chunk_msm_inputs_refuse_sizes_as_jax(n_sc, n_pts, D, segments):
    sc = np.zeros((16, n_sc), np.int32)
    A = (np.zeros((24, n_pts), np.int32), np.zeros((24, n_pts), np.int32),
         np.zeros(n_pts, bool))
    with pytest.raises(ValueError, match="not divisible") as mine:
        chunk_msm_inputs(torch.from_numpy(sc), tuple(torch.from_numpy(a) for a in A), D,
                         segments=segments)
    with pytest.raises(ValueError) as theirs:
        j_chunk_msm_inputs(jnp.asarray(sc), tuple(jnp.asarray(a) for a in A), D,
                           segments=segments)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("p,inverse", [(1, False), (2, False), (4, False), (2, True)])
def test_step_twiddles_rows_match_jax(p, inverse):
    nA, nB = split_sizes(LOG_N, p)
    want = np.asarray(j_step_twiddles(LOG_N, nA, nB, inverse, j_default_mesh(p)))
    rows = nA // p
    for rank in range(p):
        got = build_step_twiddles(LOG_N, nA, nB, inverse, Mesh(None, rank, p, CPU))
        assert np.array_equal(U(got), want[:, rank * rows:(rank + 1) * rows])


def test_coset_powers_sharded_are_the_ranks_columns():
    n, p = 1 << LOG_N, 4
    want = fr_mont_limbs([pow(SHIFT, i, R_MOD) for i in range(n)])
    for rank in range(p):
        mesh = Mesh(None, rank, p, CPU)
        got = coset_powers_sharded(SHIFT, n, mesh)
        assert np.array_equal(U(got), want[:, local_block(mesh, n)[-1]])


# -----------------------------------------------------------------------------
# The sharded NTT
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def x_ntt():
    return _fr_vector(11, 1 << LOG_N)


@pytest.mark.parametrize("transposed_out", [False, True])
def test_ntt_sharded_matches_jax_sharded(x_ntt, transposed_out):
    got = ntt_sharded(T(x_ntt), _one_rank(), transposed_out=transposed_out)
    want = j_ntt_sharded(jnp.asarray(x_ntt), j_default_mesh(2), transposed_out=transposed_out)
    assert np.array_equal(U(got), np.asarray(want))
    if transposed_out:
        nA, nB = split_sizes(LOG_N, 1)
        nat = ntt_sharded(T(x_ntt), _one_rank())
        assert torch.equal(got.reshape(16, nB, nA), nat.reshape(16, nA, nB).transpose(1, 2))


@pytest.mark.parametrize("transposed", [False, True])
def test_intt_and_coset_sharded_match_jax_single_device(x_ntt, transposed):
    mesh, x = _one_rank(), T(x_ntt)
    y = ntt_sharded(x, mesh, transposed_out=transposed)
    back = intt_sharded(y, mesh, transposed_in=transposed)
    assert torch.equal(back, x)
    nat = ntt_sharded(x, mesh)
    assert np.array_equal(U(intt_sharded(nat, mesh)), np.asarray(j_intt(jnp.asarray(U(nat)))))
    ev = coset_ntt_sharded(x, mesh, SHIFT, transposed_out=transposed)
    want_ev = np.asarray(j_coset_ntt(jnp.asarray(x_ntt), SHIFT))
    if transposed:
        nA, nB = split_sizes(LOG_N, 1)
        want_ev = want_ev.reshape(16, nA, nB).transpose(0, 2, 1).reshape(16, -1)
    assert np.array_equal(U(ev), want_ev)
    got_back = coset_intt_sharded(ev, mesh, SHIFT, transposed_in=transposed)
    assert torch.equal(got_back, x)
    if not transposed:
        assert np.array_equal(U(got_back), np.asarray(j_coset_intt(jnp.asarray(U(ev)), SHIFT)))


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_batch_sharded_matches_jax(inverse):
    x = np.stack([_fr_vector(20 + b, 1 << LOG_N) for b in range(4)], axis=1)  # (16, 4, n)
    got = ntt_batch_sharded(T(x), _one_rank(), inverse=inverse)
    want = (j_intt if inverse else j_ntt)(jnp.asarray(x))
    assert np.array_equal(U(got), np.asarray(want))


def test_ntt_sharded_refuses_sizes_as_jax():
    mesh = _one_rank()
    with pytest.raises(ValueError, match="power of two"):
        ntt_sharded(torch.zeros(16, 12, dtype=torch.int32), mesh)
    with pytest.raises(ValueError, match="too small to split over 8 devices"):
        ntt_sharded(torch.zeros(16, 2, dtype=torch.int32), Mesh(None, 0, 8, CPU))


# -----------------------------------------------------------------------------
# The mesh, the configuration, backend_info
# -----------------------------------------------------------------------------

def test_init_distributed_without_a_coordinator(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert init_distributed() is False
    mesh = default_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, CPU)
    assert default_mesh(1, device="cpu") == mesh
    with pytest.raises(ValueError, match="one a device"):
        default_mesh(2, device="cpu")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    with pytest.raises(ValueError, match="WORLD_SIZE, RANK"):
        init_distributed()
    assert parallel.shard_axis() == "shards"
    assert sorted(parallel.__all__) == sorted(importlib.import_module(
        "tpu_bls12_381.parallel").__all__)


def test_local_block_and_one_rank_collectives():
    mesh = Mesh(None, 2, 4, CPU)
    x = torch.arange(3 * 8).reshape(3, 8)
    assert torch.equal(x[local_block(mesh, 8)], x[:, 4:6])
    assert torch.equal(x[local_block(mesh, 8, 1)], x[:, 4:6])
    y = torch.arange(4 * 3).reshape(4, 3)
    assert torch.equal(y[local_block(mesh, 4, 0)], y[2:3])
    with pytest.raises(ValueError, match="does not split"):
        local_block(mesh, 6)
    one = _one_rank()
    t = torch.arange(2 * 3 * 4).reshape(2, 3, 4)
    assert torch.equal(parallel.mesh.global_transpose(one, t), t.transpose(1, 2))
    assert parallel.mesh.all_gather_tree(one, (t,))[0] is t


def test_a_mesh_of_ranks_without_a_group_refuses_collectives(x_ntt):
    """A mesh of several ranks built without a process group serves its
    rank's tables, but a collective through it raises rather than return
    this rank's part as the whole."""
    mesh = Mesh(None, 1, 2, CPU)
    t = torch.zeros(2, 4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="global_transpose: a mesh of 2 ranks"):
        parallel.mesh.global_transpose(mesh, t)
    with pytest.raises(ValueError, match="all_gather_tree: a mesh of 2 ranks"):
        parallel.mesh.all_gather_tree(mesh, (t,))
    half = T(x_ntt)[:, :(1 << LOG_N) // 2].contiguous()
    for fn in (ntt_sharded, intt_sharded):
        with pytest.raises(ValueError, match="sharded NTT: a mesh of 2 ranks"):
            fn(half, mesh)
    with pytest.raises(ValueError, match="sharded NTT: a mesh of 2 ranks"):
        coset_ntt_sharded(half, mesh, SHIFT)
    # the batch form exchanges nothing: each rank's rows are its own
    xb = T(np.stack([_fr_vector(30 + b, 16) for b in range(2)], axis=1))[:, 1:]
    assert torch.equal(ntt_batch_sharded(xb, mesh), ntt_batch_sharded(xb, _one_rank()))


@pytest.mark.parametrize("value", [None, "none", "4"])
def test_config_does_not_read_sharding(monkeypatch, value):
    """MIDNIGHT_SHARDING, which the JAX package only prints, is not read:
    the world is what torchrun starts, and backend_info prints the mesh."""
    if value is None:
        monkeypatch.delenv("MIDNIGHT_SHARDING", raising=False)
    else:
        monkeypatch.setenv("MIDNIGHT_SHARDING", value)
    reset_config_cache()
    try:
        assert not hasattr(config(), "sharding")
        monkeypatch.delenv("MIDNIGHT_SHARDING", raising=False)
        assert Config.from_env() == config()
        info = Accelerator(max_ntt_log_n=2, device="cpu").backend_info().splitlines()
        assert "  mesh: rank 0 of 1" in info
        assert not any("sharding" in line for line in info)
    finally:
        reset_config_cache()
