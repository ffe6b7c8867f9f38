"""The chained kernels of the PyTorch/CUDA port, on the CPU: the doubling chains
(``cuda_g1.pdbl`` and ``cuda_g2.pdbl2`` with ``times``) and Montgomery's
batch inversion in three kernels (``csrc/batch_inverse.cu``,
``vecops.batch_inverse``).

Both kernels keep a chain of dependent field work in registers, one launch a
chain.  Their device code compiles as host C++ (``csrc/host_check.cpp``), so
the lane bodies run here in loops over the lanes, phase 2's block scans as
host loops, and are held limb for limb against the plain versions and
against the JAX package: ``pdbl`` against ``projective.proj_double`` applied
``times`` times (``tests/test_torch_pdbl_pallas.py`` holds it against the
Pallas ``pdbl`` in interpret mode, whose compile takes over a minute),
``pdbl2`` against the package's ``_double_n`` over its Fq2 adapter, the
batch inversion against ``tpu_bls12_381.vecops.batch_inverse``.
The routers around them (``projective.proj_double_n_fast``,
``pippenger._double_n``, ``vecops.batch_inverse_tile``) and the plan's count
of doubling chains are checked too.  Integer arithmetic with canonical
results: every comparison is exact.
"""

import ctypes
import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bls12_381 import vecops as jvecops
from tpu_bls12_381.curves import projective as jpj
from tpu_bls12_381.curves.field_adapters import FQ2_ADAPTER as JF2, FQ_ADAPTER as JF
from tpu_bls12_381.fields import FQ as JFQ, FR as JFR
from tpu_bls12_381.msm import pippenger as jpip

from tpu_bls12_381_torch import convert, oracle, tuning, vecops
from tpu_bls12_381_torch.curves import cuda_g1, cuda_g2, g1, g2, projective as pj
from tpu_bls12_381_torch.curves.field_adapters import (FQ2_ADAPTER, FQ2_PLAIN, FQ_ADAPTER,
                                                       FQ_PLAIN)
from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, ops
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs
from tpu_bls12_381_torch.msm import msm_geometry, pippenger as pip

from torch_shared import host_check_library

torch.set_num_threads(1)

N = 96
N2 = 32                # G2 lanes
SZ = ctypes.c_size_t
SPECS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_check_library(tmp_path_factory)


def _ptr(t):
    assert t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _elements(spec, n, seed):
    """(K, n) canonical elements; the first lanes hold 0, 1, p - 1, p - 2
    and R mod p."""
    rng = random.Random(seed)
    p = spec.modulus
    vals = [0, 1, p - 1, p - 2, spec.r % p][:n]
    vals += [rng.randrange(p) for _ in range(n - len(vals))]
    return torch.from_numpy(ints_to_limbs(vals, spec.num_limbs).astype(np.int32)).contiguous()


def _jnp(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), np.asarray(want))


@pytest.fixture(scope="module")
def points():
    """Projective G1 points with Z != 1 on N lanes; lane 0 the identity."""
    rng = random.Random(11)
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
def points2():
    """Projective G2 points with Z != 1 on N2 lanes; lane 0 the identity."""
    rng = random.Random(12)
    G = oracle.g2_generator()
    base = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 40), G,
                                                   oracle.FQ2_OPS), oracle.FQ2_OPS)
            for _ in range(8)]
    A = g2.affine_from_ints([base[i % 8] for i in range(N2)], device="cpu")
    P = [c.clone() for c in pj.proj_double(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, A))]
    ident = pj.proj_identity(FQ2_PLAIN, (N2,), "cpu")
    for c in range(3):
        P[c][..., 0] = ident[c][..., 0]
    return tuple(c.contiguous() for c in P)


def _fq2_same(got, want):
    """A (24, 2, n) tensor against a JAX (c0, c1) pair, limb for limb."""
    for g, w in zip(convert.fq2_to_numpy(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))


# -----------------------------------------------------------------------------
# The doubling chains
# -----------------------------------------------------------------------------


@pytest.mark.parametrize("curve,times", [
    pytest.param("g1", 1, id="1"), pytest.param("g1", 2, id="2"),
    pytest.param("g1", 15, id="15"), pytest.param("g2", 1, id="g2-1"),
    pytest.param("g2", 2, id="g2-2"), pytest.param("g2", 14, id="g2-14"),
])
def test_pdbl_chain_host(lib, points, points2, curve, times):
    """``g1_pdbl_lane`` / ``g2_pdbl_lane`` with ``times`` (the kernels'
    bodies, on the carry-chain product) against ``pdbl_plain(P, times)`` /
    ``pdbl2_plain(P, times)`` and the JAX package's doubling applied
    ``times`` times (G2: its ``_double_n`` over the Fq2 adapter), limb for
    limb, with an identity lane."""
    P, n = (points, N) if curve == "g1" else (points2, N2)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    getattr(lib, f"{curve}_pdbl")(*[_ptr(t) for t in (*P, *out)], SZ(n),
                                  ctypes.c_int(times))
    plain = cuda_g1.pdbl_plain if curve == "g1" else cuda_g2.pdbl2_plain
    want = plain(P, times)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not out[2][..., 0].any()                 # 2^k * identity = identity
    if curve == "g2":
        J = tuple(tuple(jnp.asarray(a) for a in convert.fq2_to_numpy(c)) for c in P)
        for o, j in zip(out, jpip._double_n(JF2, J, times)):
            _fq2_same(o, j)
        return
    dbl = jax.jit(lambda P: jpj.proj_double(JF, P))
    J = tuple(map(_jnp, P))
    for _ in range(times):
        J = dbl(J)
    for o, j in zip(out, J):
        _same(o, j)


def test_pdbl_wrapper_on_the_cpu(points):
    """On CPU tensors ``pdbl`` is its plain version at any count and
    launches nothing; a count below 1 raises."""
    before, chains = dict(cuda_g1.LAUNCHES), dict(cuda_g1.CHAIN_LAUNCHES)
    got = cuda_g1.pdbl(points, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, cuda_g1.pdbl_plain(points, 3)))
    assert all(torch.equal(g, w) for g, w in zip(cuda_g1.pdbl(points), pj.proj_double(
        FQ_PLAIN, points)))
    assert cuda_g1.LAUNCHES == before and cuda_g1.CHAIN_LAUNCHES == chains
    with pytest.raises(ValueError, match="times"):
        cuda_g1.pdbl(points, 0)


def test_pdbl2_wrapper_on_the_cpu(points2):
    """On CPU tensors ``pdbl2`` is its plain version at any count and
    launches nothing; a count below 1 raises."""
    before, chains = dict(cuda_g2.LAUNCHES), dict(cuda_g2.CHAIN_LAUNCHES)
    got = cuda_g2.pdbl2(points2, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, cuda_g2.pdbl2_plain(points2, 3)))
    want = pj.proj_double(FQ2_PLAIN, pj.proj_double(FQ2_PLAIN, pj.proj_double(
        FQ2_PLAIN, points2)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_g2.LAUNCHES == before and cuda_g2.CHAIN_LAUNCHES == chains
    with pytest.raises(ValueError, match="times"):
        cuda_g2.pdbl2(points2, 0)


@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_double_n_through_the_router_matches_jax(curve):
    """``pippenger._double_n`` (the router ``proj_double_n_fast``) against
    the JAX package's ``_double_n`` (a ``fori_loop``) on a few lanes."""
    rng = np.random.default_rng(5)
    if curve == "g1":
        F, JFa, times, lanes = FQ_ADAPTER, JF, 7, 8
        pts = [oracle.jac_to_affine(oracle.scalar_mul(int(k), oracle.g1_generator(),
                                                      oracle.FQ_OPS), oracle.FQ_OPS)
               for k in rng.integers(1, 1 << 30, size=lanes)]
        P = pj.affine_to_proj(F, g1.affine_from_ints(pts, device="cpu"))
        J = tuple(map(_jnp, P))
    else:
        F, JFa, times, lanes = FQ2_ADAPTER, JF2, 3, 4
        pts = [oracle.jac_to_affine(oracle.scalar_mul(int(k), oracle.g2_generator(),
                                                      oracle.FQ2_OPS), oracle.FQ2_OPS)
               for k in rng.integers(1, 1 << 30, size=lanes)]
        P = pj.affine_to_proj(F, g2.affine_from_ints(pts, device="cpu"))
        J = tuple(tuple(jnp.asarray(a) for a in convert.fq2_to_numpy(c)) for c in P)
    got = pip._double_n(F, P, times)
    want = jpip._double_n(JFa, J, times)
    for g, w in zip(got, want):
        if curve == "g1":
            _same(g, w)
        else:
            np.testing.assert_array_equal(convert.fq2_from_numpy(
                tuple(np.asarray(x) for x in w), device="cpu").numpy(), g.numpy())
    assert pip._double_n(F, P, 0) is P


def test_horner_and_triangle_take_one_chain_a_call(monkeypatch):
    """With the chains routed to the kernel wrappers (as on the card), the
    triangle combine and Horner make one ``pdbl`` (G1) or ``pdbl2`` (G2)
    call a chain with the chain's length, ``expand_bases`` one a block past
    the first, and the result is the looped doubling's."""
    calls = {"g1": [], "g2": []}

    def counted(curve, real):
        def wrapper(P, times=1):
            calls[curve].append(times)
            return real(P, times)
        return wrapper

    g1_chain = counted("g1", cuda_g1.pdbl)
    g2_chain = counted("g2", cuda_g2.pdbl2)
    monkeypatch.setattr(pj, "doubling_chain_kernel",
                        lambda F, device: {FQ_ADAPTER: g1_chain,
                                           FQ2_ADAPTER: g2_chain}.get(F))
    rng = np.random.default_rng(8)
    pts = [oracle.jac_to_affine(oracle.scalar_mul(int(k), oracle.g1_generator(),
                                                  oracle.FQ_OPS), oracle.FQ_OPS)
           for k in rng.integers(1, 1 << 30, size=3)]
    W = tuple(c.T.contiguous() for c in pj.affine_to_proj(      # (T, 24): 3 windows
        FQ_ADAPTER, g1.affine_from_ints(pts, device="cpu")))
    got = pip._stage_horner(FQ_ADAPTER, W, 5)
    assert calls["g1"] == [5, 5]
    want = tuple(c[2] for c in W)
    for t in (1, 0):
        want = pj.proj_add(FQ_PLAIN, cuda_g1.pdbl_plain(want, 5), tuple(c[t] for c in W))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    calls["g1"].clear()
    one = tuple(c[0] for c in W)
    pip._stage_triangle_combine(FQ_ADAPTER, one, one, one, 7)
    assert calls["g1"] == [7]
    calls["g1"].clear()

    # G2 is chained too: one pdbl2 call a chain (it made a launch a doubling
    # before the G2 chain kernel)
    pts2 = [oracle.jac_to_affine(oracle.scalar_mul(int(k), oracle.g2_generator(),
                                                   oracle.FQ2_OPS), oracle.FQ2_OPS)
            for k in rng.integers(1, 1 << 30, size=3)]
    A2 = g2.affine_from_ints(pts2, device="cpu")
    W2 = tuple(c.permute(2, 0, 1).contiguous()                 # (T, 24, 2)
               for c in pj.affine_to_proj(FQ2_ADAPTER, A2))
    got = pip._stage_horner(FQ2_ADAPTER, W2, 3)
    assert calls["g2"] == [3, 3]
    want = tuple(c[2] for c in W2)
    for t in (1, 0):
        want = pj.proj_add(FQ2_PLAIN, cuda_g2.pdbl2_plain(want, 3), tuple(c[t] for c in W2))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    calls["g2"].clear()
    one2 = tuple(c[0] for c in W2)
    pip._stage_triangle_combine(FQ2_ADAPTER, one2, one2, one2, 7)
    assert calls["g2"] == [7]
    calls["g2"].clear()
    # expand_bases at factor 3 over 8-bit scalars, w = 2: T' = 2, span 4
    got = pip.expand_bases(FQ2_ADAPTER, A2, 2, 3, num_bits=8)
    assert calls["g2"] == [4, 4] and calls["g1"] == []
    cur = pj.affine_to_proj(FQ2_PLAIN, A2)
    blocks = [A2]
    for _ in range(2):
        cur = cuda_g2.pdbl2_plain(cur, 4)
        blocks.append(pj.proj_to_affine(FQ2_PLAIN, cur))
    for c in range(3):
        assert torch.equal(got[c], torch.cat([b[c] for b in blocks], dim=-1))


def test_plan_counts_the_doubling_chains():
    """The single shot at 2^20 (GLV, w = 15, T = 9, lb_bits 7): T triangle
    chains and T - 1 Horner chains, 17 launches for 183 doublings."""
    geo = msm_geometry(1 << 20, True, device="cpu")
    T, lb, w = geo["T"], geo["lb_bits"], geo["w"]
    assert geo["doubling_chains"] == T + T - 1
    assert geo["doublings"] == T * lb + (T - 1) * w
    assert (T, lb, w, geo["doubling_chains"], geo["doublings"]) == (9, 7, 15, 17, 183)


def test_plan_counts_the_g2_doubling_chains():
    """The G2 single shot at 2^20 (w = 14, T = 20, lb_bits 7): T triangle
    chains and T - 1 Horner chains, 39 ``pdbl2`` launches for 406
    doublings; the cached call at factor 2 (T' = 10) 19 for 196."""
    geo = msm_geometry(1 << 20, F=FQ2_ADAPTER, device="cpu")
    T, lb, w = geo["T"], geo["lb_bits"], geo["w"]
    assert geo["doubling_chains"] == T + T - 1
    assert geo["doublings"] == T * lb + (T - 1) * w
    assert (T, lb, w, geo["doubling_chains"], geo["doublings"]) == (20, 7, 14, 39, 406)
    geo_c = msm_geometry(1 << 20, False, FQ2_ADAPTER, "cpu", 14, factor=2, cached=True)
    assert (geo_c["T"], geo_c["doubling_chains"], geo_c["doublings"]) == (10, 19, 196)


# -----------------------------------------------------------------------------
# The carry-chain product for Fr, and the batch inversion
# -----------------------------------------------------------------------------


def test_carry_chain_product_fr(lib):
    """``fp_mul_cc<Fr>``'s two chains (8 words, as C++ with an explicit
    carry) against the plain product: a*b, a*a, b*a."""
    a = _elements(FR, N, 31)
    b = _elements(FR, N, 32).flip(1).contiguous()
    out = torch.empty_like(a)
    for x, y in ((a, b), (a, a), (b, a)):
        lib.fr_mont_mul_carry(_ptr(x), _ptr(y), _ptr(out), SZ(N))
        assert torch.equal(out, cuda_ops.mont_mul_plain(FR, x, y))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_fermat_inverse_host(lib, name):
    """Phase 2's Fermat inverse (4-bit windows on the carry-chain product,
    the lane body of ``field_inv`` too) against the plain ``inv_mont`` on
    units."""
    spec = SPECS[name][0]
    a = _elements(spec, 33, 40)[:, 1:].contiguous()
    out = torch.empty_like(a)
    getattr(lib, f"{name}_field_inv")(_ptr(a), _ptr(out), SZ(a.shape[1]))
    assert torch.equal(out, ops.inv_mont(spec, a))


def _host_batch_inverse(lib, name, x, L, threads):
    spec = SPECS[name][0]
    K, n = spec.num_limbs, x.shape[1]
    R = -(-n // L)
    new = lambda m: torch.zeros((K, m), dtype=torch.int32)
    out, pre, col, colinv = new(n), new((R - 1) * L), new(L), new(L)
    getattr(lib, f"{name}_batch_inverse")(
        _ptr(x), _ptr(out), _ptr(pre), _ptr(col), _ptr(colinv), SZ(n), SZ(L),
        ctypes.c_int(R), SZ(threads))
    return out


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("n,L,threads", [
    (165, 64, 4),       # R = 3, the last row padded; runs of 16 columns
    (165, 64, 256),     # the kernel's block: runs of one column, most empty
    (5, 8, 3),          # one row, L > n: the padded lanes are ones
])
def test_batch_inverse_phases_host(lib, name, n, L, threads):
    """The three phases (host-compiled, phase 2's scans as loops) on an
    (R, L) tile with padding and planted zeros, against the plain
    ``vecops.batch_inverse`` and the JAX package's, limb for limb."""
    spec, jspec = SPECS[name]
    x, zeros, want = _planted(name, n)
    got = _host_batch_inverse(lib, name, x, L, threads)
    assert torch.equal(got, want)
    assert not got[:, zeros].any()
    if threads == 4:
        _same(got, jvecops.batch_inverse(jspec, _jnp(x)))


@functools.lru_cache(maxsize=None)
def _planted(name, n):
    """n elements with zeros planted, and their plain batch inverse."""
    spec = SPECS[name][0]
    x = _elements(spec, n, 50 + n)
    zeros = [0, 3, n - 1] if n > 3 else [0]
    x[:, zeros] = 0
    return x, zeros, vecops.batch_inverse_plain(spec, x)


def test_batch_inverse_routing_on_the_cpu():
    """On the CPU ``vecops.batch_inverse`` is the plain loop and launches
    nothing; the kernels' binding takes CUDA tensors only.  The kernels'
    tile: 2^CUDA_BATCH_INVERSE_LANES_LOG columns, fewer when n is smaller."""
    x = _elements(FR, 9, 60)
    before = dict(cuda_ops.LAUNCHES)
    assert torch.equal(vecops.batch_inverse(FR, x), vecops.batch_inverse_plain(FR, x))
    assert cuda_ops.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ops.batch_inverse(FR, x, 4)
    lanes = 1 << tuning.CUDA_BATCH_INVERSE_LANES_LOG
    assert vecops.batch_inverse_tile(1 << 20) == ((1 << 20) // lanes, lanes)
    assert vecops.batch_inverse_tile(lanes + 1) == (2, lanes)
    assert vecops.batch_inverse_tile(5) == (1, 5)
