"""The CUDA kernels' device code, compiled for the host, against the plain
PyTorch versions.

``csrc/field.cuh``, ``csrc/g1.cuh``, ``csrc/g1_jac.cuh``, ``csrc/g2.cuh`` and
``csrc/ntt.cuh`` also compile as plain C++.  ``csrc/host_check.cpp`` loops the kernels' lane bodies (the very
functions the CUDA kernels call per thread) over the lanes on the CPU, so the
32-bit-word Montgomery arithmetic, the group-law formulas and the index math
of the butterfly stage and of the NTT tile (pairs, strided twiddles, the
periodic table rows, rows shared by a block) are held against the plain
versions here, without a GPU.  What only a GPU can show (the
launch, the build for sm_90a) is left to ``chip_smoke.py``.  One test holds
the host-compiled product and addition against the JAX package itself, so
that the kernels' arithmetic does not rest on the port's plain versions alone
(and likewise the G2 kernels and the Jacobian ones).  The Jacobian ladder's
cases, whose plain 255-bit ladders are the longest here, are
``tests/test_torch_csrc_jac_ladder.py``, which runs beside this file.
"""

import ctypes
import os
import random

import numpy as np
import pytest
import torch

from tpu_bls12_381_torch import oracle
from tpu_bls12_381_torch.curves import (cuda_g1, cuda_g2, g1, g2, glv, points as pt,
                                       projective as pj)
from tpu_bls12_381_torch.curves.field_adapters import FQ2_PLAIN, FQ_ADAPTER as F1, FQ_PLAIN
from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, ops
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs, limbs_to_ints
from tpu_bls12_381_torch.ntt import cuda_ntt, get_domain
from tpu_bls12_381_torch.vecops import bit_reverse

from torch_shared import CSRC, host_check_library, ptr as _ptr

# One intra-op thread: the plain ladders are thousands of tiny tensor ops
# (see tests/test_torch_g2.py).
torch.set_num_threads(1)

N = 96
SZ = ctypes.c_size_t


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return host_check_library(tmp_path_factory)


def _elements(spec, seed):
    rng = random.Random(seed)
    p = spec.modulus
    vals = [0, 1, p - 1, p - 2, spec.r % p, (1 << 32) - 1, 1 << 32,
            (1 << (16 * spec.num_limbs - 3)) % p]
    vals += [rng.randrange(p) for _ in range(N - len(vals))]
    return torch.from_numpy(
        ints_to_limbs(vals, spec.num_limbs).astype(np.int32)).contiguous()


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_mont_mul_and_sqr(lib, name):
    spec = {"fr": FR, "fq": FQ}[name]
    a = _elements(spec, 1)
    b = _elements(spec, 2).flip(1).contiguous()
    out = torch.empty_like(a)
    getattr(lib, f"{name}_mont_mul")(_ptr(a), _ptr(b), _ptr(out), SZ(N))
    assert torch.equal(out, cuda_ops.mont_mul_plain(spec, a, b))
    getattr(lib, f"{name}_mont_mul")(_ptr(a), _ptr(a), _ptr(out), SZ(N))
    assert torch.equal(out, cuda_ops.mont_mul_plain(spec, a, a))
    getattr(lib, f"{name}_mont_sqr")(_ptr(a), _ptr(out), SZ(N))
    assert torch.equal(out, cuda_ops.mont_sqr_plain(spec, a))


def _lanes(spec, n, seed):
    """(K, n) canonical elements: 0, 1, p - 1 first, then random ones."""
    rng = random.Random(seed)
    p = spec.modulus
    vals = ([0, 1, p - 1] + [rng.randrange(p) for _ in range(n)])[:n]
    return torch.from_numpy(ints_to_limbs(vals, spec.num_limbs).astype(np.int32)).contiguous()


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
    off = (-flat.data_ptr() // 4 + 1) % 4
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


MUL_PLANE, MUL_COLUMN, MUL_SQUARE = 0, 1, 2


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097])
def test_elementwise_product_paths(lib, name, n):
    """``field_kernels.cu``'s product and square (carry-chain product) on the
    path the launcher takes and on each path forced (four lanes a thread,
    16-byte accesses, only where n % 4 == 0; one lane a thread), with a plane,
    a (K, 1) column and the square, against the plain versions.  The
    launcher takes four lanes exactly for Fq where n % 4 == 0 and every
    plane is 16-byte aligned."""
    spec = {"fr": FR, "fq": FQ}[name]
    K = spec.num_limbs
    a = _lanes(spec, n, 41)
    b = _lanes(spec, n, 42).flip(1).contiguous()
    col = _lanes(spec, 5, 43)[:, 4:5].contiguous()
    cases = {MUL_PLANE: (b, cuda_ops.mont_mul_plain(spec, a, b)),
             MUL_COLUMN: (col, cuda_ops.mont_mul_plain(spec, a, col)),
             MUL_SQUARE: (a, cuda_ops.mont_sqr_plain(spec, a))}
    for mode, (y, want) in cases.items():
        for path in (-1, 0, 1) if n % 4 == 0 else (-1, 0):
            out = torch.full_like(a, -1)
            lib.mont_mul_path(ctypes.c_int(K // 2), _ptr(a), _ptr(y), _ptr(out), SZ(n),
                              ctypes.c_int(mode), ctypes.c_int(path))
            assert torch.equal(out, want), (mode, path)
        four = lib.mont_mul_four(ctypes.c_int(K // 2), SZ(n), ctypes.c_int(mode), _ptr(a),
                                 _ptr(y), _ptr(out))
        assert four == (name == "fq" and n % 4 == 0)
        am, om = _misaligned(a), _misaligned(torch.full_like(a, -1))
        assert lib.mont_mul_four(ctypes.c_int(K // 2), SZ(n), ctypes.c_int(mode), _ptr(am),
                                 _ptr(y), _ptr(om)) == 0
        lib.mont_mul_path(ctypes.c_int(K // 2), _ptr(am),
                          _ptr(am if mode == MUL_SQUARE else y), _ptr(om), SZ(n),
                          ctypes.c_int(mode), ctypes.c_int(-1))
        assert torch.equal(om, want), mode
    ym = _misaligned(b)                              # a plane's b alone misaligned
    assert lib.mont_mul_four(ctypes.c_int(K // 2), SZ(n), ctypes.c_int(MUL_PLANE), _ptr(a),
                             _ptr(ym), _ptr(out)) == 0
    assert lib.mont_mul_four(ctypes.c_int(K // 2), SZ(n), ctypes.c_int(MUL_COLUMN), _ptr(a),
                             _ptr(ym), _ptr(out)) == (name == "fq" and n % 4 == 0)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_field_inv_lanes(lib, name):
    """``field_inv``'s lane loop (the Fermat inverse in 4-bit windows on the
    carry-chain product) against the plain ``inv_mont`` and against Python's
    ``pow``: 0, 1, p - 1 and random lanes, inv(0) = 0."""
    spec = {"fr": FR, "fq": FQ}[name]
    p, R = spec.modulus, 1 << (16 * spec.num_limbs)
    a = _lanes(spec, 9, 44)
    out = torch.full_like(a, -1)
    getattr(lib, f"{name}_field_inv")(_ptr(a), _ptr(out), SZ(9))
    assert torch.equal(out, cuda_ops.field_inv_plain(spec, a))
    # Montgomery form: the inverse of a R is a^-1 R = R^2 / (a R)
    want = [0 if v == 0 else R * R * pow(v, p - 2, p) % p
            for v in limbs_to_ints(a.numpy())]
    assert limbs_to_ints(out.numpy()) == want
    assert not out[:, 0].any()


def test_fq_add_sub(lib):
    a = _elements(FQ, 3)
    b = _elements(FQ, 4).flip(1).contiguous()
    s, d = torch.empty_like(a), torch.empty_like(a)
    lib.fq_add_sub(_ptr(a), _ptr(b), _ptr(s), _ptr(d), SZ(N))
    assert torch.equal(s, ops.add(FQ, a, b))
    assert torch.equal(d, ops.sub(FQ, a, b))
    lib.fq_add_sub(_ptr(a), _ptr(a), _ptr(s), _ptr(d), SZ(N))
    assert torch.equal(s, ops.double(FQ, a))
    assert not d.any()


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_field_add_sub_kernels(lib, name):
    """The ``add`` and ``sub`` kernels' lane bodies; among the lanes are
    0, 1, p - 1, sums >= p and differences of a < b."""
    spec = {"fr": FR, "fq": FQ}[name]
    a = _elements(spec, 11)
    b = _elements(spec, 12).flip(1).contiguous()
    b[:, 2] = a[:, 2]                               # (p-1) + (p-1), (p-1) - (p-1)
    out = torch.empty_like(a)
    for x, y in ((a, b), (b, a), (a, a)):
        getattr(lib, f"{name}_field_add")(_ptr(x), _ptr(y), _ptr(out), SZ(N))
        assert torch.equal(out, cuda_ops.add_plain(spec, x, y))
        getattr(lib, f"{name}_field_sub")(_ptr(x), _ptr(y), _ptr(out), SZ(N))
        assert torch.equal(out, cuda_ops.sub_plain(spec, x, y))


AS_PLANES, AS_COLUMN, AS_COLUMN_LEFT, AS_ALONE = 0, 1, 2, 3


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097])
def test_elementwise_add_sub_paths(lib, name, n):
    """``field_kernels.cu``'s add and sub (``fp_add_cc`` / ``fp_sub_cc`` on
    the carry flag) in every operand form: two planes, a (K, 1) column
    right of the plane and (sub) left of it, and the plane alone (a + a, the
    doubling; 0 - a, the negation), on the launcher's path (four lanes a
    thread for Fr where n % 4 == 0 and the planes are aligned, one for Fq)
    and on each path forced, against ``ops.add``,
    ``ops.sub`` and ``ops.neg``.  The lanes hold 0, 1, p - 1 and
    (p - 1) + (p - 1); the columns 0, p - 1 and a random element."""
    spec = {"fr": FR, "fq": FQ}[name]
    K = spec.num_limbs
    a = _lanes(spec, n, 45)
    b = _lanes(spec, n, 46).flip(1).contiguous()
    b[:, min(2, n - 1)] = a[:, min(2, n - 1)]
    for col in (a[:, :1], _lanes(spec, 3, 47)[:, 2:3], _lanes(spec, 5, 48)[:, 4:5]):
        col = col.contiguous()
        cb = col.expand_as(a)
        cases = {(0, AS_PLANES): (b, ops.add(spec, a, b)),
                 (1, AS_PLANES): (b, ops.sub(spec, a, b)),
                 (0, AS_COLUMN): (col, ops.add(spec, a, cb)),
                 (1, AS_COLUMN): (col, ops.sub(spec, a, cb)),
                 (0, AS_COLUMN_LEFT): (col, ops.add(spec, cb, a)),
                 (1, AS_COLUMN_LEFT): (col, ops.sub(spec, cb, a)),
                 (0, AS_ALONE): (a, ops.add(spec, a, a)),
                 (1, AS_ALONE): (a, ops.neg(spec, a))}
        for (sub, mode), (y, want) in cases.items():
            for path in (-1, 0, 1) if n % 4 == 0 else (-1, 0):
                out = torch.full_like(a, -1)
                lib.addsub_path(ctypes.c_int(K // 2), ctypes.c_int(sub), _ptr(a), _ptr(y),
                                _ptr(out), SZ(n), ctypes.c_int(mode), ctypes.c_int(path))
                assert torch.equal(out, want), (sub, mode, path)
            assert lib.addsub_four(ctypes.c_int(K // 2), SZ(n), ctypes.c_int(mode), _ptr(a),
                                   _ptr(y), _ptr(out)) == (name == "fr" and n % 4 == 0)
            am, om = _misaligned(a), _misaligned(torch.full_like(a, -1))
            assert lib.addsub_four(ctypes.c_int(K // 2), SZ(n), ctypes.c_int(mode), _ptr(am),
                                   _ptr(y), _ptr(om)) == 0
            lib.addsub_path(ctypes.c_int(K // 2), ctypes.c_int(sub), _ptr(am),
                            _ptr(am if mode == AS_ALONE else y), _ptr(om), SZ(n),
                            ctypes.c_int(mode), ctypes.c_int(-1))
            assert torch.equal(om, want), (sub, mode)
    assert not cases[(1, AS_ALONE)][1][:, 0].any()    # neg(0) = 0


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("n,rows,blocks,four", [
    (1, 1, 0, -1),                # one lane: one block, one pass
    (7, 3, 0, -1),                # odd n, three rows, one lane a step
    (300, 2, 0, -1),              # n % 4 == 0, two blocks a row: two passes
    (4097, 1, 0, -1),             # 17 blocks of one row
    (4096, 2, 5, 1),              # four lanes a step, forced grid
    (4096, 2, 3, 0),              # one lane a step on the same rows
    (1 << 13, 1, 64, -1),         # partials a multiple of four: both passes four
])
def test_field_sum_order(lib, name, n, rows, blocks, four):
    """``field_sum``'s order of summation as the card runs it, emulated
    with the same device functions (each thread's grid-stride run, the
    shuffle trees over a warp's lanes and over the warps' partials, then a
    second pass over the blocks' partials), equal to its plain version, the
    JAX package's halving tree.  The first row holds p - 1 in every lane."""
    spec = {"fr": FR, "fq": FQ}[name]
    K = spec.num_limbs
    v = _lanes(spec, rows * n, 49).reshape(K, rows, n)
    v[:, 0] = torch.from_numpy(ints_to_limbs([spec.modulus - 1], K).astype(np.int32))
    v = v.contiguous()
    out = torch.full((K, rows), -1, dtype=torch.int32)
    lib.field_sum(ctypes.c_int(K // 2), _ptr(v), _ptr(out), SZ(n), SZ(rows), SZ(blocks),
                  ctypes.c_int(four))
    assert torch.equal(out, cuda_ops.field_sum_plain(spec, v))
    assert limbs_to_ints(out[:, :1].numpy())[0] == n * (spec.modulus - 1) % spec.modulus
    lib.sum_blocks.restype = SZ
    G = lib.sum_blocks(SZ(n), SZ(rows))
    assert G == max(1, min(-(-n // 256), -(-1024 // rows)))


def test_butterfly_elementwise(lib):
    e, o, w = _elements(FR, 13), _elements(FR, 14).flip(1).contiguous(), _elements(FR, 15)
    o[:, 5] = 0
    w[:, 6] = 0
    w[:, 7] = torch.from_numpy(FR.one_mont_limbs.astype(np.int32))
    hi, lo = torch.empty_like(e), torch.empty_like(e)
    lib.fr_butterfly(*[_ptr(t) for t in (e, o, w, hi, lo)], SZ(N))
    want = cuda_ops.butterfly_plain(FR, e, o, w)
    assert torch.equal(hi, want[0]) and torch.equal(lo, want[1])
    assert torch.equal(hi[:, 5], e[:, 5]) and torch.equal(lo[:, 6], e[:, 6])


@pytest.mark.parametrize("half", [1, 2, 8, 32])
def test_butterfly_stage(lib, half):
    """One ladder stage on a (16, 3, 64) array where it lies (the stages
    kernel at count 1): the pairs, the strided twiddle and the in-place
    layout of the output."""
    rows, n = 3, 64
    x = ops.mont_mul(FR, _elements(FR, 16).repeat(1, 2),
                     _elements(FR, 17).flip(1).repeat(1, 2).roll(5, 1))
    x = x.reshape(16, rows, n).contiguous()
    tw = get_domain(6, device="cpu").tw
    out = torch.empty_like(x)
    lib.fr_butterfly_stage(_ptr(x), _ptr(tw), _ptr(out), SZ(rows), SZ(n), SZ(half))
    assert torch.equal(out, cuda_ops.butterfly_stage_plain(FR, x, tw, half))


def _fill(seed, cnt):
    """cnt canonical Fr elements (products of the edge values and randoms)."""
    return ops.mont_mul(
        FR, _elements(FR, seed).repeat(1, -(-cnt // N))[:, :cnt],
        _elements(FR, seed + 1).flip(1).repeat(1, -(-cnt // N))[:, :cnt].roll(cnt // 3, 1))


@pytest.mark.parametrize("natural_in", [False, True])
@pytest.mark.parametrize("B,log_m,Bw,scaled", [
    (4, 6, 0, False),       # the plain tile: 32 rows to a block, most empty
    (4, 6, 4, False),       # with a full table
    (4, 6, 2, True),        # a table of 2 rows serving 4, and the scalar
    (65, 5, 0, True),       # two blocks of 64 rows, the second nearly empty
    (3, 10, 3, False),      # two long rows to a block, the second block half full
    (2, 1, 1, True),        # the shortest row
    (2, 11, 1, True),       # rows of 2^11: a block each, rounds of 3, 3, 3, 2
    (1, 12, 0, False),      # the cap: a slab of 2^12, 512 threads
])
def test_ntt_tile(lib, B, log_m, Bw, scaled, natural_in):
    """The tile's register rounds and exchanges, block by block, in both load
    modes: bit-reversed rows in, or natural rows in (a column a block, each
    element bit-reversed as it loads; the plain version bit-reverses the
    rows first)."""
    m = 1 << log_m
    x = _fill(18, B * m).reshape(16, B, m).contiguous()
    dom = get_domain(log_m, device="cpu")
    w = _fill(20, Bw * m).reshape(16, Bw, m).contiguous() if Bw else None
    scale = dom.n_inv if scaled else None
    out = torch.empty_like(x)
    lib.fr_ntt_tile(_ptr(x), _ptr(dom.itw), _ptr(w) if Bw else None,
                    _ptr(scale) if scaled else None, _ptr(out), SZ(B), SZ(Bw),
                    ctypes.c_int(log_m), ctypes.c_int(0 if natural_in else -1),
                    ctypes.c_int(0))
    rows = bit_reverse(x, axis=-1) if natural_in else x
    assert torch.equal(out, cuda_ntt.ntt_tile_plain(rows, dom.itw, w, scale))


@pytest.mark.parametrize("B,log_m,log_c,Bw,scaled,brev", [
    (1, 5, 3, 0, False, False),     # the four-step's rows: columns of one block
    (2, 5, 3, 4, True, False),      # two blocks, w of 4 rows serving 16
    (3, 4, 2, 0, True, True),       # the ladder's rows: columns in bit-reversed order
    (1, 11, 1, 2, False, True),     # rows of 2^11 from 2 columns
    (2, 3, 0, 1, False, True),      # one column a block: the rows themselves
])
def test_ntt_tile_columns(lib, B, log_m, log_c, Bw, scaled, brev):
    """The tile reading its rows as the columns of x seen as (B, m, C) blocks,
    natural order down a column (the four-step's transposes and the ladder's
    bit reversal folded into the load)."""
    m, C = 1 << log_m, 1 << log_c
    x = _fill(24, B * m * C).reshape(16, B, m, C).contiguous()
    dom = get_domain(log_m, device="cpu")
    w = _fill(26, Bw * m).reshape(16, Bw, m).contiguous() if Bw else None
    scale = dom.n_inv if scaled else None
    out = torch.empty(16, B * C, m, dtype=torch.int32)
    lib.fr_ntt_tile(_ptr(x), _ptr(dom.tw), _ptr(w) if Bw else None,
                    _ptr(scale) if scaled else None, _ptr(out), SZ(B * C), SZ(Bw),
                    ctypes.c_int(log_m), ctypes.c_int(log_c), ctypes.c_int(int(brev)))
    assert torch.equal(out, cuda_ntt.ntt_tile_columns_plain(x, dom.tw, w, scale, brev))


@pytest.mark.parametrize("rows,log_n,log_h,count,log_s,scaled", [
    (1, 14, 8, 6, 14, False),    # the row's top stages, its own table; two rounds
    (2, 13, 7, 5, 12, True),     # two rows, the top stage's table, the scalar
    (1, 14, 6, 4, 10, False),    # below the top: runs above the slab
    (3, 9, 2, 3, 9, False),      # one round; small half: whole runs to a block
    (5, 7, 0, 2, 7, True),       # the first stages, 40 runs, a last block part empty
    (1, 12, 1, 6, 7, False),     # half 2: lanes past the offsets
])
def test_butterfly_stages(lib, rows, log_n, log_h, count, log_s, scaled):
    """Several ladder stages a launch, block by block and round by round,
    against the plain stages one at a time."""
    n = 1 << log_n
    x = _fill(22, rows * n).reshape(16, rows, n).contiguous()
    tw = get_domain(log_s, device="cpu").tw
    scale = get_domain(3, device="cpu").n_inv if scaled else None
    out = torch.empty_like(x)
    lib.fr_butterfly_stages(_ptr(x), _ptr(tw), _ptr(scale) if scaled else None, _ptr(out),
                            SZ(rows * n), ctypes.c_int(log_h), ctypes.c_int(count),
                            ctypes.c_int(log_s))
    assert torch.equal(out, cuda_ops.butterfly_stages_plain(FR, x, tw, 1 << log_h, count,
                                                            scale))


def _positions(lib, V, fn, *args):
    q = (ctypes.c_uint32 * V)()
    fn(*args, q)
    return list(q)


@pytest.mark.parametrize("log_m", [1, 3, 5, 8, 11, 12])
def test_ntt_round_mappings(lib, log_m):
    """Every round of the tile covers the block's slab once (each slab
    position held by one thread and value), and the natural-order load is
    the bit reversal: thread t of a row takes elements t + k m/2^eb, each
    placed at its bit-reversed position.  A warp's 32 lanes hit 32 banks of
    the swizzled shared memory for each value, in every round the rows of
    2^11 and 2^12 take, and in the stages kernel's rounds on the ladder."""
    lib.ntt_swizzle.restype = ctypes.c_uint32
    sb = max(11, log_m)
    eb = lib.ntt_tile_eb(sb)
    threads, m, V = 1 << (sb - eb), 1 << log_m, 1 << eb
    brev = lambda v, bits: int(format(v, f"0{bits}b")[::-1], 2) if bits else 0
    first = lambda t: _positions(lib, V, lib.ntt_first_positions, ctypes.c_uint32(t),
                                 ctypes.c_int(log_m), ctypes.c_int(1), ctypes.c_int(eb))
    later = lambda e0, sb_, eb_: lambda t: _positions(
        lib, 1 << eb_, lib.ntt_round_positions, ctypes.c_uint32(t), ctypes.c_int(e0),
        ctypes.c_int(sb_), ctypes.c_int(eb_))
    rounds = [("first", first)] + [
        (f"s0={s0}", later(min(s0, sb - eb), sb, eb)) for s0 in range(eb, log_m, eb)]
    for name, pos in rounds:
        seen = set()
        for t in range(threads):
            q = pos(t)
            if name == "first" and log_m >= eb:
                lanes = m >> eb
                assert [brev(p % m, log_m) for p in q] == [
                    t % lanes + brev(k, eb) * lanes for k in range(V)]
            seen.update(q)
        assert seen == set(range(1 << sb)), name
        if log_m >= 11:
            _assert_no_bank_conflicts(lib, pos, threads, V, name)
    if log_m == 11:                      # the stages kernel on the 2^22 ladder
        seb = lib.ntt_stages_eb()
        for log_h, count in ((11, 6), (17, 5)):
            lo = min(log_h, 11 - count)
            for rnd in range(-(-count // seb)):
                e0 = min(lo + seb * rnd, 11 - seb)
                _assert_no_bank_conflicts(lib, later(e0, 11, seb), 1 << (11 - seb),
                                          1 << seb, (log_h, count, rnd))


def _assert_no_bank_conflicts(lib, pos, threads, V, what):
    for w0 in range(0, threads, 32):
        qs = [pos(t) for t in range(w0, w0 + 32)]
        for k in range(V):
            assert len({lib.ntt_swizzle(q[k]) % 32 for q in qs}) == 32, (what, w0, k)


def test_butterfly_stages_index_math(lib):
    """The stages kernel's blocks cover the array once: each index from one
    block and slab position, offsets of a block neighbouring (32-byte
    sectors whole), positions past the last run dropped."""
    lib.stages_array_index.restype = ctypes.c_longlong
    lib.stages_array_index.argtypes = [SZ, ctypes.c_int, ctypes.c_int, SZ, ctypes.c_uint32]
    lib.stages_block_count.restype = SZ
    lib.stages_block_count.argtypes = [SZ, ctypes.c_int, ctypes.c_int]
    for total, log_h, count in ((1 << 14, 8, 6), (1 << 13, 10, 3), (40 << 2, 0, 2),
                                (3 << 9, 2, 3)):
        blocks = lib.stages_block_count(total, log_h, count)
        got = []
        for blk in range(blocks):
            idx = [lib.stages_array_index(total, log_h, count, blk, q) for q in range(1 << 11)]
            got += [i for i in idx if i >= 0]
            lo = min(log_h, 11 - count)
            if lo >= 3:
                assert idx[1:8] == [idx[0] + d for d in range(1, 8)]
        assert sorted(got) == list(range(total)), (total, log_h, count)


@pytest.fixture(scope="module")
def points():
    rng = random.Random(7)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 40), G, oracle.FQ_OPS),
        oracle.FQ_OPS) for _ in range(N)]
    A = g1.affine_from_ints(pts, device="cpu")
    B = g1.affine_from_ints(pts[5:] + pts[:5], device="cpu")
    P = [c.clone() for c in pj.proj_double(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, B))]
    Q = [c.clone() for c in pj.proj_add(FQ_PLAIN, pj.affine_to_proj(FQ_PLAIN, A),
                                        tuple(P))]
    ident = pj.proj_identity(FQ_PLAIN, (N,), "cpu")
    negP = pj.proj_neg(FQ_PLAIN, tuple(P))
    for c in range(3):
        P[c][:, 0] = ident[c][:, 0]            # identity + Q
        Q[c][:, 1] = ident[c][:, 1]            # P + identity
        Q[c][:, 2] = P[c][:, 2]                # P + P
        Q[c][:, 3] = negP[c][:, 3]             # P + (-P)
        P[c][:, 4] = ident[c][:, 4]            # identity + identity
        Q[c][:, 4] = ident[c][:, 4]
    return {"A": A, "P": tuple(c.contiguous() for c in P),
            "Q": tuple(c.contiguous() for c in Q)}


def test_padd_and_pdbl(lib, points):
    P, Q = points["P"], points["Q"]
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_padd(*[_ptr(t) for t in (*P, *Q, *out)], SZ(N))
    want = cuda_g1.padd_plain(P, Q)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not out[2][:, 3:5].any()            # identity: Z = 0
    lib.g1_pdbl(*[_ptr(t) for t in (*P, *out)], SZ(N), ctypes.c_int(1))
    want = cuda_g1.pdbl_plain(P)
    assert all(torch.equal(o, w) for o, w in zip(out, want))


def test_pmadd_signed_elementwise(lib, points):
    A = points["A"]
    P = [c.clone() for c in points["P"]]
    PA = pj.affine_to_proj(FQ_PLAIN, A)
    sign = torch.tensor([i % 3 == 0 for i in range(N)])
    inf2 = torch.tensor([i % 7 == 5 for i in range(N)])
    for lane, s in ((8, False), (9, True)):    # P + P, P + (-P)
        for c in range(3):
            P[c][:, lane] = PA[c][:, lane]
        sign[lane], inf2[lane] = s, False
    P = tuple(P)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_pmadd_signed(*[_ptr(t) for t in P], _ptr(A[0]), _ptr(A[1]),
                        SZ(24 * N), _ptr(inf2), _ptr(sign),
                        *[_ptr(t) for t in out], SZ(N), ctypes.c_int(1))
    want = cuda_g1.pmadd_signed_plain(P, (A[0], A[1], inf2), sign)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not out[2][:, 9].any()
    assert all(torch.equal(o[:, 5], p[:, 5]) for o, p in zip(out, P))  # inf2


def test_pmadd_signed_rows(lib, points):
    """The looped form on the two halves of one (R, 48, L) tile, from the
    identity, as the MSM's scan calls it."""
    R, L = 6, 16
    A = points["A"]
    tile = torch.cat([A[0], A[1]]).reshape(48, R, L).permute(1, 0, 2).contiguous()
    xr, yr = tile[:, :24], tile[:, 24:]
    sign = torch.tensor([[(r + l) % 2 == 0 for l in range(L)] for r in range(R)])
    inf = torch.tensor([[(r * l) % 5 == 4 for l in range(L)] for r in range(R)])
    inf[:, 3] = True                           # a column that stays the identity
    out = [torch.empty((R, 24, L), dtype=torch.int32) for _ in range(3)]
    lib.g1_pmadd_signed(None, None, None, _ptr(xr), _ptr(yr), SZ(xr.stride(0)),
                        _ptr(inf), _ptr(sign), *[_ptr(t) for t in out],
                        SZ(L), ctypes.c_int(R))
    want = cuda_g1.pmadd_signed_rows_plain(xr, yr, sign, inf)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not out[2][:, :, 3].any()


def test_host_compiled_kernels_match_the_jax_package(lib, points):
    """``mont_mul``, ``add`` and ``sub`` in each operand form (the doubling
    and the negation among them; Fr and Fq), ``padd`` and the butterfly as
    the kernels compute them, against ``fields/ops.py``,
    ``curves/projective.py`` and ``fields/fast.py`` of the JAX package on
    the same limbs."""
    import jax.numpy as jnp

    from tpu_bls12_381.curves import projective as jpj
    from tpu_bls12_381.curves.field_adapters import FQ_ADAPTER as JF
    from tpu_bls12_381.fields import FQ as JFQ, FR as JFR, fast as jfast, ops as jops

    j = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    for name, spec, jspec in (("fr", FR, JFR), ("fq", FQ, JFQ)):
        a = _elements(spec, 5)
        b = _elements(spec, 6).flip(1).contiguous()
        out = torch.empty_like(a)
        getattr(lib, f"{name}_mont_mul")(_ptr(a), _ptr(b), _ptr(out), SZ(N))
        np.testing.assert_array_equal(
            out.numpy().astype(np.uint32),
            np.asarray(jops.mont_mul(jspec, j(a), j(b))))
        # the add and the sub on the carry flag in each operand form
        col = b[:, 2:3].contiguous()                 # p - 2, so sums wrap
        jc = jnp.broadcast_to(j(col), (spec.num_limbs, N))
        forms = {(0, AS_PLANES, b): jops.add(jspec, j(a), j(b)),
                 (1, AS_PLANES, b): jops.sub(jspec, j(a), j(b)),
                 (0, AS_COLUMN, col): jops.add(jspec, j(a), jc),
                 (1, AS_COLUMN, col): jops.sub(jspec, j(a), jc),
                 (1, AS_COLUMN_LEFT, col): jops.sub(jspec, jc, j(a)),
                 (0, AS_ALONE, a): jops.double(jspec, j(a)),
                 (1, AS_ALONE, a): jops.neg(jspec, j(a))}
        for (sub, mode, y), want in forms.items():
            lib.addsub_path(ctypes.c_int(spec.num_limbs // 2), ctypes.c_int(sub), _ptr(a),
                            _ptr(y), _ptr(out), SZ(N), ctypes.c_int(mode), ctypes.c_int(-1))
            np.testing.assert_array_equal(out.numpy().astype(np.uint32), np.asarray(want),
                                          err_msg=str((name, sub, mode)))
    P, Q = points["P"], points["Q"]
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_padd(*[_ptr(t) for t in (*P, *Q, *out)], SZ(N))
    want = jpj.proj_add(JF, tuple(map(j, P)), tuple(map(j, Q)))
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o.numpy().astype(np.uint32), np.asarray(w))
    e, o, w = _elements(FR, 8), _elements(FR, 9).flip(1).contiguous(), _elements(FR, 10)
    hi, lo = torch.empty_like(e), torch.empty_like(e)
    lib.fr_butterfly(*[_ptr(t) for t in (e, o, w, hi, lo)], SZ(N))
    want = jfast.butterfly(JFR, j(e), j(o), j(w))
    for o_, w_ in zip((hi, lo), want):
        np.testing.assert_array_equal(o_.numpy().astype(np.uint32), np.asarray(w_))


# -----------------------------------------------------------------------------
# pmadd (the G1 mixed add without the sign) and the G2 kernels (g2.cuh)
# -----------------------------------------------------------------------------

def test_pmadd_elementwise(lib, points):
    A = points["A"]
    P = [c.clone() for c in points["P"]]
    PA = pj.affine_to_proj(FQ_PLAIN, A)
    inf2 = torch.tensor([i % 7 == 5 for i in range(N)])
    for c in range(3):
        P[c][:, 8] = PA[c][:, 8]               # P + P
    inf2[8] = False
    P = tuple(P)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_pmadd(*[_ptr(t) for t in P], _ptr(A[0]), _ptr(A[1]), _ptr(inf2),
                 *[_ptr(t) for t in out], SZ(N))
    want = cuda_g1.pmadd_plain(P, (A[0], A[1], inf2))
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert all(torch.equal(o[:, 5], p[:, 5]) for o, p in zip(out, P))  # inf2
    # lane 0 holds the identity: identity + A = A
    got = g1.jacobian_to_ints(pj.proj_to_jac(FQ_PLAIN, tuple(out)))
    assert got[0] == g1.affine_to_ints(A)[0]


def _fq2_elements(seed):
    """(24, 2, N) Fq2 values; the first lanes hold c0 = c1, c0 = 0, c1 = 0,
    c0 < c1 with c1 = p - 1, and 0."""
    a = torch.stack([_elements(FQ, seed), _elements(FQ, seed + 1).flip(1)], dim=1)
    a[:, 1, 3] = a[:, 0, 3]                    # c0 = c1 = p - 2
    a[:, 0, 4] = 0                             # c0 = 0
    a[:, 1, 5] = 0                             # c1 = 0
    a[:, :, 6] = 0
    return a.contiguous()


def test_fq2_mul_sqr_mul12(lib):
    """Karatsuba, the complex squaring and 12(1+u), where -c0 - c1 and
    12(c0 - c1) must come out canonical for c0 < c1."""
    a, b = _fq2_elements(21), _fq2_elements(23).roll(7, -1).contiguous()
    prod, sqr, m12 = (torch.empty_like(a) for _ in range(3))
    lib.fq2_ops(_ptr(a), _ptr(b), _ptr(prod), _ptr(sqr), _ptr(m12), SZ(N))
    assert torch.equal(prod, FQ2_PLAIN.mul(a, b))
    assert torch.equal(sqr, FQ2_PLAIN.sqr(a))
    assert torch.equal(sqr, FQ2_PLAIN.mul(a, a))
    assert torch.equal(m12, pj.mul_b3_g2(FQ2_PLAIN, a))
    assert int(prod.max()) < (1 << 16) and int(prod.min()) >= 0


@pytest.fixture(scope="module")
def points2():
    rng = random.Random(9)
    G = oracle.g2_generator()
    base = [oracle.jac_to_affine(
        oracle.scalar_mul(rng.randrange(1, 1 << 24), G, oracle.FQ2_OPS),
        oracle.FQ2_OPS) for _ in range(12)]
    pts = [base[i % 12] for i in range(N)]
    A = g2.affine_from_ints(pts, device="cpu")
    B = g2.affine_from_ints(pts[5:] + pts[:5], device="cpu")
    P = [c.clone() for c in pj.proj_double(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, B))]
    Q = [c.clone() for c in pj.proj_add(FQ2_PLAIN, pj.affine_to_proj(FQ2_PLAIN, A),
                                        tuple(P))]
    ident = pj.proj_identity(FQ2_PLAIN, (N,), "cpu")
    negP = pj.proj_neg(FQ2_PLAIN, tuple(P))
    for c in range(3):
        P[c][..., 0] = ident[c][..., 0]        # identity + Q
        Q[c][..., 1] = ident[c][..., 1]        # P + identity
        Q[c][..., 2] = P[c][..., 2]            # P + P
        Q[c][..., 3] = negP[c][..., 3]         # P + (-P)
        P[c][..., 4] = ident[c][..., 4]        # identity + identity
        Q[c][..., 4] = ident[c][..., 4]
    return {"A": A, "P": tuple(c.contiguous() for c in P),
            "Q": tuple(c.contiguous() for c in Q)}


def test_padd2_and_pdbl2(lib, points2):
    P, Q = points2["P"], points2["Q"]
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g2_padd(*[_ptr(t) for t in (*P, *Q, *out)], SZ(N))
    want = cuda_g2.padd2_plain(P, Q)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not out[2][..., 3:5].any()          # identity: Z = 0
    lib.g2_pdbl(*[_ptr(t) for t in (*P, *out)], SZ(N), ctypes.c_int(1))
    want = cuda_g2.pdbl2_plain(P)
    assert all(torch.equal(o, w) for o, w in zip(out, want))


def test_pmadd2_elementwise(lib, points2):
    A = points2["A"]
    P = [c.clone() for c in points2["P"]]
    PA = pj.affine_to_proj(FQ2_PLAIN, A)
    sign = torch.tensor([i % 3 == 0 for i in range(N)])
    inf2 = torch.tensor([i % 7 == 5 for i in range(N)])
    for lane, s_ in ((8, False), (9, True)):   # P + P, P + (-P)
        for c in range(3):
            P[c][..., lane] = PA[c][..., lane]
        sign[lane], inf2[lane] = s_, False
    P = tuple(P)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g2_pmadd(*[_ptr(t) for t in P], _ptr(A[0]), _ptr(A[1]),
                 SZ(48 * N), _ptr(inf2), _ptr(sign),
                 *[_ptr(t) for t in out], SZ(N), ctypes.c_int(1))
    want = cuda_g2.pmadd2_plain(P, (A[0], A[1], inf2), sign)
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not out[2][..., 9].any()
    assert all(torch.equal(o[..., 5], p[..., 5]) for o, p in zip(out, P))  # inf2
    # the sign left out is a sign of zeros
    zeros = torch.zeros_like(sign)
    lib.g2_pmadd(*[_ptr(t) for t in P], _ptr(A[0]), _ptr(A[1]),
                 SZ(48 * N), _ptr(inf2), _ptr(zeros),
                 *[_ptr(t) for t in out], SZ(N), ctypes.c_int(1))
    want = cuda_g2.pmadd2_plain(P, (A[0], A[1], inf2))
    assert all(torch.equal(o, w) for o, w in zip(out, want))


def test_pmadd2_rows(lib, points2):
    """The looped form on the two halves of one (R, 96, L) tile, from the
    identity, as the G2 MSM's scan calls it."""
    R, L = 6, 16
    A = points2["A"]
    tile = torch.cat([A[0].reshape(48, N), A[1].reshape(48, N)]
                     ).reshape(96, R, L).permute(1, 0, 2).contiguous()
    xr = tile[:, :48].unflatten(1, (24, 2))
    yr = tile[:, 48:].unflatten(1, (24, 2))
    sign = torch.tensor([[(r + l) % 2 == 0 for l in range(L)] for r in range(R)])
    inf = torch.tensor([[(r * l) % 5 == 4 for l in range(L)] for r in range(R)])
    inf[:, 3] = True                           # a column that stays the identity
    out = [torch.empty((R, 24, 2, L), dtype=torch.int32) for _ in range(3)]
    lib.g2_pmadd(None, None, None, _ptr(xr), _ptr(yr), SZ(xr.stride(0)),
                 _ptr(inf), _ptr(sign), *[_ptr(t) for t in out],
                 SZ(L), ctypes.c_int(R))
    want = cuda_g2.pmadd2_rows(xr, yr, sign, inf)   # the wrapper checks the strides
    assert all(torch.equal(o, w) for o, w in zip(out, want))
    assert not out[2][..., 3].any()


def test_host_compiled_g2_kernels_match_the_jax_package(lib, points2):
    """``padd2`` and ``pdbl2`` as the kernels compute them, against
    ``curves/projective.py`` of the JAX package over its Fq2 adapter."""
    import jax.numpy as jnp

    from tpu_bls12_381.curves import projective as jpj
    from tpu_bls12_381.curves.field_adapters import FQ2_ADAPTER as JF2
    from tpu_bls12_381_torch import convert

    jp = lambda T: tuple(tuple(jnp.asarray(c) for c in convert.fq2_to_numpy(t))
                         for t in T)
    P, Q = points2["P"], points2["Q"]
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g2_padd(*[_ptr(t) for t in (*P, *Q, *out)], SZ(N))
    for o, w in zip(out, jpj.proj_add(JF2, jp(P), jp(Q))):
        for got, want in zip(convert.fq2_to_numpy(o), w):
            np.testing.assert_array_equal(got, np.asarray(want))
    lib.g2_pdbl(*[_ptr(t) for t in (*P, *out)], SZ(N), ctypes.c_int(1))
    for o, w in zip(out, jpj.proj_double(JF2, jp(P))):
        for got, want in zip(convert.fq2_to_numpy(o), w):
            np.testing.assert_array_equal(got, np.asarray(want))


# -----------------------------------------------------------------------------
# The Jacobian kernels (g1_jac.cuh): madd, jadd, jdbl
# -----------------------------------------------------------------------------

def _scaled(P, lam):
    """(lambda^2 X, lambda^3 Y, lambda Z): the same point with another Z."""
    l = g1.affine_from_ints([(lam, 1)] * N, device="cpu")[0]
    l2 = FQ_PLAIN.sqr(l)
    return (FQ_PLAIN.mul(P[0], l2), FQ_PLAIN.mul(P[1], FQ_PLAIN.mul(l2, l)),
            FQ_PLAIN.mul(P[2], l))


@pytest.fixture(scope="module")
def jac_points(points):
    """Jacobian P, Q (Z != 1) and affine A with the edge lanes:
    0 P identity; 1 Q identity and A's inf; 2 P == Q (Q's Z scaled by 7);
    3 P == -Q (likewise); 4 both identities; 5 P identity with A's inf;
    6 P == A (Z = 5); 7 P == -A."""
    A = points["A"]
    B = tuple(c.roll(5, 1) for c in A[:2]) + (A[2],)
    P = [c.clone() for c in pt.jac_double(FQ_PLAIN, pt.affine_to_jac(FQ_PLAIN, B))]
    Q = [c.clone() for c in pt.jac_add(FQ_PLAIN, pt.affine_to_jac(FQ_PLAIN, A), tuple(P))]
    ident = pt.jac_identity(FQ_PLAIN, (N,), "cpu")
    Pq = _scaled(tuple(P), 7)
    Aj = _scaled(pt.affine_to_jac(FQ_PLAIN, A), 5)
    for c in range(3):
        P[c][:, 0] = ident[c][:, 0]
        Q[c][:, 1] = ident[c][:, 1]
        Q[c][:, 2] = Pq[c][:, 2]
        Q[c][:, 3] = pt.jac_neg(FQ_PLAIN, Pq)[c][:, 3]
        P[c][:, 4] = ident[c][:, 4]
        Q[c][:, 4] = ident[c][:, 4]
        P[c][:, 5] = ident[c][:, 5]
        P[c][:, 6] = Aj[c][:, 6]
        P[c][:, 7] = pt.jac_neg(FQ_PLAIN, Aj)[c][:, 7]
    inf2 = torch.tensor([i in (1, 5) or i % 11 == 10 for i in range(N)])
    return {"P": tuple(c.contiguous() for c in P), "Q": tuple(c.contiguous() for c in Q),
            "A": (A[0], A[1], inf2)}


def test_jadd_and_jdbl(lib, jac_points):
    P, Q = jac_points["P"], jac_points["Q"]
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_jadd(*[_ptr(t) for t in (*P, *Q, *out)], SZ(N))
    assert all(torch.equal(o, w) for o, w in zip(out, cuda_g1.jadd_plain(P, Q)))
    assert not out[2][:, 3:5].any()            # P + (-P), O + O: Z = 0
    got = g1.jacobian_to_ints(tuple(out))
    assert got[2] == g1.jacobian_to_ints(pt.jac_double(FQ_PLAIN, P))[2]   # P + P = 2P
    assert got[0] == g1.jacobian_to_ints(Q)[0] and got[1] == g1.jacobian_to_ints(P)[1]
    lib.g1_jdbl(*[_ptr(t) for t in (*P, *out)], SZ(N))
    assert all(torch.equal(o, w) for o, w in zip(out, cuda_g1.jdbl_plain(P)))
    assert not out[2][:, [0, 4, 5]].any()      # 2 O = O


def test_madd(lib, jac_points):
    P, A = jac_points["P"], jac_points["A"]
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_madd(*[_ptr(t) for t in P], _ptr(A[0]), _ptr(A[1]), _ptr(A[2]),
                *[_ptr(t) for t in out], SZ(N))
    assert all(torch.equal(o, w) for o, w in zip(out, cuda_g1.madd_plain(P, A)))
    assert not out[2][:, [5, 7]].any()         # O with inf, P + (-P)
    assert all(torch.equal(o[:, 1], p[:, 1]) for o, p in zip(out, P))   # inf2: P
    one = torch.from_numpy(FQ.one_mont_limbs.astype(np.int32))
    assert torch.equal(out[0][:, 0], A[0][:, 0]) and torch.equal(out[2][:, 0], one)
    got = g1.jacobian_to_ints(tuple(out))
    assert got[6] == g1.jacobian_to_ints(pt.jac_double(FQ_PLAIN, P))[6]   # P + P = 2P


@pytest.mark.parametrize("eq_lane,neg_lane", [(0, 1), (N // 2, N // 2 + 1), (N - 1, N - 2)],
                         ids=["first", "middle", "last"])
def test_madd_planted_lanes(lib, jac_points, eq_lane, neg_lane):
    """``g1_madd_lane`` on the carry-chain product, with P == A planted at the
    first, a middle or the last lane and P == -A beside it (on the card the
    doubling runs only in a warp that holds a P == A lane; here each lane
    runs alone, so every lane is such a warp or none): against
    ``madd_plain`` and the JAX package's ``points.jac_add_affine``, limb for
    limb."""
    import jax.numpy as jnp

    from tpu_bls12_381.curves import points as jpt
    from tpu_bls12_381.curves.field_adapters import FQ_ADAPTER as JF

    P, A = [c.clone() for c in jac_points["P"]], jac_points["A"]
    inf2 = A[2].clone()
    inf2[[eq_lane, neg_lane]] = False
    A = (A[0], A[1], inf2)
    Aj = _scaled(pt.affine_to_jac(FQ_PLAIN, A), 3)           # Z = 3
    negAj = pt.jac_neg(FQ_PLAIN, Aj)
    for c in range(3):
        P[c][:, eq_lane] = Aj[c][:, eq_lane]
        P[c][:, neg_lane] = negAj[c][:, neg_lane]
    P = tuple(c.contiguous() for c in P)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_madd(*[_ptr(t) for t in (*P, *A, *out)], SZ(N))
    assert all(torch.equal(o, w) for o, w in zip(out, cuda_g1.madd_plain(P, A)))
    assert not out[2][:, neg_lane].any()                     # P + (-P) = O
    got = g1.jacobian_to_ints(tuple(out))[eq_lane]
    assert got == g1.jacobian_to_ints(pt.jac_double(FQ_PLAIN, P))[eq_lane]
    j = lambda t: jnp.asarray(t.numpy().astype(np.uint32) if t.dtype == torch.int32
                              else t.numpy())
    want = jpt.jac_add_affine(JF, tuple(map(j, P)), tuple(map(j, A)))
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o.numpy().astype(np.uint32), np.asarray(w))


@pytest.mark.parametrize("lane", [40, N - 1], ids=["warp 1 alone", "last lane"])
def test_jadd_planted_lanes(lib, jac_points, lane):
    """``g1_jadd_lane`` (``g1_jac_add<CarryMul>``, the doubling only in a warp
    that holds a P == Q lane) with one P == Q lane planted beside
    ``jac_points``' lane 2 (Q = P with Z times 3): the only one of warp 1, or
    the last lane.  On the card the doubling runs only in such a warp; here
    each lane runs alone.  Against ``jadd_plain`` limb for limb and the
    oracle's 2P."""
    P, Q = jac_points["P"], [c.clone() for c in jac_points["Q"]]
    Pq = _scaled(P, 3)
    for c in range(3):
        Q[c][:, lane] = Pq[c][:, lane]
    Q = tuple(c.contiguous() for c in Q)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    lib.g1_jadd(*[_ptr(t) for t in (*P, *Q, *out)], SZ(N))
    assert all(torch.equal(o, w) for o, w in zip(out, cuda_g1.jadd_plain(P, Q)))
    got = g1.jacobian_to_ints(tuple(out))
    two_p = g1.jacobian_to_ints(pt.jac_double(FQ_PLAIN, P))
    assert got[lane] == two_p[lane] and got[2] == two_p[2]
    assert not out[2][:, 3:5].any()            # P + (-P), O + O: Z = 0


R_FR = FR.modulus


GLV_LANES = 16


@pytest.fixture(scope="module")
def glv_case():
    """A on 16 lanes (multiples of G) with the GLV ladder's edge lanes: lane
    3 A's inf; scalars k = 0, 1, r - 1, lambda (k1 = 0), 5 (k2 = 0), the
    others random below r; k1, k2 and beta x as ``scalar_mul_glv`` makes
    them."""
    rng = random.Random(23)
    G = oracle.g1_generator()
    pts = [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, R_FR), G, oracle.FQ_OPS),
                                oracle.FQ_OPS) for _ in range(GLV_LANES)]
    pts[3] = None
    ks = [0, 1, R_FR - 1, glv.GLV_LAMBDA, 5, 2 * glv.GLV_LAMBDA + 3]
    ks += [rng.randrange(R_FR) for _ in range(GLV_LANES - len(ks))]
    k = torch.from_numpy(ints_to_limbs(ks, 16).astype(np.int32)).contiguous()
    A = g1.affine_from_ints(pts, device="cpu")
    k1, k2 = glv.decompose(k)
    return {"A": A, "pts": pts, "ks": ks, "k": k, "k1": k1, "k2": k2,
            "phi_x": glv.endomorphism(F1, A)[0].contiguous()}


@pytest.mark.parametrize("num_bits", [1, 16, 128, 160])
def test_glv_ladder(lib, glv_case, num_bits):
    """``g1_glv_ladder_lane`` (``scalar_mul_glv`` in one launch: the
    accumulator in registers, both adds every bit, the selects masks) against
    ``cuda_g1.glv_ladder_plain`` and the port's CPU ``scalar_mul_glv``
    (``_glv_steps`` over the adapter, then ``proj_to_jac``), limb for limb,
    on 16 lanes with the edge lanes of ``glv_case`` (at 160 bits on 4 of
    them: k2 has 9 limbs, so its bits 144 to 159 read 0); at 128 bits also
    against the oracle."""
    lanes = 4 if num_bits == 160 else GLV_LANES
    cut = lambda t: t[..., :lanes].contiguous()
    A = tuple(cut(c) for c in glv_case["A"])
    k, k1, k2, phi_x = (cut(glv_case[n]) for n in ("k", "k1", "k2", "phi_x"))
    assert (k1.shape[0], k2.shape[0]) == (16, 9)
    out = [torch.empty_like(A[0]) for _ in range(3)]
    lib.g1_glv_ladder(_ptr(k1), _ptr(k2), ctypes.c_int(k2.shape[0]),
                      *[_ptr(t) for t in (A[0], A[1], phi_x, A[2])],
                      *[_ptr(t) for t in out], SZ(lanes), ctypes.c_int(num_bits))
    assert all(torch.equal(o, w) for o, w in
               zip(out, cuda_g1.glv_ladder_plain(k1, k2, A, phi_x, num_bits)))
    jac = pj.proj_to_jac(FQ_PLAIN, tuple(out))
    assert all(torch.equal(o, w) for o, w in zip(jac, glv.scalar_mul_glv(k, A, num_bits)))
    if num_bits == 128:
        want = [None if (p is None or v == 0) else oracle.jac_to_affine(
            oracle.scalar_mul(v, p, oracle.FQ_OPS), oracle.FQ_OPS)
            for v, p in zip(glv_case["ks"], glv_case["pts"])]
        assert g1.jacobian_to_ints(jac) == want


def test_glv_sweep_builds_change_statements_the_sources_hold():
    """Each build not kept of ``curves/sweeps.py --builds`` changes statements
    that stand once in ``csrc/`` (else the sweep raises on the card)."""
    from tpu_bls12_381_torch.curves import sweeps

    for build, changes in sweeps.BUILDS.items():
        texts = {}
        for file_, old, new in changes:
            text = texts.get(file_) or open(os.path.join(CSRC, file_)).read()
            assert text.count(old) == 1, (build, old)
            texts[file_] = text.replace(old, new)


def test_host_compiled_jacobian_kernels_match_the_jax_package(lib, jac_points):
    """``madd``, ``jadd`` and ``jdbl`` as the kernels compute them, against
    ``curves/points.py`` of the JAX package (its CPU path: the generic
    formulas, to which its Pallas kernels are bit-identical)."""
    import jax.numpy as jnp

    from tpu_bls12_381.curves import points as jpt
    from tpu_bls12_381.curves.field_adapters import FQ_ADAPTER as JF

    j = lambda t: jnp.asarray(t.numpy().astype(np.uint32) if t.dtype == torch.int32
                              else t.numpy())
    P, Q, A = jac_points["P"], jac_points["Q"], jac_points["A"]
    out = [torch.empty_like(P[0]) for _ in range(3)]
    cases = (
        (lambda: lib.g1_jadd(*[_ptr(t) for t in (*P, *Q, *out)], SZ(N)),
         jpt.jac_add(JF, tuple(map(j, P)), tuple(map(j, Q)))),
        (lambda: lib.g1_madd(*[_ptr(t) for t in (*P, *A, *out)], SZ(N)),
         jpt.jac_add_affine(JF, tuple(map(j, P)), tuple(map(j, A)))),
        (lambda: lib.g1_jdbl(*[_ptr(t) for t in (*P, *out)], SZ(N)),
         jpt.jac_double(JF, tuple(map(j, P)))),
    )
    for run, want in cases:
        run()
        for o, w in zip(out, want):
            np.testing.assert_array_equal(o.numpy().astype(np.uint32), np.asarray(w))


# -----------------------------------------------------------------------------
# The carry-chain product (field_carry.cuh) and the lane scans (padd_scan,
# padd2_scan)
# -----------------------------------------------------------------------------

def test_carry_chain_product(lib):
    """``fq_mul_cc``'s two chains (as C++ with an explicit carry) against the
    plain product: 0, 1, p - 1, p - 2, R mod p and the word edges among the
    lanes, a*b and a*a."""
    a = _elements(FQ, 31)
    b = _elements(FQ, 32).flip(1).contiguous()
    out = torch.empty_like(a)
    for x, y in ((a, b), (a, a), (b, a)):
        lib.fq_mont_mul_carry(_ptr(x), _ptr(y), _ptr(out), SZ(N))
        assert torch.equal(out, cuda_ops.mont_mul_plain(FQ, x, y))


@pytest.mark.parametrize("rows,L,run,threads,mode", [
    (2, 19, 2, 4, dict()),                            # 3 blocks, the last part empty
    (1, 19, 3, 2, dict(exclusive=True)),
    (3, 7, 4, 2, dict(reverse=True)),                 # one block
    (1, 20, 1, 4, dict(reverse=True, exclusive=True)),
    (2, 1, 4, 1, dict()),                             # L = 1
    (2, 19, 2, 4, dict(total=True)),
])
def test_padd_scan(lib, points, rows, L, run, threads, mode):
    """The lane scan's serial bodies (the run's fold, the carry-in walk, the
    carry pass) with the block scans as host loops, against
    ``padd_scan_plain`` limb for limb: the same association."""
    P = tuple(c[:, :rows * L].reshape(24, rows, L).contiguous() for c in points["Q"])
    nblk, threads2, _ = cuda_g1.scan_geometry(L, run, threads)
    new = lambda *d: [torch.empty((24,) + d, dtype=torch.int32) for _ in range(3)]
    V, C = new(rows, nblk * threads), new(rows, nblk)
    total = mode.get("total", False)
    O, S = ([None] * 3, new(rows)) if total else (new(rows, L), [None] * 3)
    ptr = lambda t: None if t is None else _ptr(t)
    lib.g1_padd_scan(*[ptr(t) for t in (*P, *O, *S, *V, *C)], SZ(rows), SZ(L),
                     ctypes.c_int(run), ctypes.c_int(threads), ctypes.c_int(threads2),
                     ctypes.c_int(mode.get("reverse", False)),
                     ctypes.c_int(mode.get("exclusive", False)))
    want = cuda_g1.padd_scan_plain(P, run=run, threads=threads, **mode)
    assert all(torch.equal(o, w) for o, w in zip(S if total else O, want))


@pytest.mark.parametrize("rows,L,run,threads,mode", [
    (2, 19, 2, 4, dict()),                            # 3 blocks, the last part empty
    (1, 64, 4, 4, dict(exclusive=True)),              # 4 blocks, the carry pass folds
    (2, 7, 4, 2, dict(reverse=True)),                 # one block
    (1, 20, 1, 4, dict(reverse=True, exclusive=True)),
    (2, 19, 2, 4, dict(total=True)),
])
def test_padd2_scan(lib, points2, rows, L, run, threads, mode):
    """The G2 lane scan (``g2_padd_scan``: lane_scan.cuh's passes on G2
    points, the block scans as host loops) against ``padd2_scan_plain`` limb
    for limb: the same association; identities among the lanes."""
    P = tuple(c[..., :rows * L].reshape(24, 2, rows, L).contiguous() for c in points2["Q"])
    nblk, threads2, _ = cuda_g1.scan_geometry(L, run, threads)
    new = lambda *d: [torch.empty((24, 2) + d, dtype=torch.int32) for _ in range(3)]
    V, C = new(rows, nblk * threads), new(rows, nblk)
    total = mode.get("total", False)
    O, S = ([None] * 3, new(rows)) if total else (new(rows, L), [None] * 3)
    ptr = lambda t: None if t is None else _ptr(t)
    lib.g2_padd_scan(*[ptr(t) for t in (*P, *O, *S, *V, *C)], SZ(rows), SZ(L),
                     ctypes.c_int(run), ctypes.c_int(threads), ctypes.c_int(threads2),
                     ctypes.c_int(mode.get("reverse", False)),
                     ctypes.c_int(mode.get("exclusive", False)))
    want = cuda_g2.padd2_scan_plain(P, run=run, threads=threads, **mode)
    assert all(torch.equal(o, w) for o, w in zip(S if total else O, want))
