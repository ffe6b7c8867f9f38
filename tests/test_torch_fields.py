"""Field layer of the PyTorch/CUDA port against the JAX package, on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and its
counterpart in ``tpu_bls12_381_torch`` (plain PyTorch versions, since the
tensors live on the CPU).  Everything is integer arithmetic with canonical
results, so every comparison is exact equality of limbs.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_bls12_381.fields import FQ as JFQ, FR as JFR, fast as jfast, ops as jops
from tpu_bls12_381.fields import pallas_ops as jpallas

import tpu_bls12_381_torch as port
from tpu_bls12_381_torch import convert
from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, fast, ops
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs, limbs_to_ints

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)

N = 256
SPECS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def _inputs(spec, seed):
    """(K, N) canonical elements as numpy uint32 limbs, edge values first."""
    rng = np.random.default_rng(seed)
    p = spec.modulus
    edges = [0, 1, p - 1, p - 2, spec.r % p, 2, (p - 1) // 2, (p + 1) // 2]
    vals = edges + [int.from_bytes(rng.bytes(64), "little") % p
                    for _ in range(N - len(edges))]
    return ints_to_limbs(vals, spec.num_limbs)


def _t(arr, spec):
    return convert.field_from_numpy(arr, spec, device="cpu")


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_op_matches_jax(name, op):
    spec, jspec = SPECS[name]
    a = _inputs(spec, 1)
    b = _inputs(spec, 2)[:, ::-1].copy()
    want = np.asarray(getattr(jops, op)(jspec, a, b))
    got = convert.to_numpy(getattr(ops, op)(spec, _t(a, spec), _t(b, spec)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mont_sqr", "from_mont", "to_mont", "neg",
                                "double"])
def test_unary_op_matches_jax(name, op):
    spec, jspec = SPECS[name]
    a = _inputs(spec, 3)
    want = np.asarray(getattr(jops, op)(jspec, a))
    got = convert.to_numpy(getattr(ops, op)(spec, _t(a, spec)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_routed_ops_take_plain_version_on_cpu(name):
    """``fast.*`` and the kernel wrappers, given CPU tensors, return the
    plain version's result and launch nothing."""
    spec, jspec = SPECS[name]
    a, b = _t(_inputs(spec, 4), spec), _t(_inputs(spec, 5), spec)
    before = dict(cuda_ops.LAUNCHES)
    assert torch.equal(fast.mont_mul(spec, a, b), ops.mont_mul(spec, a, b))
    assert torch.equal(fast.mont_sqr(spec, a), ops.mont_sqr(spec, a))
    assert torch.equal(cuda_ops.mont_mul(spec, a, b), ops.mont_mul(spec, a, b))
    assert torch.equal(cuda_ops.mont_sqr(spec, a), ops.mont_sqr(spec, a))
    want = np.asarray(jops.from_mont(jspec, convert.to_numpy(a)))
    np.testing.assert_array_equal(convert.to_numpy(fast.from_mont(spec, a)), want)
    assert cuda_ops.LAUNCHES == before


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_add_sub_butterfly_wrappers_match_jax(name):
    """The ``add``, ``sub`` and ``butterfly`` wrappers and their ``fast``
    routers, given CPU tensors, equal the JAX package and launch nothing."""
    spec, jspec = SPECS[name]
    a, b, w = _inputs(spec, 12), _inputs(spec, 13)[:, ::-1].copy(), _inputs(spec, 14)
    ta, tb, tw = _t(a, spec), _t(b, spec), _t(w, spec)
    before = dict(cuda_ops.LAUNCHES)
    for op in ("add", "sub"):
        want = np.asarray(getattr(jops, op)(jspec, a, b))
        for mod in (cuda_ops, fast):
            np.testing.assert_array_equal(
                convert.to_numpy(getattr(mod, op)(spec, ta, tb)), want)
    want = jfast.butterfly(jspec, a, b, w)
    for mod in (cuda_ops, fast):
        got = mod.butterfly(spec, ta, tb, tw)
        for g, v in zip(got, want):
            np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(v))
    # fast broadcasts and lays out; the wrappers raise on what they are given
    got = fast.butterfly(spec, ta[:, ::2], tb[:, ::2], tw[:, :1])
    want = cuda_ops.butterfly_plain(spec, ta[:, ::2], tb[:, ::2], tw[:, :1])
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert torch.equal(fast.add(spec, ta[:, ::2], tb[:, :1]),
                       ops.add(spec, ta[:, ::2], tb[:, :1]))
    for fn in (cuda_ops.add, cuda_ops.sub):
        with pytest.raises(ValueError, match="contiguous"):
            fn(spec, ta[:, ::2], tb[:, ::2])
        with pytest.raises(ValueError, match="shapes differ"):
            fn(spec, ta, tb[:, :2].contiguous())
        # a (K, 1) column is one element every lane takes, not a plane
        col = tb[:, :1].contiguous()
        plain = getattr(cuda_ops, f"{fn.__name__}_plain")
        assert torch.equal(fn(spec, ta, col), plain(spec, ta, col))
    with pytest.raises(ValueError, match="shapes differ"):
        cuda_ops.butterfly(spec, ta, tb, tw[:, :1].contiguous())
    assert cuda_ops.LAUNCHES == before


def test_butterfly_matches_pallas_kernel_in_interpret_mode():
    """The port's butterfly against the TPU kernel itself, run as the JAX
    package's own tests run it on the CPU."""
    a, b, w = _inputs(FR, 15), _inputs(FR, 16)[:, ::-1].copy(), _inputs(FR, 17)
    want = jpallas.butterfly(JFR, a, b, w)
    got = cuda_ops.butterfly(FR, _t(a, FR), _t(b, FR), _t(w, FR))
    for g, v in zip(got, want):
        np.testing.assert_array_equal(convert.to_numpy(g), np.asarray(v))


def test_butterfly_stage_is_the_jax_ladder_stage():
    """``butterfly_stage`` on a CPU tensor is one pass of the JAX ladder's
    loop; all stages in turn give the JAX ``_butterflies``."""
    from tpu_bls12_381.ntt.domain import get_domain as j_get_domain
    from tpu_bls12_381.ntt.ntt import _butterflies as j_butterflies

    x = _inputs(FR, 18)[:, :128].reshape(16, 2, 64)
    jd = j_get_domain(6)
    tw = _t(np.asarray(jd.tw), FR)
    t = _t(x, FR)
    for s in range(6):
        t = cuda_ops.butterfly_stage(FR, t, tw, 1 << s)
    np.testing.assert_array_equal(convert.to_numpy(t),
                                  np.asarray(j_butterflies(x, jd.tw, 6)))
    with pytest.raises(ValueError, match="half"):
        cuda_ops.butterfly_stage(FR, t, tw, 3)
    with pytest.raises(ValueError, match="half"):
        cuda_ops.butterfly_stage(FR, t, tw, 64)
    with pytest.raises(ValueError, match="twiddles"):
        cuda_ops.butterfly_stage(FR, t, tw[:, :16].contiguous(), 1)
    with pytest.raises(ValueError, match="power of"):
        cuda_ops.butterfly_stage(FR, t[:, :, :48].contiguous(), tw, 1)
    with pytest.raises(ValueError, match="Fr only"):
        cuda_ops.butterfly_stage(FQ, t, tw, 1)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_pow_const_and_inv_mont_match_jax(name):
    spec, jspec = SPECS[name]
    a = _inputs(spec, 19)[:, :12]                   # 0, 1, p-1, ... among them
    ta = _t(a, spec)
    for e in (0, 1, 5, 0b1011001):
        np.testing.assert_array_equal(
            convert.to_numpy(ops.pow_const(spec, ta, e)),
            np.asarray(jops.pow_const(jspec, a, e)))
    inv = ops.inv_mont(spec, ta)
    np.testing.assert_array_equal(convert.to_numpy(inv),
                                  np.asarray(jops.inv_mont(jspec, a)))
    assert torch.equal(fast.inv_mont(spec, ta), inv)
    assert not inv[:, 0].any()                      # inv(0) = 0
    one = ops.one_mont(spec, (11,), device="cpu")
    assert torch.equal(ops.mont_mul(spec, inv, ta)[:, 1:], one)
    with pytest.raises(ValueError):
        ops.pow_const(spec, ta, -1)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_field_inv_and_from_mont_column_match_jax(name):
    """``cuda_ops.field_inv`` (on the CPU: its plain version) and
    ``fast.from_mont`` (the product with a (K, 1) column of 1) equal the JAX
    package's ``inv_mont`` and ``from_mont``; 0, 1 and p - 1 among the
    lanes, inv(0) = 0."""
    spec, jspec = SPECS[name]
    a = _inputs(spec, 23)[:, :10]
    ta = _t(a, spec)
    inv = cuda_ops.field_inv(spec, ta)
    np.testing.assert_array_equal(convert.to_numpy(inv),
                                  np.asarray(jops.inv_mont(jspec, a)))
    assert not inv[:, 0].any()
    assert torch.equal(fast.inv_mont(spec, ta[:, 1:]), inv[:, 1:])  # a view laid out
    a = _inputs(spec, 24)
    np.testing.assert_array_equal(convert.to_numpy(fast.from_mont(spec, _t(a, spec))),
                                  np.asarray(jops.from_mont(jspec, a)))


@pytest.mark.parametrize("lanes,route", [(1, "field_inv"), (4095, "field_inv"),
                                         (4096, "batch_inverse")])
def test_fq_adapter_inv_routes_by_width(lanes, route, monkeypatch):
    """``FqAdapter.inv`` below 4096 lanes is one ``cuda_ops.field_inv`` call
    (one launch on the card: ``fast.inv_mont``), from 4096 lanes on one
    ``vecops.batch_inverse`` call, as the JAX package's adapter switches.
    Both wrappers are replaced by counting stubs, so the route is forced
    without the card."""
    from tpu_bls12_381_torch import vecops
    from tpu_bls12_381_torch.curves.field_adapters import FQ_ADAPTER

    calls = []
    monkeypatch.setattr(cuda_ops, "field_inv",
                        lambda spec, x: (calls.append(("field_inv", tuple(x.shape))), x)[1])
    monkeypatch.setattr(vecops, "batch_inverse",
                        lambda spec, x: (calls.append(("batch_inverse", tuple(x.shape))), x)[1])
    x = ops.zeros(FQ, (lanes,), device="cpu")
    assert FQ_ADAPTER.inv(x) is not None
    assert calls == [(route, (24, lanes))]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_predicates_and_select_match_jax(name):
    spec, jspec = SPECS[name]
    a = _inputs(spec, 6)
    b = a.copy()
    b[:, ::3] = _inputs(spec, 7)[:, ::3]
    ta, tb = _t(a, spec), _t(b, spec)
    np.testing.assert_array_equal(ops.is_zero(spec, ta).numpy(),
                                  np.asarray(jops.is_zero(jspec, a)))
    np.testing.assert_array_equal(ops.eq(spec, ta, tb).numpy(),
                                  np.asarray(jops.eq(jspec, a, b)))
    mask = np.arange(N) % 2 == 0
    np.testing.assert_array_equal(
        convert.to_numpy(ops.cmov(torch.from_numpy(mask), ta, tb)),
        np.asarray(jops.cmov(mask, a, b)))
    np.testing.assert_array_equal(
        convert.to_numpy(ops.one_mont(spec, (5,), device="cpu")),
        np.asarray(jops.one_mont(jspec, (5,))))
    np.testing.assert_array_equal(
        convert.to_numpy(ops.zeros(spec, (2, 3), device="cpu")),
        np.asarray(jops.zeros(jspec, (2, 3))))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_broadcast_over_batch_axes(name):
    """A (K, 1) constant against a (K, 3, N) batch, as the GLV beta multiply
    and the stacked group-law formulas use the ops."""
    spec, jspec = SPECS[name]
    a = _inputs(spec, 8)[:, :96].reshape(spec.num_limbs, 3, 32)
    c = _inputs(spec, 9)[:, 8:9]
    want = np.asarray(jops.mont_mul(jspec, a, c[:, :, None]))
    got = ops.mont_mul(spec, _t(a, spec), _t(c, spec)[:, :, None])
    np.testing.assert_array_equal(convert.to_numpy(got), want)
    want = np.asarray(jops.sub(jspec, a, c[:, :, None]))
    got = ops.sub(spec, _t(a, spec), _t(c, spec)[:, :, None])
    np.testing.assert_array_equal(convert.to_numpy(got), want)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_golden_field_vectors(name):
    with open(os.path.join(VEC_DIR, "field_vectors.json")) as f:
        v = json.load(f)["fields"][name]
    spec, _ = SPECS[name]
    _i = lambda s: int(s, 16)
    assert spec.modulus == _i(v["modulus"])
    assert spec.r % spec.modulus == _i(v["mont_r"])
    assert spec.r2 == _i(v["mont_r2"])
    assert spec.n0_inv == _i(v["n0_16"])
    ks = v["kats"]
    K = spec.num_limbs
    a_std = _t(ints_to_limbs([_i(k["a"]) for k in ks], K), spec)
    b_std = _t(ints_to_limbs([_i(k["b"]) for k in ks], K), spec)
    a_m, b_m = ops.to_mont(spec, a_std), ops.to_mont(spec, b_std)
    ints = lambda t: limbs_to_ints(convert.to_numpy(t))
    assert ints(a_m) == [_i(k["a_mont"]) for k in ks]
    assert ints(ops.add(spec, a_std, b_std)) == [_i(k["add"]) for k in ks]
    assert ints(ops.sub(spec, a_std, b_std)) == [_i(k["sub"]) for k in ks]
    assert ints(ops.neg(spec, a_std)) == [_i(k["neg"]) for k in ks]
    assert ints(ops.from_mont(spec, ops.mont_mul(spec, a_m, b_m))) == \
        [_i(k["mul"]) for k in ks]
    assert ints(ops.from_mont(spec, ops.mont_sqr(spec, a_m))) == \
        [_i(k["sqr"]) for k in ks]
    for w in v["wire"]:
        got = ints_to_limbs([spec.to_mont(_i(w["value"]))], K)[:, 0]
        assert got.tolist() == w["mont_limbs_le16"]


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_field_specs_match_jax_package(name):
    spec, jspec = SPECS[name]
    assert (spec.modulus, spec.num_limbs, spec.r2, spec.n0_inv) == \
        (jspec.modulus, jspec.num_limbs, jspec.r2, jspec.n0_inv)
    np.testing.assert_array_equal(spec.one_mont_limbs, jspec.one_mont_limbs)


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_cuda_header_constants(name):
    """The 32-bit-word constants in csrc/field.cuh are the field's own."""
    spec, _ = SPECS[name]
    with open(os.path.join(ROOT, "tpu_bls12_381_torch", "csrc", "field.cuh")) as f:
        src = f.read()
    W = spec.num_limbs // 2

    def words(sym):
        body = re.search(rf"{sym}\[{W}\]\s*=\s*\{{([^}}]*)\}}", src).group(1)
        vals = [int(x.rstrip("u"), 16) for x in re.findall(r"0x[0-9a-fA-F]+u?", body)]
        assert len(vals) == W
        return sum(v << (32 * i) for i, v in enumerate(vals))

    tag = name.upper()
    assert words(f"{tag}_P") == spec.modulus
    assert words(f"{tag}_ONE") == spec.r % spec.modulus
    struct = re.search(rf"struct {name.capitalize()} \{{(.*?)\}};", src, re.S).group(1)
    n0 = int(re.search(r"N0 = (0x[0-9a-fA-F]+)u", struct).group(1), 16)
    assert n0 == spec.n0_inv32
    assert (n0 * spec.modulus + 1) % (1 << 32) == 0
    assert f"W = {W};" in struct and f"K = {spec.num_limbs};" in struct


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_wrappers_copy_nothing_and_fast_lays_out(name, monkeypatch):
    """The kernel wrappers raise on a view or on operands of two shapes (the
    product takes a plane and a (K, 1) column besides); ``fast`` broadcasts
    and lays out for them, with the same values, and hands a factor that is
    one element to the product as that column, never as a plane."""
    spec = {"fr": FR, "fq": FQ}[name]
    K = spec.num_limbs
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(0, 1 << 16, size=(K, 8),
                                      dtype=np.int64).astype(np.int32))
    a[-1] = 0                                        # canonical: below p
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.mont_mul(spec, a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ops.mont_sqr(spec, a[:, ::2])
    with pytest.raises(ValueError, match="shapes differ"):
        cuda_ops.mont_mul(spec, a, a[:, :2].contiguous())
    col = a[:, :1].contiguous()
    assert torch.equal(cuda_ops.mont_mul(spec, a, col), ops.mont_mul(spec, a, col))
    seen = []
    kernel = cuda_ops.mont_mul
    monkeypatch.setattr(cuda_ops, "mont_mul", lambda s_, x, y: (
        seen.append((tuple(x.shape), tuple(y.shape))), kernel(s_, x, y))[1])
    want = ops.mont_mul(spec, a[:, ::2], a[:, :1])
    assert want.shape == (K, 4)
    assert torch.equal(fast.mont_mul(spec, a[:, ::2], a[:, :1]), want)
    assert torch.equal(fast.mont_mul(spec, a[:, :1], a[:, ::2]), want)
    a3 = a.reshape(K, 2, 4)
    assert torch.equal(fast.mont_mul(spec, a3, a[:, :1, None]),
                       ops.mont_mul(spec, a3, a[:, :1, None]))
    assert torch.equal(fast.mont_mul(spec, a3[:, :, :1], a3),
                       ops.mont_mul(spec, a3[:, :, :1], a3))
    assert seen == [((K, 4), (K, 1)), ((K, 4), (K, 1)), ((K, 2, 4), (K, 1)),
                    ((K, 2, 4), (K, 2, 4))]
    seen.clear()
    assert torch.equal(fast.from_mont(spec, a[:, ::2]), ops.from_mont(spec, a[:, ::2]))
    assert seen == [((K, 4), (K, 1))]
    assert torch.equal(fast.mont_sqr(spec, a[:, ::2]),
                       ops.mont_sqr(spec, a[:, ::2]))


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_add_sub_take_columns_and_one_operand_forms(name, monkeypatch):
    """``fast.add`` and ``fast.sub`` hand an operand that is one element to
    the wrappers as a (K, 1) column, on either side of the sub (the add
    swaps it to the right), never as a plane; ``fast.double`` and
    ``fast.neg`` hand them one plane.  The values are the JAX package's add,
    sub, double and neg (neg(0) = 0, sums past p, differences below 0)."""
    spec, jspec = SPECS[name]
    K = spec.num_limbs
    a = _inputs(spec, 21)[:, :12].copy()
    for col_lane in (0, 2, 9):                      # the column: 0, p - 1, a random one
        c = _inputs(spec, 22)[:, col_lane:col_lane + 1].copy()
        ta, tc = _t(a, spec), _t(c, spec)
        jc = np.broadcast_to(c, a.shape).copy()
        seen = []
        for op in ("add", "sub"):
            kernel = getattr(cuda_ops, op)
            monkeypatch.setattr(cuda_ops, op, lambda s_, x, y, k_=kernel, o_=op: (
                seen.append((o_, tuple(x.shape), tuple(y.shape))), k_(s_, x, y))[1])
        same = lambda got, want: np.testing.assert_array_equal(convert.to_numpy(got),
                                                               np.asarray(want))
        same(fast.add(spec, ta, tc), jops.add(jspec, a, jc))
        same(fast.add(spec, tc, ta), jops.add(jspec, jc, a))
        same(fast.sub(spec, ta, tc), jops.sub(jspec, a, jc))
        same(fast.sub(spec, tc, ta), jops.sub(jspec, jc, a))
        t3, c3 = ta.reshape(K, 3, 4), tc.reshape(K, 1, 1)
        same(fast.sub(spec, c3, t3), jops.sub(jspec, jc, a).reshape(K, 3, 4))
        assert seen == [("add", (K, 12), (K, 1))] * 2 + [("sub", (K, 12), (K, 1)),
                                                         ("sub", (K, 1), (K, 12)),
                                                         ("sub", (K, 1), (K, 3, 4))]
        monkeypatch.undo()
    same(fast.double(spec, ta), jops.double(jspec, a))
    same(fast.neg(spec, ta), jops.neg(jspec, a))
    same(fast.neg(spec, ta[:, ::3]), jops.neg(jspec, a[:, ::3]))
    assert not fast.neg(spec, ta[:, :1]).any()      # lane 0 holds 0
    for fn in (cuda_ops.double, cuda_ops.neg):
        with pytest.raises(ValueError, match="contiguous"):
            fn(spec, ta[:, ::2])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    a = ops.zeros(FQ, (4,), device="cpu")
    with pytest.raises(TypeError):
        cuda_ops.mont_mul(FQ, a.to(torch.int64), a)
    with pytest.raises(ValueError):
        cuda_ops.mont_mul(FQ, a[:16], a)
    with pytest.raises(ValueError, match="expected shape"):  # a column of Fr's height
        cuda_ops.mont_mul(FQ, a, ops.zeros(FR, (1,), device="cpu"))
    with pytest.raises(ValueError, match="shapes differ"):   # (K, 2): no column
        cuda_ops.mont_mul(FQ, a, ops.zeros(FQ, (2,), device="cpu"))
    with pytest.raises(TypeError):
        cuda_ops.mont_sqr(FQ, a.numpy())
    with pytest.raises(ValueError, match="expected shape"):
        cuda_ops.field_inv(FQ, a[:16])
    with pytest.raises(ValueError):
        convert.scalars_from_numpy(np.zeros((24, 4), np.uint32), device="cpu")
    with pytest.raises(ValueError):
        convert.scalars_from_numpy(np.full((16, 4), 1 << 16, np.uint32),
                                   device="cpu")


@pytest.mark.parametrize("build", ["one lane a thread for Fq too",
                                   "four lanes a thread for Fr too",
                                   "streaming loads and stores",
                                   "a grid of the SMs' resident blocks",
                                   "add and sub one lane a thread for Fr too",
                                   "add and sub four lanes a thread for Fq too",
                                   "field_sum one lane a step",
                                   "field_sum in one launch"])
def test_field_sweep_builds_change_statements_the_sources_hold(build):
    """Each build that fields/sweeps.py times against the kept one replaces
    statements that stand once in the sources."""
    from tpu_bls12_381_torch import _build
    from tpu_bls12_381_torch.fields import sweeps

    for file_, old, new in sweeps.BUILDS[build]:
        assert (_build.CSRC_DIR / file_).read_text().count(old) == 1, (file_, old)
        assert old != new


def test_field_sweeps_need_the_card(monkeypatch):
    from tpu_bls12_381_torch.fields import sweeps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["sweeps"])
    assert sweeps.main() == 1


def test_convert_round_trip():
    rng = np.random.default_rng(11)
    s = rng.integers(0, 1 << 16, size=(16, 9), dtype=np.uint32)
    x = rng.integers(0, 1 << 16, size=(24, 9), dtype=np.uint32)
    inf = rng.integers(0, 2, size=9).astype(bool)
    ts = convert.scalars_from_numpy(s, device="cpu")
    tx, ty, tinf = convert.affine_from_numpy(x, x[::-1], inf, device="cpu")
    assert ts.dtype == ops.LIMB_DTYPE and tinf.dtype == torch.bool
    np.testing.assert_array_equal(convert.to_numpy(ts), s)
    got = convert.point_to_numpy((tx, ty, tinf))
    np.testing.assert_array_equal(got[0], x)
    np.testing.assert_array_equal(got[1], x[::-1])
    np.testing.assert_array_equal(got[2], inf)
    assert got[0].dtype == np.uint32


def test_makers_raise_without_a_card():
    """``device=None`` means the CUDA card; without one the makers raise and
    never carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the makers do not raise")
    from tpu_bls12_381_torch.curves import g1

    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.zeros(FQ, (2,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        g1.generator_affine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.scalars_from_numpy(np.zeros((16, 2), np.uint32))


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import tpu_bls12_381_torch\n"
        "import tpu_bls12_381_torch.msm, tpu_bls12_381_torch.convert\n"
        "import tpu_bls12_381_torch.curves.glv, tpu_bls12_381_torch.curves.cuda_g1\n"
        "import tpu_bls12_381_torch.runtime.tracing, tpu_bls12_381_torch.tuning\n"
        "import tpu_bls12_381_torch.vecops, tpu_bls12_381_torch.ntt.cuda_ntt\n"
        "import tpu_bls12_381_torch.runtime.ntt_context\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'tpu_bls12_381' or m.startswith('tpu_bls12_381.')"
        " or m == 'triton')\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code],
                         capture_output=True, text=True, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert port.__version__


def test_no_source_of_the_port_imports_jax():
    pat = re.compile(r"^\s*(import jax|from jax|import tpu_bls12_381\b(?!_)"
                     r"|from tpu_bls12_381\b(?!_))", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "tpu_bls12_381_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
