"""The vector ops of the PyTorch/CUDA port against the JAX package, on the CPU.

The same inputs, made from a numpy seed, go through each function of the JAX
package's ``vecops.py`` and its counterpart in ``tpu_bls12_381_torch``.  All
results are canonical limbs, so every comparison is exact equality.
"""

import numpy as np
import pytest
import torch

from tpu_bls12_381 import vecops as jvecops
from tpu_bls12_381.fields import FQ as JFQ, FR as JFR

from tpu_bls12_381_torch import convert, vecops
from tpu_bls12_381_torch.fields import FQ, FR, cuda_ops, ops
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs, limbs_to_ints

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)

SPECS = {"fr": (FR, JFR), "fq": (FQ, JFQ)}


def _rand(spec, n, seed):
    """(K, n) canonical elements as numpy uint32 limbs; lanes 0..2 hold 0, 1
    and p - 1 where there is room."""
    rng = np.random.default_rng(seed)
    p = spec.modulus
    vals = [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n)]
    for i, v in enumerate([0, 1, p - 1][:max(0, n - 1)]):
        vals[i] = v
    return ints_to_limbs(vals, spec.num_limbs)


def _t(arr, spec):
    return convert.field_from_numpy(arr, spec, device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("n", [1, 5, 64])
def test_vector_algebra_matches_jax(name, n):
    spec, jspec = SPECS[name]
    a, b = _rand(spec, n, 1), _rand(spec, n, 2)[:, ::-1].copy()
    s = _rand(spec, 4, 3)[:, 3]
    ta, tb, ts = _t(a, spec), _t(b, spec), _t(s, spec)
    before = dict(cuda_ops.LAUNCHES)
    _same(vecops.vector_add(spec, ta, tb), jvecops.vector_add(jspec, a, b))
    _same(vecops.vector_sub(spec, ta, tb), jvecops.vector_sub(jspec, a, b))
    _same(vecops.vector_mul(spec, ta, tb), jvecops.vector_mul(jspec, a, b))
    _same(vecops.scalar_vec_mul(spec, ts, tb), jvecops.scalar_vec_mul(jspec, s, b))
    _same(vecops.scalar_vec_add(spec, ts, tb), jvecops.scalar_vec_add(jspec, s, b))
    assert cuda_ops.LAUNCHES == before              # CPU tensors launch nothing


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 4097])
def test_vector_sum_matches_jax(name, n):
    spec, jspec = SPECS[name]
    a = _rand(spec, n, 4)
    got = vecops.vector_sum(spec, _t(a, spec))
    _same(got, jvecops.vector_sum(jspec, a))
    assert limbs_to_ints(convert.to_numpy(got)[:, None])[0] == \
        sum(limbs_to_ints(a)) % spec.modulus


def test_vector_sum_over_a_batch():
    a = _rand(FR, 30, 5).reshape(16, 3, 10)
    got = vecops.vector_sum(FR, _t(a, FR))
    _same(got, jvecops.vector_sum(JFR, a))
    assert got.shape == (16, 3)


@pytest.mark.parametrize("name", ["fr", "fq"])
@pytest.mark.parametrize("n", [2, 7, 4097])
def test_vector_sum_of_p_minus_1_over_a_batch(name, n):
    """Every lane p - 1 (the sum wraps past p at nearly every add) in the
    first row of a batch of 3, random lanes in the others: the JAX package's
    sum, and n (p - 1) mod p in the first row."""
    spec, jspec = SPECS[name]
    p = spec.modulus
    a = np.concatenate([ints_to_limbs([p - 1] * n, spec.num_limbs)[:, None],
                        _rand(spec, 2 * n, 9).reshape(spec.num_limbs, 2, n)], axis=1)
    got = vecops.vector_sum(spec, _t(a, spec))
    assert got.shape == (spec.num_limbs, 3)
    _same(got, jvecops.vector_sum(jspec, a))
    assert limbs_to_ints(convert.to_numpy(got)[:, :1])[0] == n * (p - 1) % p


def test_vector_sum_is_one_reduction(monkeypatch):
    """``vector_sum`` calls ``cuda_ops.field_sum`` once on the whole vector
    (one or two launches on the card) and, for n == 1, nothing."""
    seen = []
    fn = cuda_ops.field_sum
    monkeypatch.setattr(cuda_ops, "field_sum", lambda s_, v: (
        seen.append(tuple(v.shape)), fn(s_, v))[1])
    a = _t(_rand(FQ, 30, 10), FQ).reshape(24, 3, 10)
    assert torch.equal(vecops.vector_sum(FQ, a), cuda_ops.field_sum_plain(FQ, a))
    assert torch.equal(vecops.vector_sum(FQ, a[..., :1]), a[..., 0])
    assert seen == [(24, 3, 10)]
    with pytest.raises(ValueError, match="n >= 1"):
        cuda_ops.field_sum(FQ, a[..., :0].contiguous())


@pytest.mark.parametrize("name", ["fr", "fq"])
def test_scalar_column_forms_match_jax(name):
    """A scalar added to a batched vector and subtracted on either side (the
    sub's column left and right), against the JAX package's ops on the
    scalar broadcast out."""
    from tpu_bls12_381.fields import ops as jops

    spec, jspec = SPECS[name]
    K = spec.num_limbs
    v = _rand(spec, 24, 11).reshape(K, 2, 12)
    for lane in (0, 2, 3):                          # 0, p - 1, a random scalar
        s = _rand(spec, 4, 12)[:, lane]
        sb = np.broadcast_to(s.reshape(K, 1, 1), v.shape).copy()
        tv, ts = _t(v, spec), _t(s, spec)
        _same(vecops.scalar_vec_add(spec, ts, tv), jvecops.scalar_vec_add(jspec, s, v))
        col = ts.reshape(K, 1, 1)
        _same(vecops.vector_sub(spec, tv, col), jops.sub(jspec, v, sb))
        _same(vecops.vector_sub(spec, col, tv), jops.sub(jspec, sb, v))


def test_bit_reverse_matches_jax():
    assert list(vecops.bit_reverse_indices(3)) == [0, 4, 2, 6, 1, 5, 3, 7]
    np.testing.assert_array_equal(vecops.bit_reverse_indices(6),
                                  jvecops.bit_reverse_indices(6))
    a = _rand(FR, 128, 6).reshape(16, 2, 64)
    t = _t(a, FR)
    _same(vecops.bit_reverse(t), jvecops.bit_reverse(a))
    _same(vecops.bit_reverse(t.transpose(1, 2), axis=1),
          jvecops.bit_reverse(a.transpose(0, 2, 1), axis=1))
    assert torch.equal(vecops.bit_reverse(vecops.bit_reverse(t)), t)
    # the index tensor is made once per (size, device), and can be dropped
    idx = vecops._bit_reverse_index(6, "cpu")
    assert vecops._bit_reverse_index(6, "cpu") is idx
    vecops.release_bit_reverse()
    assert vecops._bit_reverse_index(6, "cpu") is not idx
    with pytest.raises(ValueError, match="power-of-two"):
        vecops.bit_reverse(t[:, :, :12])


@pytest.mark.parametrize("name,n", [("fr", 1), ("fr", 3), ("fr", 100),
                                    ("fq", 100), ("fr", 4100)])
def test_batch_inverse_matches_jax(name, n):
    """Zeros in a few lanes (inv(0) = 0), and at 4100 a length that is no
    multiple of the 4096-lane tile (two rows, the second padded)."""
    spec, jspec = SPECS[name]
    a = _rand(spec, n, 7)
    if n >= 3:
        a[:, n // 2] = 0
    got = vecops.batch_inverse(spec, _t(a, spec))
    _same(got, jvecops.batch_inverse(jspec, a))
    zero = ops.is_zero(spec, _t(a, spec))
    assert bool(ops.is_zero(spec, got)[zero].all())
    prod = ops.mont_mul(spec, got, _t(a, spec))
    one = ops.one_mont(spec, (n,), device="cpu")
    assert torch.equal(prod[:, ~zero], one[:, ~zero])


def test_batch_inverse_all_zero_and_batched():
    z = ops.zeros(FR, (7,), device="cpu")
    assert not vecops.batch_inverse(FR, z).any()
    a = _rand(FR, 24, 8)
    got = vecops.batch_inverse(FR, _t(a, FR).reshape(16, 2, 12))
    assert got.shape == (16, 2, 12)
    assert torch.equal(got.reshape(16, 24), vecops.batch_inverse(FR, _t(a, FR)))
