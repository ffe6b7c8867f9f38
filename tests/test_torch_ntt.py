"""The NTT of the PyTorch/CUDA port against the JAX package, on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and its
counterpart in ``tpu_bls12_381_torch`` (plain PyTorch versions, since the
tensors live on the CPU).  Everything is integer arithmetic with canonical
results, so every comparison is exact equality of limbs.

The JAX four-step runs only on a TPU (its tile kernel is too slow in
interpret mode), so the port's four-step, forced and through the tile's plain
version, is held against the JAX ladder ``_ntt_core``, which is what the JAX
package's own tests chain its four-step to.
"""

import hashlib
import importlib
import json
import os

import numpy as np
import pytest
import torch

from tpu_bls12_381.ntt import (coset_intt as j_coset_intt, coset_ntt as j_coset_ntt,
                               get_domain as j_get_domain, intt as j_intt,
                               ntt as j_ntt)
from tpu_bls12_381.ntt.ntt import Ordering as JOrdering, _ntt_core as j_ntt_core

from tpu_bls12_381_torch import _build, convert, oracle
from tpu_bls12_381_torch.fields import FR, cuda_ops, ops
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs, limbs_to_ints
from tpu_bls12_381_torch.ntt import (Domain, Ordering, coset_intt, coset_ntt,
                                     cuda_ntt, get_domain, intt, ntt,
                                     release_domain)
from tpu_bls12_381_torch.ntt.ntt import (_ntt_core, _route_fourstep,
                                         coset_powers)
from tpu_bls12_381_torch.ntt import sweeps
from tpu_bls12_381_torch.runtime import (AsyncHandle, ImmediateHandle, NttContext,
                                         config, reset_config_cache)

# The port's CPU path is thousands of tiny tensor ops; PyTorch's intra-op
# threads only spin between them, and with several test workers on one
# machine they starve each other.  One thread is the fastest setting here.
torch.set_num_threads(1)

K = FR.num_limbs
VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors")


def _rand(shape, seed):
    """Random canonical Fr elements as numpy uint32 limbs (top limb below the
    modulus's, so every value is < r)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 16, size=(K,) + tuple(shape), dtype=np.uint32)
    v[-1] = rng.integers(0, int(FR.modulus_limbs[-1]), size=shape, dtype=np.uint32)
    return v


def _t(arr):
    return convert.field_from_numpy(arr, FR, device="cpu")


def _same(got, want):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@pytest.fixture
def algorithm(monkeypatch):
    """Set MIDNIGHT_NTT_ALGORITHM for the port; restored after the test."""
    def set_to(name):
        monkeypatch.setenv("MIDNIGHT_NTT_ALGORITHM", name)
        reset_config_cache()

    yield set_to
    monkeypatch.delenv("MIDNIGHT_NTT_ALGORITHM", raising=False)
    reset_config_cache()


# ----------------------------------------------------------------------------
# Domain tables
# ----------------------------------------------------------------------------

def test_domain_tables_match_jax():
    jd = j_get_domain(10)
    d = get_domain(10, device="cpu")
    _same(d.tw, jd.tw)
    _same(d.itw, jd.itw)
    _same(d.n_inv, jd.n_inv)
    assert d.omega == jd.omega == oracle.root_of_unity(10)
    assert d.n == 1024 and d.tw.dtype == ops.LIMB_DTYPE


def test_domain_cache_reuse_release_and_range():
    d1 = get_domain(6, device="cpu")
    assert get_domain(6, device="cpu") is d1
    release_domain(6)
    assert get_domain(6, device="cpu") is not d1
    release_domain()
    with pytest.raises(ValueError):
        get_domain(33, device="cpu")
    with pytest.raises(ValueError):
        get_domain(-1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_domain(4)


def test_domain_convert_round_trip():
    """A JAX Domain carried across as numpy arrays serves the port's NTT, and
    comes back as the arrays it was."""
    jd = j_get_domain(6)
    d = convert.domain_from_numpy(6, np.asarray(jd.tw), np.asarray(jd.itw),
                                  np.asarray(jd.n_inv), device="cpu")
    assert isinstance(d, Domain) and d.omega == jd.omega
    for got, want in zip(convert.domain_to_numpy(d), (jd.tw, jd.itw, jd.n_inv)):
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, np.asarray(want))
    x = _rand((64,), 40)
    _same(ntt(_t(x), domain=d), j_ntt(x))
    with pytest.raises(ValueError):
        convert.domain_from_numpy(7, np.asarray(jd.tw), np.asarray(jd.itw),
                                  np.asarray(jd.n_inv), device="cpu")


# ----------------------------------------------------------------------------
# The ladder against JAX
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("log_n", [0, 1, 4, 7, 10])
def test_forward_matches_jax(log_n):
    x = _rand((1 << log_n,), log_n)
    _same(ntt(_t(x)), j_ntt(x))


@pytest.mark.parametrize("log_n", [1, 6])
def test_inverse_matches_jax_and_round_trips(log_n):
    x = _rand((1 << log_n,), 20 + log_n)
    _same(intt(_t(x)), j_intt(x))
    assert torch.equal(intt(ntt(_t(x))), _t(x))
    assert torch.equal(ntt(intt(_t(x))), _t(x))


# The card split's cases below, one log_n an ordering.  The orderings test
# takes the same sizes: the JAX ladder is compiled once a shape and ordering,
# so both tests share each compile.
CARD_SPLIT_CASES = [(7, "NN", 4), (8, "NR", 5), (9, "RN", 4), (10, "RR", 5)]
ORDERING_LOG_N = {name: log_n for log_n, name, _ in CARD_SPLIT_CASES}


@pytest.mark.parametrize("name", ["NN", "NR", "RN", "RR"])
def test_orderings_match_jax(name):
    x = _rand((1 << ORDERING_LOG_N[name],), 30)
    _same(ntt(_t(x), Ordering(name)), j_ntt(x, JOrdering(name)))
    _same(intt(_t(x), Ordering(name)), j_intt(x, JOrdering(name)))


def test_nr_then_rn_round_trip():
    x = _t(_rand((64,), 31))
    assert torch.equal(intt(ntt(x, Ordering.NR), Ordering.RN), x)


def test_coset_matches_jax():
    x = _rand((64,), 32)
    _same(coset_ntt(_t(x), 5), j_coset_ntt(x, 5))
    _same(coset_intt(_t(x), 5), j_coset_intt(x, 5))
    assert torch.equal(coset_intt(coset_ntt(_t(x), 5), 5), _t(x))
    cp = coset_powers(5, 64, device="cpu")
    assert coset_powers(5, 64, device="cpu") is cp
    got = limbs_to_ints(convert.to_numpy(ops.from_mont(FR, cp)))
    assert got == [pow(5, i, FR.modulus) for i in range(64)]


def test_batched_matches_jax():
    x = _rand((3, 64), 33)
    _same(ntt(_t(x)), j_ntt(x))
    _same(coset_ntt(_t(x), 7), j_coset_ntt(x, 7))
    got = ntt(_t(x))
    for i in range(3):
        assert torch.equal(got[:, i], ntt(_t(x[:, i])))


def test_strided_input_is_laid_out():
    x = _rand((2, 32), 34)
    view = _t(x).transpose(1, 2)[:, :, 0]           # (K, 32), not contiguous
    assert not view.is_contiguous()
    assert torch.equal(ntt(view, Ordering.RN), ntt(view.contiguous(), Ordering.RN))


def test_errors():
    x = _t(_rand((12,), 35))
    with pytest.raises(ValueError, match="power of two"):
        ntt(x)
    with pytest.raises(ValueError, match="power of two"):
        cuda_ntt.ntt_fourstep(x)
    x = _t(_rand((16,), 36))
    with pytest.raises(ValueError, match="domain is for"):
        intt(x, domain=get_domain(5, device="cpu"))
    for bad in (Ordering.RN, Ordering.RR):
        with pytest.raises(ValueError, match="natural-order input"):
            coset_ntt(x, 7, bad)
    for bad in (Ordering.NR, Ordering.RR):
        with pytest.raises(ValueError, match="natural-order output"):
            coset_intt(x, 7, bad)


# ----------------------------------------------------------------------------
# Golden vectors, on both routes
# ----------------------------------------------------------------------------

def _vector_cases():
    with open(os.path.join(VEC_DIR, "ntt_vectors.json")) as f:
        return json.load(f)["cases"]


@pytest.mark.parametrize("algo", ["radix2", "fourstep"])
@pytest.mark.parametrize("idx", [0, 1, 2, 3])
def test_golden_vectors(idx, algo, algorithm):
    case = _vector_cases()[idx]
    n = 1 << case["log_n"]
    algorithm(algo)
    if case["kind"] == "forward_digest":
        vals = [(i * i + 3) % FR.modulus for i in range(n)]
    else:
        vals = [int(s, 16) for s in case["input"]]
    x = ops.to_mont(FR, _t(ints_to_limbs(vals, K)))
    assert _route_fourstep(x, Ordering.NN) is (algo == "fourstep")
    y = coset_ntt(x, case["shift"]) if case["kind"] == "coset" else ntt(x)
    got = limbs_to_ints(convert.to_numpy(ops.from_mont(FR, y)))
    if case["kind"] == "forward_digest":
        hsh = hashlib.sha256()
        for v in got:
            hsh.update(v.to_bytes(32, "little"))
        assert hsh.hexdigest() == case["output_sha256_le32"]
    else:
        assert got == [int(s, 16) for s in case["output"]]


# ----------------------------------------------------------------------------
# The four-step (forced, plain tile) against the JAX ladder
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [10, 12])
def test_fourstep_matches_jax_ladder(log_n, inverse):
    x = _rand((1 << log_n,), 50 + log_n)
    jd = j_get_domain(log_n)
    want = j_ntt_core(x, log_n, inverse, JOrdering.NN,
                      jd.itw if inverse else jd.tw, jd.n_inv)
    dom = get_domain(log_n, device="cpu")
    _same(cuda_ntt.ntt_fourstep(_t(x), inverse=inverse, domain=dom), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_batched_matches_jax_ladder(inverse):
    x = _rand((2, 2, 1 << 10), 60)
    jd = j_get_domain(10)
    want = j_ntt_core(x, 10, inverse, JOrdering.NN,
                      jd.itw if inverse else jd.tw, jd.n_inv)
    _same(cuda_ntt.ntt_fourstep(_t(x), inverse=inverse), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_recursive_matches_ladder(inverse, monkeypatch):
    """One level of recursion (domains past 2^(2*cap)) at a shrunken tile cap,
    so that it runs at 2^15, against the port's ladder (held against JAX
    above) and against the oracle at three places."""
    monkeypatch.setattr(cuda_ntt, "_cap_log", lambda device: 7)
    log_n = 15
    la, lb = cuda_ntt._split_top(log_n, 7)
    assert (la, lb) == (7, 8) and lb > 7              # the inner factor recurses
    x = _t(_rand((1 << log_n,), 61))
    assert cuda_ntt.fourstep_supported(x)
    dom = get_domain(log_n, device="cpu")
    got = cuda_ntt.ntt_fourstep(x, inverse=inverse, domain=dom)
    want = _ntt_core(x, log_n, inverse, Ordering.NN,
                     dom.itw if inverse else dom.tw, dom.n_inv)
    assert torch.equal(got, want)
    if not inverse:
        xs = limbs_to_ints(convert.to_numpy(ops.from_mont(FR, x)))
        r = FR.modulus
        ks = [0, 1 << 14, 12345]
        ys = limbs_to_ints(convert.to_numpy(ops.from_mont(FR, got[:, ks])))
        for k, y in zip(ks, ys):
            wk = pow(dom.omega, k, r)
            acc = 0
            for v in reversed(xs):
                acc = (acc * wk + v) % r
            assert y == acc
    release_domain(log_n)
    cuda_ntt.release_fourstep_cache()


def test_fourstep_reads_columns_where_they_lie(monkeypatch):
    """The four-step hands both tiles the array where it lies (the tile reads
    its rows as columns, bit-reversed as they load): no ``bit_reverse``
    gather and no transposed copy before a tile."""
    calls, real = [], cuda_ntt.ntt_tile_columns

    def spy(x, tw, w=None, scale=None, brev_cols=False):
        calls.append((tuple(x.shape), w is not None, scale is not None, brev_cols,
                      x.is_contiguous()))
        return real(x, tw, w, scale, brev_cols)

    x = _t(_rand((2, 1 << 10), 63))
    want = ntt(x)
    monkeypatch.setattr(cuda_ntt, "ntt_tile_columns", spy)
    y = cuda_ntt.ntt_fourstep(x)
    assert torch.equal(y, want)
    assert calls == [((K, 2, 32, 32), True, False, False, True),
                     ((K, 2, 32, 32), False, False, False, True)]
    z = cuda_ntt.ntt_fourstep(y, inverse=True)
    assert torch.equal(z, x) and calls[-1][2]          # the 1/n in the second tile
    monkeypatch.setattr(cuda_ntt, "bit_reverse", lambda *a, **k: pytest.fail("gathered"))
    monkeypatch.setattr(cuda_ntt, "ntt_tile_columns",
                        lambda x, *a, **k: x.reshape(K, -1, x.shape[2]))
    cuda_ntt.ntt_fourstep(x)                            # no gather around the tiles


def test_ntt_tile_columns_plain_is_the_tile_on_the_columns():
    """Row b*C + j of the result is the NTT of column j (brev(j)) of block b;
    CPU tensors launch nothing."""
    from tpu_bls12_381_torch.vecops import bit_reverse

    x = _t(_rand((2, 16, 4), 64))
    dom = get_domain(4, device="cpu")
    before = dict(cuda_ntt.LAUNCHES)
    for brev in (False, True):
        got = cuda_ntt.ntt_tile_columns(x, dom.tw, brev_cols=brev)
        cols = x.transpose(-1, -2)
        if brev:
            cols = bit_reverse(cols, axis=-2)
        assert torch.equal(got, ntt(cols.contiguous()).reshape(K, 8, 16))
    with pytest.raises(ValueError, match="power of two"):
        cuda_ntt.ntt_tile_columns(_t(_rand((1, 16, 3), 65)), dom.tw)
    with pytest.raises(ValueError, match="Bw dividing"):
        cuda_ntt.ntt_tile_columns(x, dom.tw, w=_t(_rand((3, 16), 66)))
    assert cuda_ntt.LAUNCHES == before


def test_fourstep_round_trip_and_cache():
    x = _t(_rand((1 << 10,), 62))
    y = cuda_ntt.ntt_fourstep(x)
    assert torch.equal(cuda_ntt.ntt_fourstep(y, inverse=True), x)
    W = cuda_ntt._step_w(10, 32, 32, False, "cpu")
    assert cuda_ntt._step_w(10, 32, 32, False, "cpu") is W
    got = limbs_to_ints(convert.to_numpy(ops.from_mont(FR, W[:, 3, :5])))
    w = oracle.root_of_unity(10)
    assert got == [pow(w, 3 * k, FR.modulus) for k in range(5)]
    cuda_ntt.release_fourstep_cache()
    assert cuda_ntt._step_w(10, 32, 32, False, "cpu") is not W


# ----------------------------------------------------------------------------
# The tile: plain version, wrapper checks
# ----------------------------------------------------------------------------

def test_ntt_tile_plain_is_the_ladder_with_folds():
    """Bit-reversed rows in, natural rows out; ``w`` of 2 rows serves 6 rows
    periodically; the scalar multiplies every element."""
    from tpu_bls12_381_torch.vecops import bit_reverse

    B, m = 6, 16
    x = _t(_rand((B, m), 70))
    w = _t(_rand((2, m), 71))
    dom = get_domain(4, device="cpu")
    plain = ntt(x)
    before = dict(cuda_ntt.LAUNCHES)
    assert torch.equal(cuda_ntt.ntt_tile(bit_reverse(x), dom.tw), plain)
    got = cuda_ntt.ntt_tile(bit_reverse(x), dom.tw, w=w, scale=dom.n_inv)
    want = ops.mont_mul(FR, ops.mont_mul(FR, plain, w.repeat(1, 3, 1)),
                        dom.n_inv[:, None, None])
    assert torch.equal(got, want)
    assert cuda_ntt.LAUNCHES == before              # CPU tensors launch nothing


def test_ntt_tile_refuses_what_the_kernel_does_not_take():
    x = _t(_rand((4, 16), 72))
    tw = get_domain(4, device="cpu").tw
    with pytest.raises(ValueError, match="shape"):
        cuda_ntt.ntt_tile(x[:, 0], tw)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ntt.ntt_tile(x.transpose(1, 2), tw)
    with pytest.raises(ValueError, match="twiddles"):
        cuda_ntt.ntt_tile(x, get_domain(3, device="cpu").tw)
    with pytest.raises(ValueError, match="Bw dividing"):
        cuda_ntt.ntt_tile(x, tw, w=_t(_rand((3, 16), 73)))
    with pytest.raises(ValueError, match="scalar"):
        cuda_ntt.ntt_tile(x, tw, scale=x[:, 0].contiguous())
    with pytest.raises(ValueError, match="power of two"):
        cuda_ntt.ntt_tile(_t(_rand((2, 1 << 13), 74)),
                          get_domain(13, device="cpu").tw)
    with pytest.raises(TypeError):
        cuda_ntt.ntt_tile(x.to(torch.int64), tw)
    release_domain(13)


# ----------------------------------------------------------------------------
# The card's ladder split (one tile launch, then butterfly_stages), forced on
# the CPU at a shrunken tile through the plain versions
# ----------------------------------------------------------------------------

NTT_MOD = importlib.import_module("tpu_bls12_381_torch.ntt.ntt")


@pytest.fixture
def card_split(monkeypatch):
    """Route the ladder as the card does, with tiles of 2^cap; record the
    kernel calls: ("tile", rows, m), ("columns", rows, m, brev_cols) and
    ("stages", half, count, table entries)."""
    calls = []
    real_tile, real_cols = cuda_ntt.ntt_tile, cuda_ntt.ntt_tile_columns
    real_stages = cuda_ops.butterfly_stages

    def tile(x, tw, w=None, scale=None):
        calls.append(("tile", x.shape[1], x.shape[2]))
        return real_tile(x, tw, w, scale)

    def columns(x, tw, w=None, scale=None, brev_cols=False):
        calls.append(("columns", x.shape[1] * x.shape[3], x.shape[2], brev_cols))
        return real_cols(x, tw, w, scale, brev_cols)

    def stages(spec, x, tw, half, count, scale=None):
        calls.append(("stages", half, count, tw.shape[1]))
        return real_stages(spec, x, tw, half, count, scale)

    def use(cap):
        monkeypatch.setattr(NTT_MOD, "ladder_tile_log", lambda x: cap)
        monkeypatch.setattr(cuda_ntt, "ntt_tile", tile)
        monkeypatch.setattr(cuda_ntt, "ntt_tile_columns", columns)
        monkeypatch.setattr(cuda_ops, "butterfly_stages", stages)
        return calls

    return use


def test_ladder_split():
    """The stages above the tile in as few launches of at most 6 as can be,
    as even as can be; none when the tile takes the whole row."""
    assert NTT_MOD.ladder_split(22, 11) == (11, [(11, 6), (17, 5)])
    assert NTT_MOD.ladder_split(22, 12) == (12, [(12, 5), (17, 5)])
    assert NTT_MOD.ladder_split(10, 11) == (10, [])
    assert NTT_MOD.ladder_split(28, 11) == (11, [(11, 6), (17, 6), (23, 5)])
    for log_n in range(1, 33):
        for c in (4, 5, 11, 12):
            t, launches = NTT_MOD.ladder_split(log_n, c)
            assert t == min(log_n, c)
            s = t
            for log_h, count in launches:
                assert log_h == s and 1 <= count <= cuda_ops.MAX_STAGES
                s += count
            assert s == log_n
            assert len(launches) == -(-(log_n - t) // cuda_ops.MAX_STAGES)
            counts = [k for _, k in launches]
            assert not counts or max(counts) - min(counts) <= 1
    assert NTT_MOD.ladder_tile_log(_t(_rand((16,), 80))) is None   # the CPU: per stage


@pytest.mark.parametrize("log_n,name,cap", CARD_SPLIT_CASES)
def test_card_ladder_split_matches_jax(log_n, name, cap, card_split):
    """ntt and intt through one tile of 2^cap rows (natural input: its
    columns, bit-reversed) and butterfly_stages launches (the inverse's 1/n
    folded into the last), in each ordering, equal the JAX package's."""
    x = _rand((1 << log_n,), 81 + log_n)
    calls = card_split(cap)
    _same(ntt(_t(x), Ordering(name)), j_ntt(x, JOrdering(name)))
    _same(intt(_t(x), Ordering(name)), j_intt(x, JOrdering(name)))
    _, launches = NTT_MOD.ladder_split(log_n, cap)
    rows = (1 << log_n) >> cap
    first = (("columns", rows, 1 << cap, True) if name in ("NN", "NR")
             else ("tile", rows, 1 << cap))
    want = [first] + [("stages", 1 << h, k, 1 << (h + k - 1)) for h, k in launches]
    assert calls == want + want


def test_card_ladder_split_coset_and_batch_match_jax(card_split):
    """The coset forms and a batch of 3 rows through the card's split."""
    x = _rand((3, 1 << 8), 90)
    calls = card_split(4)
    _same(coset_ntt(_t(x), 5), j_coset_ntt(x, 5))
    _same(coset_intt(_t(x), 5), j_coset_intt(x, 5))
    _same(ntt(_t(x)), j_ntt(x))
    assert calls[0] == ("columns", 3 * (1 << 4), 1 << 4, True)
    assert [c[0] for c in calls] == ["columns", "stages"] * 3   # 2^8: 4 + 4 stages


def test_butterfly_stages_refuses_what_the_kernel_does_not_take():
    x = _t(_rand((2, 64), 91))
    tw = get_domain(6, device="cpu").tw
    with pytest.raises(ValueError, match="count"):
        cuda_ops.butterfly_stages(FR, x, tw, 1, 7)
    with pytest.raises(ValueError, match="half"):
        cuda_ops.butterfly_stages(FR, x, tw, 16, 3)
    with pytest.raises(ValueError, match="twiddles"):
        cuda_ops.butterfly_stages(FR, x, get_domain(3, device="cpu").tw, 2, 3)
    with pytest.raises(ValueError, match="twiddles"):
        cuda_ops.butterfly_stages(FR, x, get_domain(7, device="cpu").tw, 2, 3)
    with pytest.raises(ValueError, match="scalar"):
        cuda_ops.butterfly_stages(FR, x, tw, 1, 2, scale=x[:, 0].contiguous())
    got = cuda_ops.butterfly_stages(FR, x, get_domain(4, device="cpu").tw, 2, 3)
    want = x
    for h in (2, 4, 8):
        want = cuda_ops.butterfly_stage_plain(FR, want, tw, h)
    assert torch.equal(got, want)        # the top stage's table, the row's own


# ----------------------------------------------------------------------------
# Routing and the split
# ----------------------------------------------------------------------------

def _fake(n, lead=()):
    """A (K, *lead, n) tensor that takes no memory."""
    return torch.zeros(1, dtype=torch.int32).expand((K,) + tuple(lead) + (n,))


def test_split_top_keeps_tile_bounds():
    for cap_log in (7, 11, 12):
        for log_n in range(10, 3 * cap_log + 1):
            la, lb = cuda_ntt._split_top(log_n, cap_log)
            assert la + lb == log_n
            assert lb <= 2 * cap_log, log_n
            if log_n <= 2 * cap_log:
                assert la <= cap_log and lb <= cap_log, log_n
            else:
                la2, lb2 = cuda_ntt._split_top(lb, cap_log)
                assert la2 <= cap_log and lb2 <= cap_log, log_n
                assert la >= 7, log_n


def test_fourstep_supported_shapes():
    cap_log = cuda_ntt._cap_log(torch.device("cpu"))
    assert cap_log == 12
    assert cuda_ntt.fourstep_supported(_fake(1 << 22))          # flat at 2^22
    assert cuda_ntt._split_top(22, cap_log) == (11, 11)
    assert cuda_ntt.fourstep_supported(_fake(1 << 25, lead=(2,)))
    assert cuda_ntt.fourstep_supported(_fake(1 << min(32, 3 * cap_log)))
    assert not cuda_ntt.fourstep_supported(_fake(1 << (3 * cap_log + 1)))
    assert not cuda_ntt.fourstep_supported(_fake(1 << 8))       # below 2^10
    assert not cuda_ntt.fourstep_supported(_fake(3 << 10))
    assert not cuda_ntt.fourstep_supported(torch.zeros(K, dtype=torch.int32))


def test_routing_rule(algorithm):
    """CPU tensors: auto takes the ladder, fourstep forces the four-step,
    radix2 and every ordering but NN take the ladder, and a shape the
    four-step does not handle takes the ladder whatever is forced."""
    big, small = _fake(1 << 20), _fake(1 << 8)
    algorithm("auto")
    assert config().ntt_algorithm == "auto"
    assert _route_fourstep(big, Ordering.NN) is False
    algorithm("fourstep")
    assert _route_fourstep(big, Ordering.NN) is True
    assert _route_fourstep(_fake(1 << 25), Ordering.NN) is True
    assert _route_fourstep(small, Ordering.NN) is False
    assert _route_fourstep(_fake(1 << 37), Ordering.NN) is False
    for o in (Ordering.NR, Ordering.RN, Ordering.RR):
        assert _route_fourstep(big, o) is False
    algorithm("mixedradix")
    assert config().ntt_algorithm == "fourstep"
    algorithm("radix2")
    assert _route_fourstep(big, Ordering.NN) is False


@pytest.mark.parametrize("name", sorted(sweeps.BUILDS))
def test_sweep_builds_change_statements_the_sources_hold(name):
    """Each build that ntt/sweeps.py times against the kept one replaces
    statements that stand once in the sources."""
    source, changes = sweeps.BUILDS[name]
    assert (_build.CSRC_DIR / f"{source}.cu").exists()
    for file_, old, new in changes:
        assert (_build.CSRC_DIR / file_).read_text().count(old) == 1, (file_, old)
        assert old != new


def test_sweep_sass_counts():
    text = """
\tcode for sm_90a
\t\tFunction : _Z5probeILi0ELi1EEvPKjPjm
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;      /* 0x00000a00ff017b82 */
                                                               /* 0x000fe40000000800 */
        /*0010*/              @P0 EXIT ;
        /*0020*/                   IMAD.WIDE.U32 R2, R4, R5, RZ ;
        /*0030*/                   IMAD.WIDE.U32 R6, R4, R5, R2 ;
\t\tFunction : _Z5probeILi0ELi2EEvPKjPjm
        /*0000*/              @!PT IADD3 R1, R1, 1, RZ ;
"""
    got = sweeps._sass_counts(text)
    assert got["_Z5probeILi0ELi1EEvPKjPjm"] == {"LDC": 1, "EXIT": 1, "IMAD.WIDE.U32": 2}
    assert got["_Z5probeILi0ELi2EEvPKjPjm"] == {"IADD3": 1}


def test_sweeps_need_the_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sweeps.main() == 1
    assert capsys.readouterr().out == ""


def test_config_reads_the_ntt_variables(monkeypatch):
    monkeypatch.setenv("MIDNIGHT_NTT_ORDERING", "nr")
    monkeypatch.setenv("MIDNIGHT_NTT_MAX_LOG_N", "40")
    reset_config_cache()
    try:
        assert config().ntt_ordering == "NR"
        assert config().ntt_max_log_n == 32          # clamped
        monkeypatch.setenv("MIDNIGHT_NTT_MAX_LOG_N", "x")
        reset_config_cache()
        assert config().ntt_max_log_n == 16
    finally:
        monkeypatch.delenv("MIDNIGHT_NTT_ORDERING")
        monkeypatch.delenv("MIDNIGHT_NTT_MAX_LOG_N")
        reset_config_cache()
    assert config().ntt_ordering == "NN" and config().ntt_max_log_n == 16


# ----------------------------------------------------------------------------
# NttContext and handles
# ----------------------------------------------------------------------------

def test_ntt_context_sync_async_and_ordering(monkeypatch):
    ctx = NttContext(6, device="cpu")
    assert ctx.max_log_n == 6
    x = _rand((2, 64), 80)
    _same(ctx.forward(_t(x)), j_ntt(x))
    assert torch.equal(ctx.inverse(ctx.forward(_t(x))), _t(x))
    assert torch.equal(ctx.coset_inverse(ctx.coset_forward(_t(x), 7), 7), _t(x))
    assert torch.equal(ctx.coset_forward(_t(x), 7), coset_ntt(_t(x), 7))
    h = ctx.forward_async(_t(x))
    assert isinstance(h, AsyncHandle) and h.is_ready()
    assert torch.equal(h.wait(), ctx.forward(_t(x)))
    assert torch.equal(ctx.inverse_async(h.wait()).wait(), _t(x))
    small = _t(x[:, 0, :16])                         # a smaller size than max
    assert torch.equal(ctx.forward(small), ntt(small))
    monkeypatch.setenv("MIDNIGHT_NTT_ORDERING", "NR")
    reset_config_cache()
    try:
        assert torch.equal(ctx.forward(_t(x)), ntt(_t(x), Ordering.NR))
        assert torch.equal(ctx.forward(_t(x), Ordering.NN), ntt(_t(x)))
    finally:
        monkeypatch.delenv("MIDNIGHT_NTT_ORDERING")
        reset_config_cache()
    d = get_domain(6, device="cpu")
    ctx.release(6)
    assert get_domain(6, device="cpu") is not d
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NttContext(4)


def test_handles_convert_once():
    calls = []
    h = AsyncHandle((torch.ones(3), {"a": torch.zeros(2)}),
                    convert=lambda v: calls.append(1) or v[0].sum().item())
    assert h.is_ready()
    assert h.wait() == 3.0 and h.wait() == 3.0 and calls == [1]
    assert ImmediateHandle(5).is_ready() and ImmediateHandle(5).wait() == 5
