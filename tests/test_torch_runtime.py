"""The consumer entry layer of the PyTorch/CUDA port against the JAX package,
on the CPU: the wire codecs (``runtime/types.py``), the configuration's
routing decisions, ``dispatch_*``, the ``Accelerator`` facade, ``span`` and
the live-memory census.

Wire bytes are compared byte for byte and limbs as ints (tolerance 0).  The
JAX package's accelerated ``dispatch_msm`` is not called (its MSM compile
takes minutes on XLA:CPU); its CPU route and its ``Config`` decisions are,
for the same environment.  The port's accelerated branch runs here on CPU
tensors (``device="cpu"``) against the oracle.
"""

import functools
import importlib
import logging
import random
import threading

import numpy as np
import pytest
import torch

from tpu_bls12_381.runtime import dispatch as jdispatch
from tpu_bls12_381.runtime import types as jtypes
from tpu_bls12_381.fields import FQ as JFQ, FR as JFR

from tpu_bls12_381_torch import constants, native, oracle
from tpu_bls12_381_torch.fields import FQ, FR
from tpu_bls12_381_torch.fields.limbs import ints_to_limbs, limbs_to_ints
from tpu_bls12_381_torch.runtime import (Accelerator, Config, DeviceType, NttContext,
                                         accelerator as accel_mod, config, dispatch,
                                         live_arrays_report, memory, reset_config_cache,
                                         total_live_bytes, tracing)
from tpu_bls12_381_torch.runtime import types
from tpu_bls12_381_torch.runtime.dispatch import Route

# the module (the package re-exports its ``config`` function under that name)
jconfig_mod = importlib.import_module("tpu_bls12_381.runtime.config")

# One intra-op thread: the port's CPU path is thousands of tiny tensor ops
# (see tests/test_torch_g2.py).
torch.set_num_threads(1)

R_MOD = constants.FR_MODULUS
P_MOD = constants.FQ_MODULUS
MIDNIGHT = ("MIDNIGHT_DEVICE", "MIDNIGHT_TPU_MIN_K", "MIDNIGHT_GPU_MIN_K",
            "MIDNIGHT_NTT_MIN_K", "MIDNIGHT_VECOPS_MIN_SIZE", "MIDNIGHT_TPU_PRECOMPUTE",
            "MIDNIGHT_GPU_PRECOMPUTE", "MIDNIGHT_MSM_WINDOW", "MIDNIGHT_SHARDING",
            "MIDNIGHT_TRACE", "MIDNIGHT_NTT_FAST_TWIDDLES")


@pytest.fixture
def env(monkeypatch):
    """Set MIDNIGHT_* variables for both packages (others cleared), with the
    config caches reset before and after."""
    for name in MIDNIGHT:
        monkeypatch.delenv(name, raising=False)

    def set_(**kw):
        for k, v in kw.items():
            monkeypatch.setenv(k, v)
        reset_config_cache()
        jconfig_mod.reset_config_cache()

    set_()
    yield set_
    reset_config_cache()
    jconfig_mod.reset_config_cache()


def _g1_points(rng, n):
    G = oracle.g1_generator()
    return [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 30), G,
                                                   oracle.FQ_OPS), oracle.FQ_OPS)
            for _ in range(n)]


def _g2_points(rng, n):
    G = oracle.g2_generator()
    return [oracle.jac_to_affine(oracle.scalar_mul(rng.randrange(1, 1 << 20), G,
                                                   oracle.FQ2_OPS), oracle.FQ2_OPS)
            for _ in range(n)]


# -----------------------------------------------------------------------------
# Wire codecs
# -----------------------------------------------------------------------------

def _wire(kind, rng):
    """(bytes as the JAX package writes them, the ints they hold)."""
    if kind == "fr":
        vals = [0, 1, R_MOD - 1] + [rng.randrange(R_MOD) for _ in range(9)]
        return jtypes.scalars_to_bytes(ints_to_limbs(vals, 16)), vals
    if kind == "fq":
        vals = [0, 1, P_MOD - 1] + [rng.randrange(P_MOD) for _ in range(9)]
        return jtypes.fq_to_bytes(ints_to_limbs(vals, 24)), vals
    if kind == "g1":
        pts = _g1_points(rng, 5) + [None] + _g1_points(rng, 2)
        x = ints_to_limbs([p[0] if p else 7 for p in pts], 24)
        y = ints_to_limbs([p[1] if p else 9 for p in pts], 24)
        inf = np.array([p is None for p in pts])
        return jtypes.g1_affine_to_bytes(x, y, inf), pts
    pts = _g2_points(rng, 3) + [None] + _g2_points(rng, 1)
    c = lambda i, j: ints_to_limbs([p[i][j] if p else 5 for p in pts], 24)
    inf = np.array([p is None for p in pts])
    return jtypes.g2_affine_to_bytes((c(0, 0), c(0, 1)), (c(1, 0), c(1, 1)), inf), pts


@pytest.mark.parametrize("kind", ["fr", "fq", "g1", "g2"])
def test_codecs_read_the_jax_bytes_and_write_them_back(kind):
    data, want = _wire(kind, random.Random(21))
    if kind in ("fr", "fq"):
        fn = types.scalars_from_bytes if kind == "fr" else types.fq_from_bytes
        t = fn(data, device="cpu")
        assert t.dtype == torch.int32 and limbs_to_ints(t.numpy()) == want
        to = types.scalars_to_bytes if kind == "fr" else types.fq_to_bytes
        assert to(t) == data
        jfn = jtypes.scalars_from_bytes if kind == "fr" else jtypes.fq_from_bytes
        np.testing.assert_array_equal(t.numpy(), jfn(data).astype(np.int32))
        return
    if kind == "g1":
        x, y, inf = types.g1_affine_from_bytes(data, device="cpu")
        got = [None if i else (a, b) for a, b, i in
               zip(limbs_to_ints(x.numpy()), limbs_to_ints(y.numpy()), inf.tolist())]
        assert got == want
        assert types.g1_affine_to_bytes(x, y, inf) == data
        jx, jy, jinf = jtypes.g1_affine_from_bytes(data)
        np.testing.assert_array_equal(x.numpy(), jx.astype(np.int32))
        np.testing.assert_array_equal(inf.numpy(), jinf)
        return
    x, y, inf = types.g2_affine_from_bytes(data, device="cpu")
    assert x.shape == (24, 2, len(want)) and inf.tolist() == [p is None for p in want]
    ints = lambda t, j: limbs_to_ints(t[:, j].numpy())
    got = [None if i else ((a, b), (c, d)) for a, b, c, d, i in
           zip(ints(x, 0), ints(x, 1), ints(y, 0), ints(y, 1), inf.tolist())]
    assert got == want
    assert types.g2_affine_to_bytes(x, y, inf) == data
    (jx0, jx1), _, _ = jtypes.g2_affine_from_bytes(data)
    np.testing.assert_array_equal(x[:, 1].numpy(), jx1.astype(np.int32))


def test_identity_lanes_are_written_as_zeros_whatever_they_hold():
    """The all-zero identity convention: an ``inf`` lane's x and y are not
    written; the port and the JAX package write the same bytes."""
    rng = random.Random(22)
    pts = _g1_points(rng, 4)
    x = ints_to_limbs([p[0] for p in pts], 24)
    y = ints_to_limbs([p[1] for p in pts], 24)
    inf = np.array([False, True, False, True])
    data = types.g1_affine_to_bytes(torch.from_numpy(x.astype(np.int32)),
                                    torch.from_numpy(y.astype(np.int32)),
                                    torch.from_numpy(inf))
    assert data == jtypes.g1_affine_to_bytes(x, y, inf)
    assert data[96:192] == bytes(96) and data[:96] != bytes(96)
    assert types.g1_affine_from_bytes(data, device="cpu")[2].tolist() == inf.tolist()


def test_u64_words_and_limbs_match_jax():
    rng = np.random.default_rng(23)
    words = rng.integers(0, np.iinfo(np.uint64).max, size=(7, 6), dtype=np.uint64,
                         endpoint=True)
    limbs = types.u64_words_to_limbs(words)
    assert limbs.dtype == np.int32 and limbs.shape == (24, 7)
    np.testing.assert_array_equal(limbs, jtypes.u64_words_to_limbs(words).astype(np.int32))
    np.testing.assert_array_equal(types.limbs_to_u64_words(limbs), words)
    np.testing.assert_array_equal(types.limbs_to_u64_words(torch.from_numpy(limbs)), words)


def test_codec_makers_follow_the_device_rule():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        types.scalars_from_bytes(bytes(32))


@pytest.mark.parametrize("name,native_lib", [("fr", True), ("fq", True), ("fq", False)])
def test_mont_encode_decode_host_match_jax(monkeypatch, name, native_lib):
    spec, jspec = (FR, JFR) if name == "fr" else (FQ, JFQ)
    if not native_lib:
        monkeypatch.setattr(native, "available", lambda: False)
    rng = random.Random(24)
    vals = [0, 1, spec.modulus - 1] + [rng.randrange(spec.modulus) for _ in range(5)]
    limbs = ints_to_limbs(vals, spec.num_limbs)
    enc = types.mont_encode_host(spec, limbs)
    assert enc.dtype == np.int32
    assert limbs_to_ints(enc) == limbs_to_ints(jtypes.mont_encode_host(jspec, limbs))
    assert limbs_to_ints(enc) == [spec.to_mont(v) for v in vals]
    assert limbs_to_ints(types.mont_decode_host(spec, enc)) == vals


# -----------------------------------------------------------------------------
# Config: the same decisions as the JAX package's for the same environment
# -----------------------------------------------------------------------------

SIZES = [1, 255, 256, 4095, 4096, 1 << 10, (1 << 12) - 1, 1 << 12, (1 << 15) - 1,
         1 << 15, 1 << 20]


@pytest.mark.parametrize("environ", [
    {},
    {"MIDNIGHT_TPU_MIN_K": "10", "MIDNIGHT_NTT_MIN_K": "8"},
    {"MIDNIGHT_TPU_MIN_K": "7", "MIDNIGHT_TPU_PRECOMPUTE": "99"},
    {"MIDNIGHT_GPU_PRECOMPUTE": "0", "MIDNIGHT_VECOPS_MIN_SIZE": "256"},
    {"MIDNIGHT_DEVICE": "cpu"},
    {"MIDNIGHT_DEVICE": "tpu"},
    {"MIDNIGHT_DEVICE": "quantum", "MIDNIGHT_TPU_MIN_K": "not_a_number"},
    {"MIDNIGHT_TPU_MIN_K": "99", "MIDNIGHT_NTT_MIN_K": "-3", "MIDNIGHT_TRACE": "msm, ntt"},
])
def test_config_decisions_match_jax(env, environ):
    env(**environ)
    mine, theirs = config(), jconfig_mod.config()
    for name in ("msm_min_k", "ntt_min_k", "vecops_min_size", "precompute_factor",
                 "msm_window", "trace"):
        assert getattr(mine, name) == getattr(theirs, name), name
    for fn in ("use_accel_msm", "use_accel_ntt", "use_accel_vecops"):
        assert ([getattr(mine, fn)(n) for n in SIZES]
                == [getattr(theirs, fn)(n) for n in SIZES]), fn
    assert [mine.traces(t) for t in ("msm", "ntt", "vecops")] == \
        [theirs.traces(t) for t in ("msm", "ntt", "vecops")]
    # the device policy: the JAX package's tpu is the port's gpu
    assert mine.device.value == {"tpu": "gpu"}.get(theirs.device.value,
                                                   theirs.device.value)


def test_config_reads_gpu_and_the_fast_twiddles_no_op(env):
    """``gpu`` in any case; MIDNIGHT_NTT_FAST_TWIDDLES, a no-op in the JAX
    package too, changes nothing (the port does not read it)."""
    env(MIDNIGHT_DEVICE="GPU", MIDNIGHT_TRACE="all")
    c = config()
    assert c.device is DeviceType.GPU and c.use_accel_msm(1) and c.traces("vecops")
    assert Config.from_env() == c
    env(MIDNIGHT_NTT_FAST_TWIDDLES="1")
    assert config() == c


# -----------------------------------------------------------------------------
# Dispatch
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("curve", ["g1", "g2"])
def test_dispatch_msm_cpu_route_matches_jax(env, curve):
    env(MIDNIGHT_DEVICE="cpu")
    rng = random.Random(25)
    pts = (_g1_points if curve == "g1" else _g2_points)(rng, 6) + [None]
    scalars = [rng.randrange(R_MOD) for _ in range(len(pts))]
    res = dispatch.dispatch_msm(scalars, pts, curve)
    want = jdispatch.dispatch_msm(scalars, pts, curve)
    assert res.route is Route.CPU and want.route.value == "cpu"
    assert res.value == want.value
    ops_ = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    assert res.value == oracle.jac_to_affine(oracle.msm(scalars, pts, ops_), ops_)


def test_dispatch_msm_accel_route_on_cpu_tensors_matches_the_oracle(env):
    env(MIDNIGHT_DEVICE="gpu")
    rng = random.Random(26)
    pts = _g1_points(rng, 15) + [None]
    scalars = [rng.randrange(R_MOD) for _ in range(16)]
    res = dispatch.dispatch_msm(scalars, pts, device="cpu")
    assert res.route is Route.ACCEL and res.error is None
    assert res.value == oracle.jac_to_affine(oracle.msm(scalars, pts, oracle.FQ_OPS),
                                             oracle.FQ_OPS)


def test_dispatch_keeps_the_error_when_the_accelerator_fails(env, monkeypatch):
    """An accelerator that cannot be reached (the failure planted where the
    device is resolved, before any tensor goes there) degrades the call to
    the host, the error kept; the device work is never started."""
    env(MIDNIGHT_DEVICE="gpu")
    rng = random.Random(27)
    pts = _g1_points(rng, 4)
    scalars = [rng.randrange(R_MOD) for _ in range(4)]
    boom = RuntimeError("injected accelerator failure")

    def fail(*a, **k):
        raise boom

    def never(*a, **k):
        raise AssertionError("the device work ran")

    monkeypatch.setattr(dispatch, "resolve_device", fail)
    for name in ("_accel_msm", "_accel_ntt", "_accel_vecop"):
        monkeypatch.setattr(dispatch, name, never)
    res = dispatch.dispatch_msm(scalars, pts, device="cpu")
    assert res.route is Route.ACCEL_FAILED and res.error is boom
    assert res.value == oracle.jac_to_affine(oracle.msm(scalars, pts, oracle.FQ_OPS),
                                             oracle.FQ_OPS)
    vals = [rng.randrange(R_MOD) for _ in range(8)]
    res = dispatch.dispatch_ntt(vals, device="cpu")
    assert res.route is Route.ACCEL_FAILED and res.error is boom
    assert res.value == oracle.ntt(vals)
    res = dispatch.dispatch_vecop("add", vals, vals, device="cpu")
    assert res.route is Route.ACCEL_FAILED and res.error is boom
    assert res.value == [2 * v % R_MOD for v in vals]


class _FailingContext:
    def __init__(self, result=None):
        self.result = result

    def msm(self, sc, A):
        if self.result is None:
            raise RuntimeError("injected kernel failure")
        return self.result


@pytest.mark.parametrize("what", ["msm", "msm_off_curve", "ntt", "vecop"])
def test_dispatch_raises_when_the_device_work_fails(env, monkeypatch, what):
    """Once the inputs are on the device a failure raises to the caller: a
    failing kernel wrapper, or an off-curve MSM result, is never covered by
    the host."""
    env(MIDNIGHT_DEVICE="gpu")
    rng = random.Random(30)

    def no_host(*a, **k):
        raise AssertionError("the host stood in for the device")

    monkeypatch.setattr(dispatch, "_host_msm", no_host)
    monkeypatch.setattr(dispatch, "_VECOPS", {k: no_host for k in dispatch._VECOPS})
    monkeypatch.setattr(oracle, "ntt", no_host)

    def failing_kernel(*a, **k):
        raise RuntimeError("injected kernel failure")

    if what.startswith("msm"):
        pts = _g1_points(rng, 4)
        scalars = [rng.randrange(R_MOD) for _ in range(4)]
        # (1 : 1 : 1) is not on y^2 = x^3 + 4
        one = torch.from_numpy(ints_to_limbs([FQ.to_mont(1)], 24)[:, 0].astype(np.int32))
        ctx = _FailingContext(None if what == "msm" else (one, one, one))
        monkeypatch.setattr(dispatch, "_G1_CTX", ctx)
        match = "injected kernel failure" if what == "msm" else "off-curve"
        with pytest.raises(RuntimeError, match=match):
            dispatch.dispatch_msm(scalars, pts, device="cpu")
        return
    vals = [rng.randrange(R_MOD) for _ in range(8)]
    if what == "ntt":
        from tpu_bls12_381_torch import ntt as ntt_pkg

        monkeypatch.setattr(ntt_pkg, "ntt", failing_kernel)
        with pytest.raises(RuntimeError, match="injected kernel failure"):
            dispatch.dispatch_ntt(vals, device="cpu")
        return
    from tpu_bls12_381_torch import vecops

    monkeypatch.setattr(vecops, "vector_mul", failing_kernel)
    with pytest.raises(RuntimeError, match="injected kernel failure"):
        dispatch.dispatch_vecop("mul", vals, vals, device="cpu")


def test_dispatch_without_a_card_degrades_to_the_host(env):
    """``device=None`` is the card; without one the accelerated branch raises
    and the call comes back from the host with that error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env(MIDNIGHT_DEVICE="gpu")
    a = list(range(1, 9))
    res = dispatch.dispatch_vecop("mul", a, a)
    assert res.route is Route.ACCEL_FAILED and "no CUDA device" in str(res.error)
    assert res.value == [x * x for x in a]


def test_dispatch_ntt_both_routes_match_jax_and_the_oracle(env):
    rng = random.Random(28)
    vals = [rng.randrange(R_MOD) for _ in range(256)]
    env(MIDNIGHT_DEVICE="cpu")
    cpu = dispatch.dispatch_ntt(vals)
    assert cpu.route is Route.CPU and cpu.value == jdispatch.dispatch_ntt(vals).value
    env(MIDNIGHT_DEVICE="gpu")
    acc = dispatch.dispatch_ntt(vals, device="cpu")
    assert acc.route is Route.ACCEL and acc.value == cpu.value == oracle.ntt(vals)
    inv = dispatch.dispatch_ntt(acc.value, inverse=True, device="cpu")
    assert inv.route is Route.ACCEL and inv.value == vals


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_dispatch_vecop_routes_and_values(env, field):
    rng = random.Random(29)
    p = R_MOD if field == "fr" else P_MOD
    a = [rng.randrange(p) for _ in range(32)]
    b = [rng.randrange(p) for _ in range(32)]
    res = dispatch.dispatch_vecop("mul", a, b, field)
    assert res.route is Route.CPU                      # below the 4096 threshold
    assert res.value == jdispatch.dispatch_vecop("mul", a, b, field).value
    env(MIDNIGHT_DEVICE="gpu")
    for op, f in (("add", lambda x, y: (x + y) % p), ("sub", lambda x, y: (x - y) % p),
                  ("mul", lambda x, y: x * y % p)):
        acc = dispatch.dispatch_vecop(op, a, b, field, device="cpu")
        assert acc.route is Route.ACCEL and acc.value == [f(x, y) for x, y in zip(a, b)]
    with pytest.raises(ValueError):
        dispatch.dispatch_vecop("div", a, b)


# -----------------------------------------------------------------------------
# Accelerator, span, memory
# -----------------------------------------------------------------------------

def test_accelerator_on_the_cpu_warms_up_and_reports(env):
    acc = Accelerator(max_ntt_log_n=6, device="cpu")
    assert acc.device == torch.device("cpu") and acc.ntt.max_log_n == 6
    assert acc.g1.name == "g1" and acc.g2.name == "g2"
    acc.warmup(n=16, ntt_log_n=6)
    info = acc.backend_info()
    assert "tpu_bls12_381_torch" in info and "platform: cpu" in info
    assert "device policy: auto (msm>=2^15, ntt>=2^12)" in info
    assert acc.is_available() == torch.cuda.is_available()


def test_global_accelerator_is_one_instance(env, monkeypatch):
    monkeypatch.setattr(accel_mod, "_GLOBAL", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            accel_mod.global_accelerator()
    monkeypatch.setattr(accel_mod, "Accelerator",
                        functools.partial(Accelerator, max_ntt_log_n=4, device="cpu"))
    got = []
    threads = [threading.Thread(target=lambda: got.append(accel_mod.global_accelerator()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(got) == 4 and all(g is got[0] for g in got)
    assert accel_mod.backend_info() == got[0].backend_info()


def test_span_logs_only_for_enabled_tags(env, caplog):
    caplog.set_level(logging.INFO, logger="tpu_bls12_381_torch.trace")
    with tracing.span("msm", "quiet"):
        pass
    assert "quiet" not in caplog.text
    env(MIDNIGHT_TRACE="ntt")
    with tracing.span("msm", "still quiet"):
        pass
    with tracing.span("ntt", "loud"):
        pass
    assert "still quiet" not in caplog.text and "loud:" in caplog.text
    # the contexts open the JAX package's spans, with its labels
    ctx = NttContext(4, device="cpu")
    x = torch.from_numpy(ints_to_limbs([FR.to_mont(v) for v in range(16)], 16)
                         .astype(np.int32))
    ctx.inverse(ctx.forward(x))
    assert "ntt.forward[n=16]" in caplog.text and "ntt.inverse[n=16]" in caplog.text
    ctx.coset_forward(x, 3)
    assert "coset" not in caplog.text


def test_span_marks_a_stage_for_collect_stages(env, monkeypatch):
    """One call marks a region for both mechanisms: a span is also a stage of
    an open ``collect_stages`` block, whatever MIDNIGHT_TRACE says."""

    class Event:                      # collect_stages times with CUDA events
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

    monkeypatch.setattr(torch.cuda, "Event", Event)
    marked = []
    monkeypatch.setattr(tracing, "_ACTIVE", marked)
    with tracing.span("msm", "outer"):
        with tracing.stage("inner"):
            pass
    ctx = NttContext(4, device="cpu")
    x = torch.from_numpy(ints_to_limbs([FR.to_mont(v) for v in range(16)], 16)
                         .astype(np.int32))
    ctx.forward(x)
    assert [label for label, _, _ in marked] == ["inner", "outer", "ntt.forward[n=16]"]


def test_memory_census_counts_storages_once(env):
    keep = torch.zeros((16, 100), dtype=torch.int32)
    view = keep[:, 10:20]
    census = memory._live_tensors("cpu")
    mine = [nb for t, nb in census if t.untyped_storage().data_ptr()
            == keep.untyped_storage().data_ptr()]
    assert mine == [keep.numel() * 4] and view.numel() == 160
    rep = live_arrays_report()
    assert rep.startswith("live arrays:")
    if not torch.cuda.is_available():
        assert total_live_bytes() == 0 and rep == "live arrays: 0"
