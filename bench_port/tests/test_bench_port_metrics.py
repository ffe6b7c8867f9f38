"""The metric readers' arithmetic: rates over the whole window, the tail over
every call, shares from the profiled stretch, nothing where nothing was read."""

import json
import math
from pathlib import Path

import pytest

import devtrace
import harness
import roofline

ROOT = Path(__file__).resolve().parents[2]


def rec(**kw):
    base = {"setup_s": 12.5, "window_s": 20.0, "rounds": 0, "commit_calls": 0,
            "commit_latency_s": [], "commit_points": 0, "transform_elems": 0,
            "timed": {"msm": [], "transform": [], "vecops": []}, "stages_ms": {}, "profile": {}}
    base.update(kw)
    return base


def read(name, r):
    return harness.load_reader(name)(r)


def test_every_metric_has_a_reader_and_reads_nothing_from_an_empty_window():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        value = read(m["name"], rec())
        assert value is None or m["name"] == "setup_s", m["name"]
    assert read("setup_s", rec()) == 12.5


def test_rates_are_over_the_whole_window():
    lat = [0.07] * 99 + [0.5]
    r = rec(rounds=100, commit_calls=100, commit_latency_s=lat, commit_points=100 << 20,
            transform_elems=3 << 20, window_s=10.0)
    assert read("commit_points_per_s", r) == (100 << 20) / 10.0
    assert read("quotient_elems_per_s", r) == (3 << 20) / 10.0
    assert read("prove_round_s", r) == 0.1


def test_p95_is_the_nearest_rank_over_every_call():
    lat = [i / 1000 for i in range(1, 201)]          # 1 .. 200 ms, shuffled
    lat = lat[::2] + lat[1::2]
    assert read("commit_p95_ms", rec(commit_calls=200, commit_latency_s=lat)) == pytest.approx(190.0)
    assert read("commit_p95_ms", rec(commit_calls=1, commit_latency_s=[0.25])) == 250.0


def test_per_layer_readers():
    n = 1 << 20
    timed = {"msm": [(70.0, n), (66.22, n)],
             "transform": [(2.0, (1 << 20, 4, False)), (10.0, (1 << 22, 4, True))],
             "vecops": [(2.0, None), (2.5, None)]}
    prof = {"busy_s": 0.75, "window_s": 1.0, "rounds": 3, "launches": 9000}
    r = rec(rounds=2, commit_calls=2, timed=timed, profile=prof,
            stages_ms={"scan": 30.0, "tail": 44.0})
    assert read("msm_scan_ms", r) == 15.0 and read("msm_tail_ms", r) == 22.0
    assert read("commit_launches", r) == 3000
    assert read("commit_roofline", r) == pytest.approx(
        100 * 2 * roofline.least_ms(*roofline.commit_work(n)) / 136.22)
    least = (roofline.least_ms(*roofline.transform_work(1 << 20, 4))
             + roofline.least_ms(*roofline.transform_work(1 << 22, 4, True)))
    assert read("ntt_roofline", r) == pytest.approx(100 * least / 12.0)
    assert read("quotient_vecops_ms", r) == 2.25
    assert read("round_msm_ms", r) == pytest.approx(68.11)
    assert read("round_ntt_ms", r) == 6.0
    for name in ("device_idle_share.commit", "device_idle_share.quotient", "device_idle_share.round"):
        assert read(name, r) == pytest.approx(25.0)


def test_metrics_of_a_cell_follow_their_workloads():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [m["name"] for m in harness.cell_metrics(spec, "plonk-k20.quotient", False)]
    assert names == ["quotient_elems_per_s", "setup_s"]
    for cell in spec["workloads"]:
        e2e = harness.cell_metrics(spec, cell["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        layer = harness.cell_metrics(spec, cell["name"], True)
        assert layer and all(m["moves"] in [e["name"] for e in e2e] for m in layer)


class _Ev:
    def __init__(self, name, start, end, cuda):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.time_range = type("T", (), {"start": start, "end": end})


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_devtrace_reduces_busy_idle_and_gaps():
    ev = [_Ev("bench.round", 0, 1000, False), _Ev("bench.round", 1000, 2000, False),
          _Ev("bench.round", 0, 2000, True),             # the mark's device-side copy
          _Ev("bench.commit", 0, 900, False), _Ev("cudaStreamSynchronize", 850, 1100, False),
          _Ev("kern_a", 100, 400, True), _Ev("kern_b", 300, 500, True),
          _Ev("Memcpy DtoH", 500, 600, True), _Ev("kern_a", 1200, 1900, True)]
    out = devtrace.reduce(_Prof(ev), rounds=2)
    assert out["window_s"] == pytest.approx(2000e-6)
    assert out["busy_s"] == pytest.approx(1200e-6)          # 100..600 and 1200..1900
    assert out["launches"] == 3
    assert out["device_ops"][0] == ["kern_a", pytest.approx(1000e-6)]
    assert out["idle_gaps"][0][1] == pytest.approx(600e-6)  # 600..1200
    assert out["idle_gaps"][0][0] == "bench.commit / cudaStreamSynchronize"
    assert devtrace.reduce(_Prof([]), 1) == {}
    assert math.isclose(sum(g for _, g in out["idle_gaps"]), 800e-6)
