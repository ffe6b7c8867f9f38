"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the plain reference, and the result line.

``run_cell`` is everything ``run.py`` does after it has found the card, so a
test can drive a whole run on the CPU at a small size, with the program
broken underneath, and see ``correct`` come out false.

The window is a closed loop with one caller: round after round, each awaited,
until ``seconds`` have passed; the round running then completes, and the
window's length is the time to its end.  Every rate is the window's work
over that length and every tail is over all of its calls.  Set-up is
everything from the process's start to the first timed round: imports, the
card's initialisation, the kernel libraries (built on a checkout's first
run, loaded after), the inputs, the bases' upload and expansion, the domain
tables, and one warm round of the cell's own shapes.

The check runs once the window has closed, the peak memory has been read and
the program's state is freed.  It compares, bit for bit, every commitment of
the window whose scalars are drawn inputs, and, in ``sample_rounds`` rounds
drawn from the seed, every result of the round (commitments of derived
vectors, kept transform outputs), with the reference recomputing the round
from the same inputs.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

import devtrace
import generator
from reference.system import ReferenceSystem
from rounds import EventTimer, Tally, no_timer, run_round

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_bls12_381")


def load_spec() -> dict:
    return generator.load_json(ROOT / "BENCHMARK.json")


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_config(spec: dict, cell: dict) -> dict:
    for cfg in spec["configs"]:
        if cfg["name"] == cell["config"]:
            return generator.load_json(ROOT / cfg["file"])
    raise SystemExit(f"no configuration named {cell['config']!r} in BENCHMARK.json")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``tpu_bls12_381_torch`` is not
    ``tpu_bls12_381``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    return [m for m in spec["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def _synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of k rounds of the window, drawn from the seed, each
    decided before its round runs."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.slots = k, np.random.default_rng(generator.seed_words(seed, 99)), []

    def take(self, index: int) -> int | None:
        if index < self.k:
            self.slots.append(None)
            return index
        j = int(self.rng.integers(0, index + 1))
        return j if j < self.k else None


def window(system, traffic, inputs, config, seconds, tally, timer, seed):
    """The measured rounds: (results, sampled results, seconds, error)."""
    res = Reservoir(traffic["sample_rounds"], seed)
    results, error = [], None
    t0 = time.perf_counter()
    deadline = t0 + seconds
    index = 0
    while True:
        slot = res.take(index)
        try:
            r = run_round(system, traffic, inputs, config, index, tally, timer,
                          keep=slot is not None)
        except Exception:                       # a round that raised ends the window
            error = traceback.format_exc()
            break
        results.append(r)
        if slot is not None:
            if res.slots[slot] is not None:
                res.slots[slot].kept = {}       # pushed out of the sample
            res.slots[slot] = r
        index += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - t0
    return results, {r.index for r in res.slots if r is not None}, window_s, error


def check(results, sampled, traffic, inputs, config, device):
    """Compare the window's results with the reference: (checks, compared)."""
    ref = ReferenceSystem(inputs, config, device, generator.ops_of(traffic))
    steps = traffic["round"]
    pool_points: dict = {}
    ref_rounds: dict = {}
    commit_bad = commit_n = elem_bad = elem_n = 0
    for r in results:
        key = tuple(r.index % p.shape[0] for p in inputs.pools.values())
        if r.index in sampled:
            if key not in ref_rounds:
                ref_rounds[key] = run_round(ref, traffic, inputs, config, r.index, Tally(),
                                            keep=True)
            want = ref_rounds[key]
            for i, got in r.kept.items():
                diff = (got.to(torch.int64) != want.kept[i].to(got.device, torch.int64))
                elem_bad += int(diff.reshape(diff.shape[0], -1).any(dim=0).sum())
                elem_n += got[0].numel()
        for i, got in r.points.items():
            name = steps[i]["in"]
            if r.index in sampled:
                expected = ref_rounds[key].points[i]
            elif name in inputs.pools:
                pk = (name, r.index % inputs.pools[name].shape[0])
                if pk not in pool_points:
                    pool_points[pk] = ref.to_host(ref.msm(inputs.pools[name][pk[1]]))
                expected = pool_points[pk]
            else:
                continue
            commit_bad += int((got != expected).any(dim=0).sum())
            commit_n += got.shape[1]
    checks = {}
    if any(s["op"] == "commit" for s in steps):
        checks["commit_mismatch"] = {"value": commit_bad, "limit": 0, "compared": commit_n}
    if any(s.get("keep") for s in steps):
        checks["quotient_mismatch"] = {"value": elem_bad, "limit": 0, "compared": elem_n}
    return checks


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, *,
             t_start: float, spec=None, config=None, traffic=None,
             system_cls=None) -> dict:
    """One run of the cell; returns the result line as a dict."""
    from port import PortSystem

    spec = spec or load_spec()
    cell = find_cell(spec, cell_name)
    config = config or load_config(spec, cell)
    traffic = traffic or generator.load_traffic(cell["traffic"])
    system_cls = system_cls or PortSystem
    ops = generator.ops_of(traffic)
    cuda = torch.device(device).type == "cuda"

    inputs = generator.make_inputs(traffic, config, seed, device)
    system = system_cls(inputs, config, device, ops)
    run_round(system, traffic, inputs, config, 0, Tally())           # the warm round
    _synchronize(device)
    setup_s = time.perf_counter() - t_start

    tally = Tally()
    timer = EventTimer(tally) if trace and cuda else no_timer
    stages = (system.stages() if trace and cuda and hasattr(system, "stages")
              else contextlib.nullcontext({}))
    with stages as stages_ms:
        results, sampled, window_s, error = window(system, traffic, inputs, config,
                                                   seconds, tally, timer, seed)
    rounds = len(results)
    profile = {}
    if trace and cuda and error is None:
        stretch = Tally()
        with devtrace.profiled() as prof:
            for i in range(traffic["profile_rounds"]):
                results.append(run_round(system, traffic, inputs, config, rounds + i, stretch,
                                         label=devtrace.label))
        profile = devtrace.reduce(prof, traffic["profile_rounds"])
    _synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    timed = {"msm": [], "transform": [], "vecops": []}
    for category, start, end, work in tally.events:
        timed[category].append((start.elapsed_time(end), work))
    tally.events.clear()

    system.free()
    del system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = check(results, sampled, traffic, inputs, config, device) if error is None else {}
    print(f"{cell_name}: setup {setup_s:.3f} s, {rounds} rounds in {window_s:.3f} s, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks["failed_rounds"] = {"value": int(error is not None), "limit": 0}
    if error:
        print(error, file=sys.stderr)
    correct = error is None and all(c["value"] <= c["limit"] for c in checks.values()) \
        and all(c.get("compared", 1) > 0 for c in checks.values())

    rec = {"setup_s": setup_s, "window_s": window_s, "rounds": rounds,
           "commit_calls": len(tally.commit_latency_s),
           "commit_latency_s": tally.commit_latency_s, "commit_points": tally.commit_points,
           "transform_elems": tally.transform_elems, "timed": timed,
           "stages_ms": stages_ms, "profile": profile}
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if cuda else torch.device(device).type,
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": len(results), "failed": int(error is not None),
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = profile.get("busy_s", 0.0)
        dev["window_s"] = profile.get("window_s", 0.0)
        if profile:
            out["breakdown"] = {"device_ops": profile["device_ops"],
                                "idle_gaps": profile["idle_gaps"]}
    out["checks"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in checks.items()}
    out["_compared"] = {k: v["compared"] for k, v in checks.items() if "compared" in v}
    return out


def emit(result: dict) -> None:
    """The compared numbers beside their limits on stderr, then the result
    as the last line of stdout (the check's numbers as its last key)."""
    compared = result.pop("_compared", {})
    for name, c in result["checks"].items():
        extra = f" (of {compared[name]} compared)" if name in compared else ""
        print(f"check {name} {c['value']} limit {c['limit']}{extra}", file=sys.stderr)
    print(json.dumps(result), flush=True)
