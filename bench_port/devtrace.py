"""A profiled stretch of rounds reduced to numbers: the device's busy and idle
time, kernel launches, the device operations that took most time, and the
longest idle gaps by what the host was doing.

The stretch is ``torch.profiler`` with CPU and CUDA activities around a few
rounds; each round and each step is marked ``bench.round`` and
``bench.<op>`` (``rounds.py``).  The traced window runs from the start of
the first marked round to the end of the last; busy time is the union of
the device's intervals (kernels, copies, fills) inside it.
"""

from __future__ import annotations

import contextlib

TOP = 10
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@contextlib.contextmanager
def profiled():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof


def label(name: str):
    import torch

    return torch.profiler.record_function(name)


def short(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = name.split("(")[0]
    return (name[5:] if name.startswith("void ") else name)[:160]


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _doing(events, g0, g1, default):
    """The host event that overlaps the gap [g0, g1) most; of those that
    overlap it as much, the innermost (the latest to start)."""
    best = None
    for s, e, name in events:
        overlap = min(e, g1) - max(s, g0)
        if overlap > 0 and (best is None or (overlap, s) > best[:2]):
            best = (overlap, s, name)
    return best[2] if best else default


def reduce(prof, rounds: int) -> dict:
    """Busy and window seconds, launches, and the breakdown of the stretch."""
    from torch.autograd import DeviceType

    device, cpu = [], []
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type != DeviceType.CUDA:
            cpu.append(rng)
        elif not ev.name.startswith("bench."):    # not the marks' device-side copies
            device.append(rng)
    marks = [c for c in cpu if c[2] == "bench.round"]
    if not marks or not device:
        return {}
    w0, w1 = min(s for s, _, _ in marks), max(e for _, e, _ in marks)
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    merged = _merge([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in merged)
    by_name: dict[str, float] = {}
    for s, e, n in inside:
        by_name[short(n)] = by_name.get(short(n), 0.0) + (e - s)
    bench = [c for c in cpu if c[2].startswith("bench.") and c[2] != "bench.round"]
    others = [c for c in cpu if not c[2].startswith("bench.")]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "rounds": rounds,
        "launches": sum(1 for _, _, n in inside if not n.startswith(COPY_PREFIXES)),
        "device_ops": [[n, t / 1e6] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[f"{_doing(bench, g0, g1, 'between steps')} / "
                       f"{_doing(others, g0, g1, 'nothing traced')}", g / 1e6]
                      for g, g0, g1 in gaps[:TOP]],
    }
