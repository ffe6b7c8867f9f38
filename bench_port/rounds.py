"""One round of a traffic mix, driven through any system: the program
(``port.PortSystem``), the plain reference or its control
(``reference/system.py``).

Steps, each with ``in`` and ``out`` value names (a pool name of the mix
takes round i's set of that pool):

* ``commit``: a G1 MSM of each of the value's columns against the uploaded
  bases, the points converted to affine and copied to the host.  Its
  latency runs from the call until the points are on the host.
* ``intt``, ``coset_ntt``, ``coset_intt``: transforms along the last axis,
  the columns a batch; the coset is the configuration's ``coset_shift``.
* ``gate``: h = (a b + c d) / Z_H from the value's four columns.
* ``pad``: zero-padding to 2^``log_n`` (a configuration key), as a prover
  extends its coefficients; ``split``: a vector cut into ``pieces`` columns.

A step with ``"keep": true`` is a result that the check compares in the
sampled rounds; a commit's points are always results.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch

TRANSFORM_OPS = ("intt", "coset_ntt", "coset_intt")


@dataclass
class RoundResult:
    index: int
    points: dict = field(default_factory=dict)   # step -> (49, B) host int32
    kept: dict = field(default_factory=dict)     # step -> kept tensor
    error: str | None = None


@dataclass
class Tally:
    """What the window did, for the metric readers."""
    commit_latency_s: list = field(default_factory=list)
    commit_points: int = 0
    transform_elems: int = 0
    # Traced runs: (category, start event, end event, work) per call.
    events: list = field(default_factory=list)


class EventTimer:
    """CUDA events around each call, read once the window has closed."""

    def __init__(self, tally: Tally):
        self.tally = tally

    @contextlib.contextmanager
    def __call__(self, category: str, work=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self.tally.events.append((category, start, end, work))


@contextlib.contextmanager
def no_timer(category: str, work=None):
    yield


@contextlib.contextmanager
def no_label(name: str):
    yield


def pool_values(inputs, index: int) -> dict:
    return {name: pool[index % pool.shape[0]] for name, pool in inputs.pools.items()}


def run_round(system, traffic: dict, inputs, config: dict, index: int, tally: Tally,
              timer=no_timer, label=no_label, keep: bool = False) -> RoundResult:
    """Run round ``index`` through ``system``; ``keep`` clones its kept
    results for the check."""
    env = pool_values(inputs, index)
    out = RoundResult(index)
    with label("bench.round"):
        for i, step in enumerate(traffic["round"]):
            op, x = step["op"], env[step["in"]]
            with label(f"bench.{op}"):
                if op == "commit":
                    t0 = time.perf_counter()
                    with timer("msm", x.shape[1] * x.shape[2]):
                        P = system.msm(x)
                    out.points[i] = system.to_host(P)
                    tally.commit_latency_s.append(time.perf_counter() - t0)
                    tally.commit_points += x.shape[1] * x.shape[2]
                    continue
                if op in TRANSFORM_OPS:
                    with timer("transform", (x.shape[-1], x.shape[1], op != "intt")):
                        y = getattr(system, op)(x)
                    tally.transform_elems += x.shape[-1] * x.shape[1]
                elif op == "gate":
                    with timer("vecops"):
                        y = system.gate(x)
                elif op == "pad":
                    y = torch.zeros(x.shape[:-1] + (1 << config[step["log_n"]],),
                                    dtype=x.dtype, device=x.device)
                    y[..., :x.shape[-1]] = x
                elif op == "split":
                    y = x.reshape(x.shape[0], step["pieces"], -1)
                else:
                    raise ValueError(f"unknown step {op!r}")
            env[step["out"]] = y
            if keep and step.get("keep"):
                out.kept[i] = y.clone()
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    return out
