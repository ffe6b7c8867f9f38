"""Timing spans, completion fence and timing helpers for the card.

Counterpart of the JAX package's ``runtime/tracing.py``.  ``span(tag, label)``
is its span: when MIDNIGHT_TRACE names ``tag`` (or ``all``) it logs the
region's wall milliseconds on the ``tpu_bls12_381_torch.trace`` logger and
marks the region in a ``torch.profiler`` trace
(``torch.profiler.record_function``, where JAX uses a
``jax.profiler.TraceAnnotation``).  A span is also a stage (below), so one
call marks a region for both.  PyTorch returns before the device finishes, so
a host clock alone measures the enqueue: ``fence`` is
``torch.cuda.synchronize`` and ``timed_reps`` times with CUDA events.
``stage`` marks the stages of a pipeline; it costs nothing unless a
``collect_stages`` block is open, and then it records two CUDA events per
stage (no synchronisation until the block closes).
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

from .config import config

logger = logging.getLogger("tpu_bls12_381_torch.trace")

_ACTIVE: list | None = None


@contextlib.contextmanager
def span(tag: str, label: str):
    """Time a region when tracing ``tag`` is enabled, and mark it as the
    stage ``label`` for an open ``collect_stages`` block."""
    with stage(label):
        if not config().traces(tag):
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(label):
            yield
        logger.info("%s: %.3f ms", label, (time.perf_counter() - t0) * 1e3)


def fence(out=None):
    """Wait for all work queued on the card and return ``out``."""
    torch.cuda.synchronize()
    return out


def timed_reps(reps: int, fn):
    """Best-of-``reps`` device seconds of ``fn()``, by CUDA events."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


@contextlib.contextmanager
def stage(label: str):
    """Mark a pipeline stage for an open ``collect_stages`` block."""
    if _ACTIVE is None:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    try:
        yield
    finally:
        end.record()
        _ACTIVE.append((label, start, end))


@contextlib.contextmanager
def collect_stages():
    """Collect the stages marked inside the block.

    Yields a dict that is filled when the block closes: label -> summed
    milliseconds on the card (CUDA events).
    """
    global _ACTIVE
    if not torch.cuda.is_available():
        raise RuntimeError("collect_stages times with CUDA events: no card")
    result: dict[str, float] = {}
    previous, _ACTIVE = _ACTIVE, []
    try:
        yield result
    finally:
        events, _ACTIVE = _ACTIVE, previous
        torch.cuda.synchronize()
        for label, start, end in events:
            result[label] = result.get(label, 0.0) + start.elapsed_time(end)
