"""Async handles: a CUDA stream runs behind the host by construction.

Counterpart of the JAX package's ``runtime/handles.py``.  Every kernel launch
and torch op on a CUDA tensor returns as soon as it is queued; a handle wraps
the result plus an optional conversion step and a ``torch.cuda.Event``
recorded on the current stream when the handle is made.  ``is_ready`` asks
the event, ``wait`` waits for it and converts.  A result on the CPU is always
ready.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def _leaves(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _leaves(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)


class AsyncHandle:
    """Wait-able result of work queued on the card."""

    def __init__(self, value: Any, convert: Callable[[Any], Any] | None = None):
        self._value = value
        self._convert = convert
        self._done = False
        self._event = None
        device = next((t.device for t in _leaves(value) if t.is_cuda), None)
        if device is not None:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def is_ready(self) -> bool:
        """True if the device work queued before the handle was made is done."""
        return self._event is None or self._event.query()

    def wait(self) -> Any:
        """Block until the result is ready; return the (converted) value."""
        if not self._done:
            if self._event is not None:
                self._event.synchronize()
            if self._convert is not None:
                self._value = self._convert(self._value)
            self._done = True
        return self._value


class ImmediateHandle(AsyncHandle):
    """Always-ready handle (results computed on the host)."""

    def __init__(self, value: Any):
        self._value = value
        self._convert = None
        self._done = True
        self._event = None
