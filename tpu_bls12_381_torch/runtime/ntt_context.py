"""NTT context: domain lifecycle + forward/inverse/coset/batch + async.

Counterpart of the JAX package's ``runtime/ntt_context.py``: wraps the
twiddle-domain cache (``ntt/domain.py``) and exposes forward/inverse, batch
(leading axes), coset, orderings and async handles.  ``device=None`` means
the card; a call runs where its tensor lives.  ``forward`` and ``inverse``
open the JAX package's ``ntt`` spans; the coset calls open none, as there.
"""

from __future__ import annotations

import torch

# The ntt package re-exports the `ntt` *function*, which shadows the ntt
# submodule for any attribute-based import; bind the functions directly.
from ..device import resolve_device
from ..ntt.domain import get_domain, release_domain
from ..ntt.ntt import Ordering, coset_intt, coset_ntt, intt
from ..ntt.ntt import ntt as ntt_fn
from .config import config
from .handles import AsyncHandle
from .tracing import span


def _synchronize(out) -> None:
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()


class NttContext:
    """Domain-holding NTT orchestrator for sizes up to 2^max_log_n."""

    def __init__(self, max_log_n: int | None = None, device=None):
        self.max_log_n = config().ntt_max_log_n if max_log_n is None else max_log_n
        self.device = resolve_device(device)
        get_domain(self.max_log_n, self.device)  # build + cache the largest domain

    @staticmethod
    def _ordering(ordering):
        if ordering is not None:
            return ordering
        return Ordering(config().ntt_ordering)

    @staticmethod
    def _domain(x):
        return get_domain(x.shape[-1].bit_length() - 1, x.device)

    # --- sync ---------------------------------------------------------------

    def forward(self, x, ordering=None):
        """Forward NTT along the last axis; leading axes are batch.  Returns
        when the result is ready."""
        label = f"ntt.forward[n={x.shape[-1]}]"
        with span("ntt", label):
            out = ntt_fn(x, self._ordering(ordering), self._domain(x))
            _synchronize(out)
        return out

    def inverse(self, x, ordering=None):
        label = f"ntt.inverse[n={x.shape[-1]}]"
        with span("ntt", label):
            out = intt(x, self._ordering(ordering), self._domain(x))
            _synchronize(out)
        return out

    def coset_forward(self, x, shift: int, ordering=None):
        return coset_ntt(x, shift, self._ordering(ordering), self._domain(x))

    def coset_inverse(self, x, shift: int, ordering=None):
        return coset_intt(x, shift, self._ordering(ordering), self._domain(x))

    # --- async ----------------------------------------------------------------

    def forward_async(self, x, ordering=None) -> AsyncHandle:
        return AsyncHandle(ntt_fn(x, self._ordering(ordering), self._domain(x)))

    def inverse_async(self, x, ordering=None) -> AsyncHandle:
        return AsyncHandle(intt(x, self._ordering(ordering), self._domain(x)))

    # --- domain lifecycle -------------------------------------------------------

    def release(self, log_n: int | None = None) -> None:
        release_domain(log_n)
