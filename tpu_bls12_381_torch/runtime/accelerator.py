"""Consumer-facing accelerator facade and its process-wide singleton.

Counterpart of the JAX package's ``runtime/accelerator.py``: one object that
bundles the MSM contexts (``g1``, ``g2``) and an NTT context (``ntt``), with
``warmup`` and ``backend_info``, and ``global_accelerator()`` returning one
instance per process (made under a lock).

The device rule of the port holds: ``Accelerator(device=None)`` works on the
CUDA card and raises without one; ``Accelerator(device="cpu")`` runs the
plain versions on the CPU (what the tests do).  ``global_accelerator()`` is
``Accelerator()``: the card.
"""

from __future__ import annotations

import platform
import threading

import torch

from ..device import resolve_device
from .config import config
from .msm_context import MsmContext, g1_context, g2_context
from .ntt_context import NttContext


class AcceleratorError(RuntimeError):
    """Accelerator-layer failure."""


class Accelerator:
    """Bundle of MSM (G1/G2) and NTT backends on one device."""

    def __init__(self, max_ntt_log_n: int | None = None, device=None):
        if max_ntt_log_n is None:
            max_ntt_log_n = config().ntt_max_log_n
        self.device = resolve_device(device)
        self.g1: MsmContext = g1_context()
        self.g2: MsmContext = g2_context()
        self.ntt: NttContext = NttContext(max_ntt_log_n, self.device)

    # -- lifecycle ----------------------------------------------------------

    def warmup(self, *, g2: bool = False, n: int = 256,
               factor: int = 1, ntt_log_n: int | None = None) -> None:
        """Run the hot paths once at the production sizes, so that the first
        real calls do not pay the build of the kernels, the first
        allocations and the tables: pass the production MSM size ``n`` (and
        precompute ``factor``) and NTT ``ntt_log_n``, e.g.
        ``warmup(n=1 << 20, factor=4, ntt_log_n=22)``."""
        self.g1.warmup(n, factor=factor, device=self.device)
        if g2:
            self.g2.warmup(max(n // 4, 16), factor=factor, device=self.device)
        if ntt_log_n is not None:
            from ..fields import FR, ops

            x = ops.zeros(FR, (1 << ntt_log_n,), self.device)
            self.ntt.inverse(self.ntt.forward(x))

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def backend_info(self) -> str:
        from ..parallel.mesh import default_mesh

        cfg = config()
        mesh = default_mesh(device=self.device)
        if self.device.type == "cuda":
            platform_line = (f"  platform: cuda x{torch.cuda.device_count()}"
                             f" ({torch.cuda.get_device_name(self.device)})")
        else:
            platform_line = (f"  platform: {self.device.type} x1"
                             f" ({platform.processor() or platform.machine()})")
        lines = [
            "tpu_bls12_381_torch accelerator",
            platform_line,
            f"  device policy: {cfg.device.value}"
            f" (msm>=2^{cfg.msm_min_k}, ntt>=2^{cfg.ntt_min_k})",
            f"  precompute factor: {cfg.precompute_factor}",
            f"  mesh: rank {mesh.rank} of {mesh.size}",
        ]
        return "\n".join(lines)


_GLOBAL: Accelerator | None = None
_LOCK = threading.Lock()


def global_accelerator() -> Accelerator:
    """Process-wide singleton on the CUDA card."""
    global _GLOBAL
    with _LOCK:
        if _GLOBAL is None:
            _GLOBAL = Accelerator()
        return _GLOBAL


def warmup(**kw) -> None:
    global_accelerator().warmup(**kw)


def backend_info() -> str:
    return global_accelerator().backend_info()
