"""Runtime layer of the port: configuration, dispatch with host fallback, the
MSM and NTT contexts, async handles, the accelerator facade with its global
singleton, the live-memory report, the wire codecs (``runtime.types``) and
the timing helpers (``runtime.tracing``).

Counterpart of the JAX package's ``runtime/``; it exports the same names,
and the port's ``ImmediateHandle``, ``g1_context`` and ``g2_context``.
"""

from .config import Config, DeviceType, config, reset_config_cache
from .handles import AsyncHandle, ImmediateHandle
from .msm_context import MsmContext, PrecomputedBases, g1_context, g2_context
from .ntt_context import NttContext
from .accelerator import (
    Accelerator,
    AcceleratorError,
    backend_info,
    global_accelerator,
    warmup,
)
from .dispatch import DispatchResult, dispatch_msm, dispatch_ntt, dispatch_vecop
from .memory import live_arrays_report, total_live_bytes

__all__ = [
    "Config",
    "DeviceType",
    "config",
    "reset_config_cache",
    "AsyncHandle",
    "ImmediateHandle",
    "MsmContext",
    "PrecomputedBases",
    "g1_context",
    "g2_context",
    "NttContext",
    "Accelerator",
    "AcceleratorError",
    "global_accelerator",
    "backend_info",
    "warmup",
    "DispatchResult",
    "dispatch_msm",
    "dispatch_ntt",
    "dispatch_vecop",
    "live_arrays_report",
    "total_live_bytes",
]
