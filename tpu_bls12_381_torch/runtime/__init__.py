"""Runtime layer of the port: the configuration, the timing helpers, async
handles, the NTT context and the MSM context.  Dispatch with host fallback and
the accelerator object are not ported yet."""

from .config import Config, config, reset_config_cache
from .handles import AsyncHandle, ImmediateHandle
from .msm_context import MsmContext, PrecomputedBases, g1_context, g2_context
from .ntt_context import NttContext

__all__ = ["Config", "config", "reset_config_cache", "AsyncHandle",
           "ImmediateHandle", "NttContext", "MsmContext", "PrecomputedBases",
           "g1_context", "g2_context"]
