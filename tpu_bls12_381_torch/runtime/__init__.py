"""Runtime layer of the port: the configuration, the timing helpers, async
handles and the NTT context.  Dispatch with host fallback, the MSM context
and the accelerator object are not ported yet."""

from .config import Config, config, reset_config_cache
from .handles import AsyncHandle, ImmediateHandle
from .ntt_context import NttContext

__all__ = ["Config", "config", "reset_config_cache", "AsyncHandle",
           "ImmediateHandle", "NttContext"]
