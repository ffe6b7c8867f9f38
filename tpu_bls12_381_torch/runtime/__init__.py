"""Runtime layer of the port: so far the configuration the MSM reads and the
timing helpers.  Dispatch, contexts and async handles are not ported yet."""

from .config import Config, config, reset_config_cache

__all__ = ["Config", "config", "reset_config_cache"]
