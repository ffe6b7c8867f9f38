"""Env-var-driven configuration, read once and cached.

Counterpart of the JAX package's ``runtime/config.py``, with only what the
ported slice reads:

  MIDNIGHT_MSM_GLV   auto | on | off   G1 MSM via the GLV split.  ``auto``
                     (default): on while the doubled point set still fits the
                     device memory budget in one shot.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

logger = logging.getLogger("tpu_bls12_381_torch")


@dataclass(frozen=True)
class Config:
    msm_glv: str

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            msm_glv={"1": "on", "true": "on", "on": "on", "yes": "on",
                     "0": "off", "false": "off", "off": "off", "no": "off",
                     }.get(os.environ.get("MIDNIGHT_MSM_GLV", "auto")
                           .lower(), "auto"),
        )


_CONFIG: Config | None = None


def config() -> Config:
    """Process-wide cached config."""
    global _CONFIG
    if _CONFIG is None:
        _CONFIG = Config.from_env()
        logger.info("tpu_bls12_381_torch config: %s", _CONFIG)
    return _CONFIG


def reset_config_cache() -> None:
    """Drop the cache (tests / after os.environ mutation)."""
    global _CONFIG
    _CONFIG = None
