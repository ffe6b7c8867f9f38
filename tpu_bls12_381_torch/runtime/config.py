"""Env-var-driven configuration, read once and cached.

Counterpart of the JAX package's ``runtime/config.py``, with only what the
ported slice reads:

  MIDNIGHT_TPU_PRECOMPUTE precompute factor of an ``MsmContext`` upload that
                          names none, 1..8, default 1 (alias
                          MIDNIGHT_GPU_PRECOMPUTE; the name is the JAX
                          package's).
  MIDNIGHT_MSM_WINDOW     window bits of the context's MSMs, default 0 = the
                          heuristic (``pippenger.window_bits_for``).
  MIDNIGHT_MSM_GLV        auto | on | off   G1 MSM via the GLV split.  ``auto``
                          (default): on while the doubled point set still fits
                          the device memory budget in one shot.
  MIDNIGHT_NTT_ORDERING   NN | NR | RN | RR, default NN: the ordering an
                          ``NttContext`` call takes when it names none.
  MIDNIGHT_NTT_ALGORITHM  auto | radix2 | fourstep, default auto
                          (``mixedradix`` is read as ``fourstep``); the
                          routing rule is ``ntt/ntt.py::_route_fourstep``.
  MIDNIGHT_NTT_MAX_LOG_N  default domain size a context pre-builds, default 16.

Two more are read where they are used, at every call, as in the JAX package:
MIDNIGHT_MSM_HBM_BUDGET_MB (an upper limit on the device memory the MSM
pipeline plans with, ``pippenger._available_budget``) and
MIDNIGHT_EXPAND_CHUNK_LOG (the point-slice of ``pippenger.expand_bases``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

logger = logging.getLogger("tpu_bls12_381_torch")


def _int_env(name: str, default: int, lo: int, hi: int,
             aliases: tuple = ()) -> int:
    """The first of ``name`` and its aliases that is set, as an int clamped
    to [lo, hi]; ``default`` where none is set or the value is no int."""
    for key in (name, *aliases):
        raw = os.environ.get(key)
        if raw is None:
            continue
        try:
            v = int(raw)
        except ValueError:
            logger.warning("%s=%r is not an int; using %d", key, raw, default)
            return default
        if not lo <= v <= hi:
            logger.warning("%s=%d out of [%d, %d]; clamping", key, v, lo, hi)
            return min(max(v, lo), hi)
        return v
    return default


@dataclass(frozen=True)
class Config:
    precompute_factor: int
    msm_window: int | None
    msm_glv: str
    ntt_max_log_n: int
    ntt_ordering: str
    ntt_algorithm: str

    @classmethod
    def from_env(cls) -> "Config":
        algorithm = os.environ.get("MIDNIGHT_NTT_ALGORITHM", "auto").lower()
        return cls(
            precompute_factor=_int_env("MIDNIGHT_TPU_PRECOMPUTE", 1, 1, 8,
                                       aliases=("MIDNIGHT_GPU_PRECOMPUTE",)),
            msm_window=_int_env("MIDNIGHT_MSM_WINDOW", 0, 0, 24) or None,
            msm_glv={"1": "on", "true": "on", "on": "on", "yes": "on",
                     "0": "off", "false": "off", "off": "off", "no": "off",
                     }.get(os.environ.get("MIDNIGHT_MSM_GLV", "auto")
                           .lower(), "auto"),
            ntt_max_log_n=_int_env("MIDNIGHT_NTT_MAX_LOG_N", 16, 0, 32),
            ntt_ordering=os.environ.get("MIDNIGHT_NTT_ORDERING", "NN").upper(),
            ntt_algorithm={"mixedradix": "fourstep"}.get(algorithm, algorithm),
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
