"""Env-var-driven configuration, read once and cached.

Counterpart of the JAX package's ``runtime/config.py``: every knob is an
environment variable read on first use and cached for the process (call
``reset_config_cache()`` after changing one in-process).  The names are the
JAX package's; where they say TPU, the port reads them for the GPU:

  MIDNIGHT_DEVICE         auto | gpu | cpu, default auto: where ``dispatch_*``
                          send a call.  ``tpu`` is read as ``gpu`` (the JAX
                          package's name for its accelerator); ``gpu`` is the
                          reference's own value.  Anything else: a warning and
                          auto.
  MIDNIGHT_TPU_MIN_K      MSM accelerator threshold, log2 of the point count,
                          default 15, 0..30.
  MIDNIGHT_NTT_MIN_K      NTT accelerator threshold log2, default 12, 0..32.
  MIDNIGHT_VECOPS_MIN_SIZE  vecops accelerator threshold, default 4096.
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
  MIDNIGHT_TRACE          comma list of span tags: msm, ntt, vecops, all
                          (``runtime/tracing.py::span``).

Two more are read where they are used, at every call, as in the JAX package:
MIDNIGHT_MSM_HBM_BUDGET_MB (an upper limit on the device memory the MSM
pipeline plans with, ``pippenger._available_budget``) and
MIDNIGHT_EXPAND_CHUNK_LOG (the point-slice of ``pippenger.expand_bases``).
"""

from __future__ import annotations

import enum
import logging
import os
from dataclasses import dataclass, field

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


class DeviceType(enum.Enum):
    AUTO = "auto"
    GPU = "gpu"
    CPU = "cpu"


# The JAX package's name for its accelerator, read as the GPU.
_DEVICE_ALIASES = {"tpu": "gpu"}


@dataclass(frozen=True)
class Config:
    device: DeviceType
    msm_min_k: int
    ntt_min_k: int
    vecops_min_size: int
    precompute_factor: int
    msm_window: int | None
    msm_glv: str
    ntt_max_log_n: int
    ntt_ordering: str
    ntt_algorithm: str
    trace: frozenset = field(default_factory=frozenset)

    @classmethod
    def from_env(cls) -> "Config":
        raw_dev = os.environ.get("MIDNIGHT_DEVICE", "auto").lower()
        try:
            device = DeviceType(_DEVICE_ALIASES.get(raw_dev, raw_dev))
        except ValueError:
            logger.warning("MIDNIGHT_DEVICE=%r unknown; using auto", raw_dev)
            device = DeviceType.AUTO
        trace_raw = os.environ.get("MIDNIGHT_TRACE", "")
        algorithm = os.environ.get("MIDNIGHT_NTT_ALGORITHM", "auto").lower()
        return cls(
            device=device,
            msm_min_k=_int_env("MIDNIGHT_TPU_MIN_K", 15, 0, 30),
            ntt_min_k=_int_env("MIDNIGHT_NTT_MIN_K", 12, 0, 32),
            vecops_min_size=_int_env("MIDNIGHT_VECOPS_MIN_SIZE", 4096, 0, 1 << 30),
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
            trace=frozenset(t.strip() for t in trace_raw.split(",") if t.strip()),
        )

    # --- routing decisions of runtime/dispatch.py ----------------------------

    def use_accel_msm(self, n: int) -> bool:
        if self.device is DeviceType.CPU:
            return False
        if self.device is DeviceType.GPU:
            return True
        return n >= (1 << self.msm_min_k)

    def use_accel_ntt(self, n: int) -> bool:
        if self.device is DeviceType.CPU:
            return False
        if self.device is DeviceType.GPU:
            return True
        return n >= (1 << self.ntt_min_k)

    def use_accel_vecops(self, n: int) -> bool:
        if self.device is DeviceType.CPU:
            return False
        if self.device is DeviceType.GPU:
            return True
        return n >= self.vecops_min_size

    def traces(self, tag: str) -> bool:
        return "all" in self.trace or tag in self.trace


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
