"""Tuning profiles of the port: one for an NVIDIA H100, one for the CPU.

Counterpart of the JAX package's ``tuning.py``, with only the fields the
ported slice reads.  The profile is chosen by the device the tensors live on;
the GPU profile takes its facts from ``torch.cuda.get_device_properties``.
The MSM caps shape the bucket tile (window bits, lane width); they do not
change any result.  They are first values, not tuned ones: PERF.md says what
a run used.  The NTT cap is a fact of the device, not a tuning value: the
longest row whose elements one thread block can hold in shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import torch


@dataclass(frozen=True)
class ChipProfile:
    """Tuning knobs read by msm/pippenger.py and ntt/cuda_ntt.py."""

    name: str
    # MSM window ceiling below / at-or-above the large-size crossover
    # (pippenger.window_bits_for).
    msm_window_cap_small: int
    msm_window_cap_large: int
    msm_large_log_n: int
    # log2 ceiling of the bucket-accumulation lane tile L
    # (pippenger.lane_tile_for): one scan thread per lane.
    msm_lane_tile_log_cap: int
    # log2 floors of G1's and G2's lane tiles where the points allow 16
    # rows: the lanes the scan kernel needs in flight to fill the card.
    msm_g1_lane_tile_log_min: int
    msm_g2_lane_tile_log_min: int
    # log2 of the longest row the NTT tile kernel takes in one block
    # (ntt/cuda_ntt.py): shared memory a block may opt into, at 32 bytes an
    # Fr element.
    ntt_tile_log_cap: int


# Bytes of one Fr element in the tile kernel's shared memory (csrc/ntt.cuh).
NTT_TILE_ELEM_BYTES = 32

# First values, the same on both devices until a measurement on the card
# says otherwise.
_CAPS = dict(msm_window_cap_small=15, msm_window_cap_large=16,
             msm_large_log_n=22, msm_lane_tile_log_cap=15)

# On the CPU nothing is held in shared memory; the cap is an H100's (227 KB:
# rows of 2^12), so that a size splits there as it does on the card.  The
# CPU's tiles have no floor: they are the JAX package's.
_CPU = ChipProfile("cpu", **_CAPS, msm_g1_lane_tile_log_min=3,
                   msm_g2_lane_tile_log_min=3, ntt_tile_log_cap=12)

# The tiles' floors on the card, from chip_smoke.py's sweeps of the scan
# kernels over tiles of one window's adds (tile_sweep, tile_sweep_g2; PERF.md).
_CUDA_G1_LANE_TILE_LOG_MIN = 15
_CUDA_G2_LANE_TILE_LOG_MIN = 14

# log2 of the columns L of the batch inversion's (R, L) tile on the card
# (vecops.batch_inverse_tile; the CPU's plain loop keeps the JAX package's
# 4096): 2^14 threads for phases 1 and 3 (R = 64 rows at 2^20 elements)
# against runs of 64 columns a thread in phase 2's one block of 256.
# chip_smoke.py's chain_sweep times L = 2^12 .. 2^16: 2^14 is the fastest
# for the upload's 2^20 Fq elements, 2^15 for 2^22 Fr by 0.35 ms (PERF.md);
# one value serves both.
CUDA_BATCH_INVERSE_LANES_LOG = 14


@lru_cache(maxsize=None)
def _cuda_profile(index: int) -> ChipProfile:
    props = torch.cuda.get_device_properties(index)
    row = props.shared_memory_per_block_optin // NTT_TILE_ELEM_BYTES
    return ChipProfile(props.name, **_CAPS,
                       msm_g1_lane_tile_log_min=_CUDA_G1_LANE_TILE_LOG_MIN,
                       msm_g2_lane_tile_log_min=_CUDA_G2_LANE_TILE_LOG_MIN,
                       ntt_tile_log_cap=row.bit_length() - 1)


def chip_profile(device=None) -> ChipProfile:
    """Profile for ``device`` (a torch device or string; None = the card)."""
    from .device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        return _cuda_profile(index)
    return _CPU
