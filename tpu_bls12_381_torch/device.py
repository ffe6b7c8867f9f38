"""The device rule of the port.

Functions that take tensors run where the tensors live.  Functions that make
tensors take ``device=None``, and ``None`` means the CUDA card: when no card
is present they raise, they never carry on on the CPU.  The CPU is used only
when the caller names it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises without one); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpu_bls12_381_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run the plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
