"""Live device-allocation report.

Counterpart of the JAX package's ``runtime/memory.py``, which takes a census
of ``jax.live_arrays()``.  PyTorch keeps no such list, so the census here is
of the ``torch.Tensor`` objects the garbage collector can see on CUDA devices
(storages shared by several views are counted once), and the caching
allocator's own figure, ``torch.cuda.memory_allocated``, stands beside it in
the report: the two differ by what lives outside Python tensors (the MSM's
and the NTT's cached tables are tensors and are counted; allocator blocks held
between tensors are not).
"""

from __future__ import annotations

import gc
import warnings
from collections import defaultdict

import torch


def _live_tensors(device_type: str = "cuda"):
    """(tensor, bytes of its storage) for every distinct storage alive on
    devices of ``device_type``."""
    seen = set()
    out = []
    with warnings.catch_warnings():
        # isinstance() on some deprecated module-level objects warns
        warnings.simplefilter("ignore")
        objects = gc.get_objects()
        tensors = [o for o in objects if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.device.type != device_type:
                continue
            storage = obj.untyped_storage()
        except Exception:  # noqa: BLE001 - objects half torn down during gc
            continue
        key = (storage.data_ptr(), obj.device.index)
        if key in seen:
            continue
        seen.add(key)
        out.append((obj, storage.nbytes()))
    return out


def live_arrays_report(top: int = 10) -> str:
    """Human-readable summary of the live CUDA tensors (count, bytes, device),
    with ``torch.cuda.memory_allocated`` for each device beside it."""
    tensors = _live_tensors()
    per_device: dict = defaultdict(lambda: [0, 0])
    entries = []
    for t, nbytes in tensors:
        per_device[str(t.device)][0] += 1
        per_device[str(t.device)][1] += nbytes
        entries.append((nbytes, tuple(t.shape), t.dtype))
    entries.sort(key=lambda e: -e[0])
    lines = [f"live arrays: {len(tensors)}"]
    for dev, (cnt, total) in sorted(per_device.items()):
        alloc = torch.cuda.memory_allocated(torch.device(dev))
        lines.append(f"  {dev}: {cnt} arrays, {total / 1e6:.1f} MB "
                     f"(allocator: {alloc / 1e6:.1f} MB allocated)")
    for nbytes, shape, dtype in entries[:top]:
        lines.append(f"    {nbytes / 1e6:8.1f} MB  {dtype}{list(shape)}")
    return "\n".join(lines)


def total_live_bytes() -> int:
    """Bytes of the distinct CUDA storages held by live tensors."""
    return sum(nbytes for _, nbytes in _live_tensors())
