"""The device mesh of the scale-out layer, on ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``.  One 1-D data axis is
all these workloads need: the MSM cuts its points into chunks, the NTT its
matrix rows.  The port runs one process per device (a rank), as ``torchrun``
starts them: :func:`init_distributed` joins the process group (NCCL for CUDA
devices, gloo for the CPU) and :func:`default_mesh` describes this rank's
place in it.  Without a group the mesh is one rank on one device and its
collectives are the identity, as a one-device JAX mesh's are.

The collectives the two modules beside this one need are here:
:func:`all_gather_tree` (the MSM's chunk points) and :func:`global_transpose`
(the NTT's transposes: one ``all_to_all_single`` and a local swap).
``COLLECTIVES`` counts the collective calls made through a process group.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger("tpu_bls12_381_torch.parallel")

SHARD_AXIS = "shards"

# Collective calls made through a process group, by name (a world without a
# group makes none).
COLLECTIVES = {"all_gather": 0, "all_to_all_single": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, **kw) -> bool:
    """Join a multi-process run; returns True if a process group is active.

    Arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the coordinator, ``WORLD_SIZE`` and ``RANK``, and
    ``LOCAL_RANK`` for this rank's CUDA device.  ``coordinator_address`` is
    ``host:port`` or an init URL (``tcp://...``, ``file://...``).
    ``backend=None`` takes NCCL where a CUDA device is present, else gloo; for
    NCCL the rank's device is made current before the group is.  ``kw`` goes
    to ``torch.distributed.init_process_group`` (``timeout``, ...).

    Safe to call in a single process: with no coordinator configured it logs
    and returns False instead of waiting for peers, so library code can call
    it unconditionally.  A second call returns True.  A configured
    coordinator that cannot be reached raises.
    """
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    if coordinator_address is None:
        logger.info("init_distributed: no coordinator configured; staying single-process")
        return False
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"]) if "WORLD_SIZE" in os.environ else None
    if process_id is None:
        process_id = int(os.environ["RANK"]) if "RANK" in os.environ else None
    if num_processes is None or process_id is None:
        raise ValueError("init_distributed: a coordinator is set but the world size or "
                         "the rank is not (WORLD_SIZE, RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, **kw)
    logger.info("init_distributed: rank %d/%d over %s", process_id, num_processes, backend)
    return True


def shard_axis() -> str:
    return SHARD_AXIS


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the 1-D mesh: the process group (None without
    one: a world of one), the rank, the world size, and the rank's device.
    A mesh of several ranks without a group describes a rank for its own
    tables (``local_block``, the step twiddles, the coset powers); its
    collectives raise."""

    group: object
    rank: int
    size: int
    device: torch.device


def default_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """The mesh over the initialized world, this rank on ``device`` (None =
    the current CUDA device, which :func:`init_distributed` set for NCCL;
    ``"cpu"`` for a gloo world).  Without a process group: one rank.
    ``n_devices``, if given, must be the world size: the port runs one
    process a device."""
    dev = resolve_device(device)
    if dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices != size:
        raise ValueError(f"default_mesh: {n_devices} devices asked, the world has {size} "
                         f"rank(s), one a device")
    return Mesh(group, rank, size, dev)


def local_block(mesh: Mesh, n: int, axis: int = -1):
    """The index of this rank's block of an axis of length ``n``: its
    contiguous n/p entries, as ``P(..., SHARD_AXIS, ...)`` lays the axis out
    over the mesh.  ``x[local_block(mesh, x.shape[a], a)]``."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    block = slice(mesh.rank * per, (mesh.rank + 1) * per)
    if axis < 0:
        return (Ellipsis, block) + (slice(None),) * (-axis - 1)
    return (slice(None),) * axis + (block,)


def check_collectives(mesh: Mesh, what: str) -> None:
    """Raise where ``mesh`` has several ranks but no process group to join
    them: the identity collectives of a world of one would return this
    rank's part as if it were the whole."""
    if mesh.group is None and mesh.size > 1:
        raise ValueError(f"{what}: a mesh of {mesh.size} ranks has no process group "
                         f"(init_distributed, then default_mesh)")


def all_gather_tree(mesh: Mesh, tree):
    """Every rank's leaves concatenated along axis 0 in rank order (the
    leaves of a rank: its block of that axis).  One ``all_gather`` a leaf;
    the identity in a world of one without a process group."""
    if mesh.group is None:
        check_collectives(mesh, "all_gather_tree")
        return tree
    out = []
    for leaf in tree:
        leaf = leaf.contiguous()
        parts = [torch.empty_like(leaf) for _ in range(mesh.size)]
        dist.all_gather(parts, leaf, group=mesh.group)
        COLLECTIVES["all_gather"] += 1
        out.append(torch.cat(parts, dim=0))
    return tuple(out)


def global_transpose(mesh: Mesh, x):
    """Rows of a global (r, c) matrix, this rank's (K, r/p, c), -> this rank's
    rows of the transpose, (K, c/p, r), contiguous.

    The exchange of ``jax.lax.all_to_all(split_axis=2, concat_axis=1,
    tiled=True)`` then a swap of the two axes: the column blocks are laid out
    along a leading axis (``all_to_all_single`` splits axis 0), exchanged, and
    the received row blocks are put side by side in rank order as they are
    swapped."""
    K, r_loc, c = x.shape
    p = mesh.size
    if mesh.group is None:
        check_collectives(mesh, "global_transpose")
        return x.transpose(1, 2).contiguous()
    if c % p:
        raise ValueError(f"global_transpose: {c} columns do not split over {p} ranks")
    send = x.reshape(K, r_loc, p, c // p).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    COLLECTIVES["all_to_all_single"] += 1
    # recv[i, k, a, b]: rank i's row a, this rank's column b
    return recv.permute(1, 3, 0, 2).reshape(K, c // p, p * r_loc)
