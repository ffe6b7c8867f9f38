"""Sharded Pippenger MSM: the points cut into chunks, one partial MSM a chunk.

Counterpart of the JAX package's ``parallel/msm.py``.  The inputs carry a
leading chunk axis D; each rank holds its block of it and runs a whole local
Pippenger over each of its chunks (``msm/pippenger.py::msm_chunked``: sort,
bucket scan, triangle, Horner) with no traffic between ranks.  The chunk
points (three field elements each) are then gathered from every rank in
global chunk order and tree-summed with the group law on every rank, so every
rank returns the same limbs.  The traffic is D points whatever n is.
"""

from __future__ import annotations

import torch

from ..curves import points as pt
from ..curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER
from ..msm import pippenger
from .mesh import all_gather_tree, check_collectives, default_mesh


def _check_sizes(scalars, A, n_chunks: int, segments: int) -> None:
    n_pts = A[2].shape[-1]
    n_sc = scalars.shape[-1]
    if n_pts % (n_chunks * segments) or n_sc % n_chunks:
        raise ValueError(
            f"MSM size {n_pts} (pts) / {n_sc} (scalars) not divisible into "
            f"{n_chunks} chunks of {segments} segment(s)")


def _chunk(c, n_chunks: int, d: int, segments: int = 1):
    """Chunk d of the last axis of ``c``, which is ``segments`` equal blocks
    side by side: chunk d of each block, the blocks' pieces re-concatenated
    in order."""
    nseg = c.shape[-1] // segments
    nloc = nseg // n_chunks
    return torch.cat([c[..., s * nseg + d * nloc:s * nseg + (d + 1) * nloc]
                      for s in range(segments)], dim=-1)


def chunk_msm_inputs(scalars, A, n_chunks: int, *, segments: int = 1):
    """(16, N) scalars + affine batch -> leading-chunk-axis form.

    Returns scalars (D, 16, mloc); A leaves (D, *elem, nloc); inf (D, nloc).

    ``segments`` > 1: the base array's point axis is a concatenation of
    ``segments`` equal blocks (the GLV extension contributes x2, a precompute
    factor f contributes xf, block-major, as ``glv_extend_bases`` then
    ``expand_bases`` lay them out).  Each block is chunked on its own and a
    chunk holds its blocks' pieces re-concatenated in order, so that a
    chunk's GLV split and factor regroup line up with its own points.
    """
    _check_sizes(scalars, A, n_chunks, segments)

    def chunks(c, seg):
        return torch.stack([_chunk(c, n_chunks, d, seg) for d in range(n_chunks)])

    x, y, inf = A
    return chunks(scalars, 1), (chunks(x, segments), chunks(y, segments),
                                chunks(inf, segments))


def shard_msm_inputs(scalars, A, mesh, *, segments: int = 1):
    """This rank's block of the chunk axis, one chunk a rank, on the rank's
    device: scalars (1, 16, N/p), A leaves (1, *elem, n/p), cut out of the
    full arrays.  A rank that holds only its own block of points and scalars
    (the same block-major layout over ``segments``) passes it through
    ``chunk_msm_inputs(..., 1, segments=...)``, which lays it out alike."""
    _check_sizes(scalars, A, mesh.size, segments)

    def block(c, seg):
        return _chunk(c, mesh.size, mesh.rank, seg)[None].to(mesh.device).contiguous()

    x, y, inf = A
    return block(scalars, 1), (block(x, segments), block(y, segments),
                               block(inf, segments))


def _combine_chunks(F, P_chunks):
    """Per-chunk Jacobian points (leaves (D, *elem)) -> one point (tree-sum
    in chunk order: ``jadd`` for G1 on the card)."""
    batched = tuple(c.movedim(0, -1).contiguous() for c in P_chunks)  # (*elem, D)
    return pt.sum_reduce(F, batched)


def msm_sharded(F, scalars_c, A_c, mesh=None, *, window_bits: int | None = None,
                scalars_montgomery: bool = True, glv: bool = False,
                factor: int = 1):
    """MSM over chunked inputs, this rank's block of them.

    ``scalars_c`` / ``A_c`` come from :func:`shard_msm_inputs` (a rank's
    block) or :func:`chunk_msm_inputs` (all chunks, a world of one).  Returns
    one Jacobian point, the same limbs on every rank.  ``mesh`` None is
    :func:`default_mesh` on the inputs' device.

    ``glv`` / ``factor`` compose as on one device: GLV splits each chunk's
    scalars in the chunk; ``factor`` > 1 expects bases expanded by
    ``expand_bases`` and chunked with
    ``chunk_msm_inputs(..., segments=factor * (2 if glv else 1))``.
    """
    mesh = mesh if mesh is not None else default_mesh(device=A_c[2].device)
    check_collectives(mesh, "msm_sharded")
    if any(t.device != mesh.device for t in (scalars_c, *A_c)):
        raise ValueError(f"msm_sharded: the inputs are not on the mesh's device "
                         f"{mesh.device}")
    P_chunks = pippenger.msm_chunked(
        F, scalars_c, A_c, window_bits=window_bits,
        scalars_montgomery=scalars_montgomery, glv=glv, factor=factor)
    return _combine_chunks(F, all_gather_tree(mesh, P_chunks))


def msm_g1_sharded(scalars_c, A_c, mesh=None, **kw):
    return msm_sharded(FQ_ADAPTER, scalars_c, A_c, mesh, **kw)


def msm_g2_sharded(scalars_c, A_c, mesh=None, **kw):
    return msm_sharded(FQ2_ADAPTER, scalars_c, A_c, mesh, **kw)
