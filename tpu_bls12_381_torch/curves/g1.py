"""G1: y^2 = x^3 + 4 over Fq: curve constants and host<->device converters.

Counterpart of the JAX package's ``curves/g1.py``.  The makers follow the
device rule: ``device=None`` means the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..device import resolve_device
from ..fields import FQ, ops
from ..fields.limbs import int_to_limbs, ints_to_limbs, limbs_to_ints
from . import points
from .field_adapters import FQ_ADAPTER

F = FQ_ADAPTER

B_MONT_LIMBS = int_to_limbs(FQ.to_mont(constants.G1_B), FQ.num_limbs)


def b_mont(batch_shape=(), device=None):
    return ops.broadcast_constant(FQ, B_MONT_LIMBS, batch_shape, device)


def _limbs_tensor(arr, device):
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def affine_from_ints(pts, device=None):
    """List of (x, y) int pairs or None -> affine batch (Montgomery form)."""
    device = resolve_device(device)
    xs = [FQ.to_mont(p[0]) if p is not None else 0 for p in pts]
    ys = [FQ.to_mont(p[1]) if p is not None else 0 for p in pts]
    inf = np.array([p is None for p in pts], dtype=bool)
    return (
        _limbs_tensor(ints_to_limbs(xs, FQ.num_limbs), device),
        _limbs_tensor(ints_to_limbs(ys, FQ.num_limbs), device),
        torch.from_numpy(inf).to(device),
    )


def affine_to_ints(A):
    """Affine batch -> list of (x, y) int pairs / None (standard form)."""
    x = limbs_to_ints(A[0].cpu().numpy())
    y = limbs_to_ints(A[1].cpu().numpy())
    inf = A[2].cpu().numpy().reshape(-1)
    return [None if i else (FQ.from_mont(xv), FQ.from_mont(yv))
            for xv, yv, i in zip(x, y, inf)]


def jacobian_to_ints(P):
    """Jacobian batch -> affine int pairs / None (oracle comparison).  The
    inversion runs where the point lives (``points.jac_to_affine``)."""
    P = tuple(c.reshape(FQ.num_limbs, -1) for c in P)
    return affine_to_ints(points.jac_to_affine(F, P))


def generator_affine(batch_shape=(), device=None):
    """The generator in every lane of ``batch_shape`` (one lane converted on
    the host, then repeated where the batch lives)."""
    batch_shape = tuple(batch_shape)
    x, y, inf = affine_from_ints(
        [(constants.G1_GENERATOR_X, constants.G1_GENERATOR_Y)], device)
    if not batch_shape:
        return x, y, inf
    shape = (FQ.num_limbs,) + batch_shape
    col = lambda c: c.reshape((FQ.num_limbs,) + (1,) * len(batch_shape))
    return (col(x).expand(shape).contiguous(), col(y).expand(shape).contiguous(),
            inf.reshape((1,) * len(batch_shape)).expand(batch_shape).contiguous())
