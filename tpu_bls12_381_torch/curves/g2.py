"""G2: y^2 = x^3 + 4(1+u) over Fq2: curve constants and host<->device
converters.

Counterpart of the JAX package's ``curves/g2.py``.  An Fq2 coordinate is one
``(24, 2, *batch)`` tensor (``curves/field_adapters.py``); on the host a
point is ``((x0, x1), (y0, y1))`` in Python integers, as the oracle and the
JAX package have it.  The makers follow the device rule: ``device=None``
means the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..device import resolve_device
from ..fields import FQ
from ..fields.limbs import int_to_limbs, ints_to_limbs, limbs_to_ints
from . import points
from .field_adapters import FQ2_ADAPTER

F = FQ2_ADAPTER

_B_LIMBS = np.stack([int_to_limbs(FQ.to_mont(c), FQ.num_limbs)
                     for c in constants.G2_B], axis=1)          # (24, 2)


def b_mont(batch_shape=(), device=None):
    batch_shape = tuple(batch_shape)
    col = torch.from_numpy(_B_LIMBS.astype(np.int32)).to(resolve_device(device))
    return col.reshape((FQ.num_limbs, 2) + (1,) * len(batch_shape)).expand(
        (FQ.num_limbs, 2) + batch_shape).contiguous()


def _fq2_tensor(c0, c1, device):
    k = FQ.num_limbs
    arr = np.stack([ints_to_limbs(c0, k), ints_to_limbs(c1, k)], axis=1)
    return torch.from_numpy(np.ascontiguousarray(arr).astype(np.int32)).to(device)


def affine_from_ints(pts, device=None):
    """List of ((x0, x1), (y0, y1)) int pairs or None -> Fq2 affine batch
    (Montgomery form)."""
    device = resolve_device(device)
    coord = lambda c, i: [FQ.to_mont(p[c][i]) if p is not None else 0
                          for p in pts]
    inf = np.array([p is None for p in pts], dtype=bool)
    return (_fq2_tensor(coord(0, 0), coord(0, 1), device),
            _fq2_tensor(coord(1, 0), coord(1, 1), device),
            torch.from_numpy(inf).to(device))


def affine_to_ints(A):
    """Fq2 affine batch -> list of ((x0, x1), (y0, y1)) / None (standard
    form)."""
    x, y, inf = A
    ints = lambda c, i: [FQ.from_mont(v) for v in limbs_to_ints(
        c[:, i].reshape(FQ.num_limbs, -1).cpu().numpy())]
    x0, x1, y0, y1 = ints(x, 0), ints(x, 1), ints(y, 0), ints(y, 1)
    inf = inf.cpu().numpy().reshape(-1)
    return [None if i else ((a, b), (c, d))
            for a, b, c, d, i in zip(x0, x1, y0, y1, inf)]


def jacobian_to_ints(P):
    return affine_to_ints(points.jac_to_affine(F, P))


def generator_affine(batch_shape=(), device=None):
    """The generator in every lane of ``batch_shape`` (one lane converted on
    the host, then repeated where the batch lives)."""
    batch_shape = tuple(batch_shape)
    x, y, inf = affine_from_ints(
        [(constants.G2_GENERATOR_X, constants.G2_GENERATOR_Y)], device)
    if not batch_shape:
        return x, y, inf
    shape = (FQ.num_limbs, 2) + batch_shape
    col = lambda c: c.reshape((FQ.num_limbs, 2) + (1,) * len(batch_shape))
    return (col(x).expand(shape).contiguous(), col(y).expand(shape).contiguous(),
            inf.reshape((1,) * len(batch_shape)).expand(batch_shape).contiguous())
