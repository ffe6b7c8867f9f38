"""State carried across: numpy arrays of the JAX package <-> the port's tensors.

The JAX package holds limbs as ``uint32`` arrays ``(16, N)`` / ``(24, N)`` and
masks as bool arrays; ``np.asarray`` of those is what these functions take.
The port stores limbs as ``int32`` (a 16-bit limb is the same bits in both).
The makers follow the device rule: ``device=None`` means the CUDA card.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .fields import FQ, FR
from .fields.ops import LIMB_DTYPE


def _limbs_from_numpy(arr, k: int, name: str, device):
    a = np.asarray(arr)
    if a.ndim < 1 or a.shape[0] != k:
        raise ValueError(f"{name}: expected shape ({k}, ...), got {a.shape}")
    if a.size and int(a.max()) > 0xFFFF:
        raise ValueError(f"{name}: limbs must be below 2^16")
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.int32)))
    return t.to(resolve_device(device))


def scalars_from_numpy(arr, device=None):
    """(16, N) limb array of Fr scalars -> int32 tensor on ``device``."""
    return _limbs_from_numpy(arr, FR.num_limbs, "scalars", device)


def field_from_numpy(arr, spec, device=None):
    """(K, *batch) limb array of ``spec`` elements -> int32 tensor."""
    return _limbs_from_numpy(arr, spec.num_limbs, spec.name, device)


def affine_from_numpy(x, y, inf, device=None):
    """Affine batch as numpy arrays -> (x, y, inf) tensors on ``device``."""
    dev = resolve_device(device)
    inf_t = torch.from_numpy(np.array(inf, dtype=bool))
    return (_limbs_from_numpy(x, FQ.num_limbs, "x", dev),
            _limbs_from_numpy(y, FQ.num_limbs, "y", dev),
            inf_t.to(dev))


def point_from_numpy(P, device=None):
    """A G1 point of the JAX package (projective or Jacobian: three (24,
    *batch) limb arrays) -> a tuple of three int32 tensors on ``device``."""
    dev = resolve_device(device)
    return tuple(_limbs_from_numpy(c, FQ.num_limbs, f"coordinate {i}", dev)
                 for i, c in enumerate(P))


def mask_from_numpy(m, device=None):
    """A bool batch mask of the JAX package (an affine ``inf``, the result of
    ``is_on_curve_*`` or ``is_in_subgroup``) -> a bool tensor on ``device``."""
    return torch.from_numpy(np.array(m, dtype=bool)).to(resolve_device(device))


def to_numpy(t):
    """A limb or mask tensor -> numpy (limbs as uint32, as the JAX package)."""
    a = t.detach().cpu().numpy()
    return a.astype(np.uint32) if t.dtype == LIMB_DTYPE else a


def point_to_numpy(P):
    """A point tuple (projective, Jacobian or affine) -> tuple of numpy arrays."""
    return tuple(to_numpy(c) for c in P)


def domain_from_numpy(log_n: int, tw, itw, n_inv, device=None):
    """The tables of an NTT domain of the JAX package (``np.asarray`` of its
    ``tw``, ``itw`` and ``n_inv``) -> a ``Domain`` of the port on ``device``.
    The root is derived here, as both packages derive it."""
    from .ntt.domain import Domain
    from .oracle import root_of_unity

    dev = resolve_device(device)
    half = (1 << log_n) // 2
    for name, arr in (("tw", tw), ("itw", itw)):
        if np.asarray(arr).shape != (FR.num_limbs, half):
            raise ValueError(f"{name}: expected shape ({FR.num_limbs}, {half}), "
                             f"got {np.asarray(arr).shape}")
    if np.asarray(n_inv).shape != (FR.num_limbs,):
        raise ValueError(f"n_inv: expected shape ({FR.num_limbs},), got "
                         f"{np.asarray(n_inv).shape}")
    return Domain(log_n=log_n,
                  tw=_limbs_from_numpy(tw, FR.num_limbs, "tw", dev),
                  itw=_limbs_from_numpy(itw, FR.num_limbs, "itw", dev),
                  n_inv=_limbs_from_numpy(n_inv, FR.num_limbs, "n_inv", dev),
                  omega=root_of_unity(log_n))


def domain_to_numpy(domain):
    """A ``Domain`` of the port -> (tw, itw, n_inv) as numpy uint32 arrays, as
    the JAX package holds them."""
    return to_numpy(domain.tw), to_numpy(domain.itw), to_numpy(domain.n_inv)


# -----------------------------------------------------------------------------
# G2: the JAX package holds an Fq2 batch as a (c0, c1) pair of (24, *batch)
# arrays; the port holds one (24, 2, *batch) tensor (curves/field_adapters.py).
# -----------------------------------------------------------------------------

def _is_pair(v) -> bool:
    return isinstance(v, (tuple, list)) and len(v) == 2


def fq2_from_numpy(pair, device=None):
    """An Fq2 batch of the JAX package, (c0, c1), -> (24, 2, *batch) tensor."""
    if not _is_pair(pair):
        raise ValueError("fq2: expected a (c0, c1) pair of limb arrays")
    c0, c1 = (np.asarray(c) for c in pair)
    if c0.shape != c1.shape:
        raise ValueError(f"fq2: c0 has shape {c0.shape}, c1 has {c1.shape}")
    dev = resolve_device(device)
    return torch.stack([_limbs_from_numpy(c0, FQ.num_limbs, "fq2 c0", dev),
                        _limbs_from_numpy(c1, FQ.num_limbs, "fq2 c1", dev)],
                       dim=1)


def fq2_to_numpy(t):
    """A (24, 2, *batch) tensor -> the JAX package's (c0, c1) pair."""
    a = to_numpy(t)
    return (np.ascontiguousarray(a[:, 0]), np.ascontiguousarray(a[:, 1]))


def affine_g2_from_numpy(x, y, inf, device=None):
    """G2 affine batch of the JAX package, ((x0, x1), (y0, y1), inf) as numpy
    arrays, -> (x, y, inf) tensors on ``device``."""
    dev = resolve_device(device)
    inf_t = torch.from_numpy(np.array(inf, dtype=bool))
    return (fq2_from_numpy(x, dev), fq2_from_numpy(y, dev), inf_t.to(dev))


def point_g2_from_numpy(P, device=None):
    """A G2 point of the JAX package (projective or Jacobian: three (c0, c1)
    pairs) -> a tuple of three (24, 2, *batch) tensors."""
    return tuple(fq2_from_numpy(c, device) for c in P)


def point_g2_to_numpy(P):
    """A G2 point tuple of the port (projective, Jacobian or affine) -> the
    JAX package's form: a (c0, c1) pair per coordinate, masks as they are."""
    return tuple(fq2_to_numpy(c) if c.dtype == LIMB_DTYPE else to_numpy(c)
                 for c in P)


# -----------------------------------------------------------------------------
# Cached bases of an MsmContext: the expanded affine batch and the metadata
# that must travel with it.
# -----------------------------------------------------------------------------

def precomputed_bases_from_numpy(A, n: int, factor: int, window_bits: int,
                                 glv: bool = False, device=None):
    """The fields of a ``PrecomputedBases`` of the JAX package (``A`` as numpy
    arrays: (x, y, inf), with x and y (c0, c1) pairs for G2) -> a
    ``PrecomputedBases`` of the port on ``device``."""
    from .runtime.msm_context import PrecomputedBases

    x, y, inf = A
    if _is_pair(x):
        A_t = affine_g2_from_numpy(x, y, inf, device)
    else:
        A_t = affine_from_numpy(x, y, inf, device)
    want = n * max(factor, 1) * (2 if glv else 1)
    if A_t[2].shape != (want,):
        raise ValueError(
            f"precomputed bases: n={n}, factor={factor}, glv={glv} need "
            f"{want} points, got inf of shape {tuple(A_t[2].shape)}")
    return PrecomputedBases(A=A_t, n=n, factor=factor,
                            window_bits=window_bits, glv=glv)


def precomputed_bases_to_numpy(bases):
    """A ``PrecomputedBases`` of the port -> (A, n, factor, window_bits, glv)
    with ``A`` as the JAX package holds it (numpy arrays; pairs for G2)."""
    x, y, inf = bases.A
    if x.dim() == 3:
        A = point_g2_to_numpy((x, y, inf))
    else:
        A = point_to_numpy((x, y, inf))
    return A, bases.n, bases.factor, bases.window_bits, bases.glv
