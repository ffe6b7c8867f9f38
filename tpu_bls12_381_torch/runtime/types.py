"""Bulk type conversion between wire formats and the port's limb tensors.

Counterpart of the JAX package's ``runtime/types.py``.  The wire types are 4
(Fr) or 6 (Fq) little-endian 64-bit words an element; the port's limbs are
16 (Fr) or 24 (Fq) 16-bit limbs, limbs first, each in an int32 slot: the same
byte image, so the conversion is a numpy dtype view, a transpose and a widen
(no per-element Python).  Montgomery form is kept byte for byte, because both
representations use R = 2^256 (Fr) and 2^384 (Fq).

Wire layout: element-major; Fq2 is c0 || c1; an affine point is x || y, and a
point whose x and y are all zero is the identity (the convention the
reference's converters use for ``is_zero`` points), which ``*_to_bytes``
writes for every lane whose ``inf`` is set.

The ``*_from_bytes`` functions make tensors and follow the device rule:
``device=None`` is the CUDA card.  A G2 coordinate is the port's one
``(24, 2, n)`` tensor.  The ``*_to_bytes`` functions take tensors from
anywhere (or numpy arrays).  ``mont_encode_host`` / ``mont_decode_host``
work on host arrays, with the native library where it builds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..fields import FR
from ..fields.field import FieldSpec


def _host(a) -> np.ndarray:
    """A tensor from anywhere, or an array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def u64_words_to_limbs(words: np.ndarray) -> np.ndarray:
    """(n, k64) uint64 LE words -> (k16, n) int32 16-bit limbs (view + widen)."""
    w = np.ascontiguousarray(words, dtype="<u8")
    n = w.shape[0] if w.ndim == 2 else 1
    u16 = w.reshape(n, -1).view("<u2")  # (n, k64*4)
    return np.ascontiguousarray(u16.T).astype(np.int32)


def limbs_to_u64_words(limbs) -> np.ndarray:
    """(k16, n) limbs (int32 or uint32, tensor or array) -> (n, k64) uint64."""
    a = _host(limbs)
    if a.ndim == 1:
        a = a[:, None]
    le16 = np.ascontiguousarray(a.T.astype("<u2"))  # (n, k16)
    return le16.view("<u8").copy()


def _words(data, k64: int) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype="<u8").reshape(-1, k64)
    return np.asarray(data)


def _tensor(limbs: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(limbs).to(device)


def scalars_from_bytes(data, device=None) -> torch.Tensor:
    """Fr wire bytes (n*32, LE), or (n, 4) words -> (16, n) int32 limbs."""
    return _tensor(u64_words_to_limbs(_words(data, 4)), resolve_device(device))


def scalars_to_bytes(limbs) -> bytes:
    return limbs_to_u64_words(limbs).tobytes()


def fq_from_bytes(data, device=None) -> torch.Tensor:
    """Fq wire bytes (n*48, LE), or (n, 6) words -> (24, n) int32 limbs."""
    return _tensor(u64_words_to_limbs(_words(data, 6)), resolve_device(device))


def fq_to_bytes(limbs) -> bytes:
    return limbs_to_u64_words(limbs).tobytes()


def g1_affine_from_bytes(data, device=None) -> tuple:
    """n G1 affine points (x||y, 96 bytes each, LE, standard or Montgomery
    form kept) -> (x, y, inf) tensors; all-zero x and y is the identity."""
    dev = resolve_device(device)
    w = np.frombuffer(data, dtype="<u8").reshape(-1, 12)
    x = u64_words_to_limbs(np.ascontiguousarray(w[:, :6]))
    y = u64_words_to_limbs(np.ascontiguousarray(w[:, 6:]))
    inf = (x == 0).all(axis=0) & (y == 0).all(axis=0)
    return _tensor(x, dev), _tensor(y, dev), _tensor(inf, dev)


def g1_affine_to_bytes(x, y, inf) -> bytes:
    xw = limbs_to_u64_words(x)
    yw = limbs_to_u64_words(y)
    mask = _host(inf).reshape(-1, 1)
    xw = np.where(mask, 0, xw)
    yw = np.where(mask, 0, yw)
    return np.concatenate([xw, yw], axis=1).astype("<u8").tobytes()


def g2_affine_from_bytes(data, device=None) -> tuple:
    """n G2 points (x.c0||x.c1||y.c0||y.c1, 192 bytes each, LE) -> (x, y, inf)
    with x and y ``(24, 2, n)`` tensors; all-zero coordinates are the
    identity."""
    dev = resolve_device(device)
    w = np.frombuffer(data, dtype="<u8").reshape(-1, 24)
    xc0, xc1, yc0, yc1 = (u64_words_to_limbs(np.ascontiguousarray(w[:, 6 * i:6 * i + 6]))
                          for i in range(4))
    inf = ((xc0 == 0).all(axis=0) & (xc1 == 0).all(axis=0)
           & (yc0 == 0).all(axis=0) & (yc1 == 0).all(axis=0))
    return (_tensor(np.stack([xc0, xc1], axis=1), dev),
            _tensor(np.stack([yc0, yc1], axis=1), dev), _tensor(inf, dev))


def g2_affine_to_bytes(x, y, inf) -> bytes:
    """(x, y, inf) with x and y ``(24, 2, n)`` -> wire bytes."""
    xh, yh = _host(x), _host(y)
    words = [limbs_to_u64_words(c[:, i]) for c in (xh, yh) for i in range(2)]
    mask = _host(inf).reshape(-1, 1)
    words = [np.where(mask, 0, wv) for wv in words]
    return np.concatenate(words, axis=1).astype("<u8").tobytes()


def _native_field_id(spec: FieldSpec) -> int:
    from .. import native

    return native.FIELD_FR if spec.num_limbs == FR.num_limbs else native.FIELD_FQ


def mont_encode_host(spec: FieldSpec, limbs) -> np.ndarray:
    """Host-side standard -> Montgomery (for wire data in standard form):
    (K, n) limbs -> (K, n) int32 limbs.

    Uses the native C++ batch CIOS (``native/convert.cpp``) where it builds,
    Python integers otherwise.
    """
    from .. import native
    from ..fields.limbs import ints_to_limbs, limbs_to_ints

    if native.available():
        words = limbs_to_u64_words(limbs)
        return u64_words_to_limbs(native.mont_encode(words, _native_field_id(spec)))
    vals = [spec.to_mont(v) for v in limbs_to_ints(_host(limbs))]
    return ints_to_limbs(vals, spec.num_limbs).astype(np.int32)


def mont_decode_host(spec: FieldSpec, limbs) -> np.ndarray:
    """Host-side Montgomery -> standard: (K, n) limbs -> (K, n) int32 limbs."""
    from .. import native
    from ..fields.limbs import ints_to_limbs, limbs_to_ints

    if native.available():
        words = limbs_to_u64_words(limbs)
        return u64_words_to_limbs(native.mont_decode(words, _native_field_id(spec)))
    vals = [spec.from_mont(v) for v in limbs_to_ints(_host(limbs))]
    return ints_to_limbs(vals, spec.num_limbs).astype(np.int32)

