"""CUDA kernels for the field hot ops, with their plain versions beside them.

Counterpart of the JAX package's ``fields/pallas_ops.py``:

* ``mont_mul`` takes the place of ``_build_mul_kernel`` / ``mont_mul``
  (``fields/pallas_ops.py:381``, ``:436``);
* ``mont_sqr`` takes the place of ``_build_sqr_kernel`` / ``mont_sqr``
  (``fields/pallas_ops.py:391``, ``:441``).

The kernels are CUDA C++ in ``csrc/field_kernels.cu`` (device code in
``csrc/field.cuh``): one thread per element, 32-bit words in registers, CIOS
with 64-bit running sums.  On an H100 the memory bounds them: an Fq product
needs 144 bytes (three elements of 24 limbs of 16 bits) for 300 wide
multiply-adds, and at the card's peak rates the bytes take longer, narrowly.
As stored, a 16-bit limb takes a 32-bit slot, so the kernel moves 288 bytes
and the memory binds it twice as hard (PERF.md has the reckoning).

Each wrapper takes the plain version (``mont_mul_plain`` / ``mont_sqr_plain``,
the int64 CIOS of ``fields/ops.py``) only for tensors on the CPU.  For CUDA
tensors it launches the kernel or raises; there is no fallback.  The wrappers
copy nothing: operands must be contiguous and of one shape, and anything else
raises (``fields/fast.py`` broadcasts and lays out for them).  ``LAUNCHES``
counts kernel launches per C entry point, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ops
from .field import FieldSpec

LAUNCHES = {"mont_mul_fr": 0, "mont_mul_fq": 0,
            "mont_sqr_fr": 0, "mont_sqr_fq": 0}

_PTR = ctypes.c_void_p
_CONFIGURED = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _CONFIGURED
    lib = _build.library("field_kernels")
    if not _CONFIGURED:
        for name in ("fr_mont_mul", "fq_mont_mul"):
            fn = getattr(lib, name)
            fn.argtypes = [_PTR, _PTR, _PTR, ctypes.c_longlong, _PTR]
            fn.restype = ctypes.c_int
        for name in ("fr_mont_sqr", "fq_mont_sqr"):
            fn = getattr(lib, name)
            fn.argtypes = [_PTR, _PTR, ctypes.c_longlong, _PTR]
            fn.restype = ctypes.c_int
        _CONFIGURED = True
    return lib


def check_limbs(t, k: int, name: str) -> None:
    """Raise unless ``t`` is what the kernels take: contiguous int32
    (k, *batch) limbs."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != ops.LIMB_DTYPE:
        raise TypeError(f"{name}: expected dtype {ops.LIMB_DTYPE}, got {t.dtype}")
    if t.dim() < 1 or t.shape[0] != k:
        raise ValueError(f"{name}: expected shape ({k}, *batch), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got strides "
                         f"{tuple(t.stride())} for shape {tuple(t.shape)}")


def check_launch(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {code}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def mont_mul_plain(spec: FieldSpec, a, b):
    """Plain PyTorch version of the ``mont_mul`` kernel."""
    return ops.mont_mul(spec, a, b)


def mont_sqr_plain(spec: FieldSpec, a):
    """Plain PyTorch version of the ``mont_sqr`` kernel."""
    return ops.mont_sqr(spec, a)


def _suffix(spec: FieldSpec) -> str:
    if spec.num_limbs == 16:
        return "fr"
    if spec.num_limbs == 24:
        return "fq"
    raise ValueError(f"no kernel for a field of {spec.num_limbs} limbs")


def mont_mul(spec: FieldSpec, a, b):
    """Batched Montgomery product a*b*R^-1 mod p on (K, *batch) limbs."""
    K = spec.num_limbs
    check_limbs(a, K, "mont_mul: a")
    check_limbs(b, K, "mont_mul: b")
    if a.device != b.device:
        raise ValueError(f"mont_mul: devices differ ({a.device}, {b.device})")
    if a.shape != b.shape:
        raise ValueError(f"mont_mul: shapes differ ({tuple(a.shape)}, "
                         f"{tuple(b.shape)})")
    if not a.is_cuda:
        return mont_mul_plain(spec, a, b)
    sfx = _suffix(spec)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = getattr(_lib(), f"{sfx}_mont_mul")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // K,
            stream_ptr(a.device))
    check_launch(code, f"{sfx}_mont_mul")
    LAUNCHES[f"mont_mul_{sfx}"] += 1
    return out


def mont_sqr(spec: FieldSpec, a):
    """Batched Montgomery square a*a*R^-1 mod p on (K, *batch) limbs."""
    K = spec.num_limbs
    check_limbs(a, K, "mont_sqr: a")
    if not a.is_cuda:
        return mont_sqr_plain(spec, a)
    sfx = _suffix(spec)
    out = torch.empty_like(a)
    with torch.cuda.device(a.device):
        code = getattr(_lib(), f"{sfx}_mont_sqr")(
            a.data_ptr(), out.data_ptr(), a.numel() // K, stream_ptr(a.device))
    check_launch(code, f"{sfx}_mont_sqr")
    LAUNCHES[f"mont_sqr_{sfx}"] += 1
    return out
