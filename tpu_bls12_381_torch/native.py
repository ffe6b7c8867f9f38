"""ctypes loader for the repository's native host library (``native/convert.cpp``
and ``native/msm_host.cpp``).

Counterpart of the JAX package's ``native.py``: the same C ABI and the same
numpy entry points, with the port's own build.  On first use the two sources
are compiled with ``g++`` into the CUDA kernels' cache directory
(``_build.cache_dir()``: ``tpu_bls12_381_torch/_build/`` unless
``MIDNIGHT_AOT_CACHE_DIR`` or ``MIDNIGHT_AOT_CACHE=0`` say otherwise), keyed by
a hash of the sources and flags, so an edit rebuilds; nothing is written into
``native/``.  Where no compiler is present, or the build or the load fails,
:func:`available` is False and the callers take their host fallbacks (numpy
and Python integers in ``runtime/types.py``, the big-int oracle in
``runtime/dispatch.py``).  This is host code: the device path never runs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger("tpu_bls12_381_torch.native")

SRC_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("convert.cpp", "msm_host.cpp")
HEADERS = ("field64.h",)
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_LIB = None
_TRIED = False
_LOCK = threading.Lock()

FIELD_FQ = 0
FIELD_FR = 1


def _so_path() -> Path | None:
    from ._build import cache_dir

    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        p = SRC_DIR / name
        if not p.exists():
            return None
        h.update(name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return cache_dir() / f"libnative_host_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        logger.info("no host C++ compiler; using the numpy/oracle fallbacks")
        return False
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *[str(SRC_DIR / s) for s in SOURCES]]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        logger.info("native build failed (%s); using the numpy/oracle fallbacks", e)
        tmp.unlink(missing_ok=True)
        return False


def lib() -> ctypes.CDLL | None:
    """The loaded native library, built on first use; None if it cannot be."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _so_path()
        if so is None or (not so.exists() and not _build(so)):
            return None
        try:
            L = ctypes.CDLL(str(so))
        except OSError as e:
            logger.info("native load failed (%s); using the numpy/oracle fallbacks", e)
            return None
        u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        L.wire_to_limbs16.argtypes = [u64p, u32p, ctypes.c_size_t, ctypes.c_int]
        L.limbs16_to_wire.argtypes = [u32p, u64p, ctypes.c_size_t, ctypes.c_int]
        L.mont_encode_batch.argtypes = [u64p, u64p, ctypes.c_size_t, ctypes.c_int]
        L.mont_decode_batch.argtypes = [u64p, u64p, ctypes.c_size_t, ctypes.c_int]
        for fn in (L.g1_msm_host, L.g2_msm_host):
            fn.argtypes = [u64p, u64p, u8p, ctypes.c_size_t, u64p]
        L.native_abi_version.restype = ctypes.c_int
        if L.native_abi_version() != 1:
            logger.warning("native ABI mismatch; using the numpy/oracle fallbacks")
            return None
        _LIB = L
        return _LIB


def available() -> bool:
    return lib() is not None


def wire_to_limbs16(words: np.ndarray) -> np.ndarray:
    """(n, k64) uint64 -> (4*k64, n) uint32 limbs-first."""
    w = np.ascontiguousarray(words, dtype=np.uint64)
    n, k64 = w.shape
    out = np.empty((4 * k64, n), dtype=np.uint32)
    lib().wire_to_limbs16(w, out, n, k64)
    return out


def limbs16_to_wire(limbs: np.ndarray) -> np.ndarray:
    """(4*k64, n) uint32 -> (n, k64) uint64."""
    a = np.ascontiguousarray(limbs, dtype=np.uint32)
    k16, n = a.shape
    out = np.empty((n, k16 // 4), dtype=np.uint64)
    lib().limbs16_to_wire(a, out, n, k16 // 4)
    return out


def mont_encode(words: np.ndarray, field: int) -> np.ndarray:
    """(n, k64) standard-form words -> Montgomery-form words."""
    w = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty_like(w)
    lib().mont_encode_batch(w, out, w.shape[0], field)
    return out


def mont_decode(words: np.ndarray, field: int) -> np.ndarray:
    w = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty_like(w)
    lib().mont_decode_batch(w, out, w.shape[0], field)
    return out


# ---- host Pippenger MSM (native/msm_host.cpp) --------------------------------


def _ints_to_words(vals, k64: int) -> np.ndarray:
    out = np.zeros((len(vals), k64), dtype=np.uint64)
    mask = (1 << 64) - 1
    for i, v in enumerate(vals):
        for w in range(k64):
            out[i, w] = (v >> (64 * w)) & mask
    return out


def _words_to_int(words: np.ndarray) -> int:
    return sum(int(w) << (64 * j) for j, w in enumerate(words))


def msm_host(scalars, bases, curve: str = "g1"):
    """Host Pippenger MSM on int scalars / affine int bases (None = identity).

    G1 bases are (x, y) int pairs; G2 bases ((x0, x1), (y0, y1)) pairs.
    Returns the Jacobian int triple (``oracle.msm``'s contract).  Requires
    the native library; callers check :func:`available` first.
    """
    from .constants import FR_MODULUS

    L = lib()
    n = len(scalars)
    sc = _ints_to_words([s % FR_MODULUS for s in scalars], 4)
    inf = np.zeros(n, dtype=np.uint8)
    if curve == "g1":
        xy = np.zeros((n, 12), dtype=np.uint64)
        for i, b in enumerate(bases):
            if b is None:
                inf[i] = 1
            else:
                xy[i, :6] = _ints_to_words([b[0]], 6)[0]
                xy[i, 6:] = _ints_to_words([b[1]], 6)[0]
        out = np.zeros(18, dtype=np.uint64)
        L.g1_msm_host(np.ascontiguousarray(sc), xy.reshape(-1), inf, n, out)
        return tuple(_words_to_int(out[j * 6:(j + 1) * 6]) for j in range(3))
    xy = np.zeros((n, 24), dtype=np.uint64)
    for i, b in enumerate(bases):
        if b is None:
            inf[i] = 1
        else:
            (x0, x1), (y0, y1) = b
            for j, v in enumerate((x0, x1, y0, y1)):
                xy[i, j * 6:(j + 1) * 6] = _ints_to_words([v], 6)[0]
    out = np.zeros(36, dtype=np.uint64)
    L.g2_msm_host(np.ascontiguousarray(sc), xy.reshape(-1), inf, n, out)
    c = [_words_to_int(out[j * 6:(j + 1) * 6]) for j in range(6)]
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
