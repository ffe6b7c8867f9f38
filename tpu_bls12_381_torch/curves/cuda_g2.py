"""Fused G2 group-law CUDA kernels, with their plain versions beside them.

Counterpart of the JAX package's ``curves/pallas_g2.py``:

* ``pmadd2`` / ``pmadd2_rows`` take the place of ``_pmadd2_kernel`` /
  ``pmadd2`` (``curves/pallas_g2.py:179``, ``:298``): RCB16 algorithm 8 over
  Fq2 (Karatsuba products, 3b' = 12(1+u)), y2 negated per lane where
  ``sign``, P passed through where ``inf2``;
* ``padd2`` takes the place of ``_padd2_kernel`` / ``padd2`` (``:201``,
  ``:315``): RCB16 algorithm 7 over Fq2; ``padd2_scan`` is the same addition
  scanned along the last axis (the G2 MSM tail's lane scans, which the JAX
  package runs as log2(L) Hillis-Steele steps of ``padd2``), as
  ``cuda_g1.padd_scan`` is for G1;
* ``pdbl2`` takes the place of ``_pdbl2_kernel`` / ``pdbl2`` (``:219``,
  ``:327``): RCB16 algorithm 9 over Fq2 with complex squaring, with a count
  ``times``: one launch doubles every lane ``times`` times in registers, where
  the JAX package's ``_double_n`` runs a ``fori_loop`` of launches
  (``projective.proj_double_n_fast`` routes the G2 MSM's doubling chains to
  it).

The kernels are CUDA C++ in ``csrc/g2_pmadd.cu``, ``csrc/g2_padd.cu``,
``csrc/g2_padd_scan.cu`` and ``csrc/g2_pdbl.cu`` (formulas in ``csrc/g2.cuh``
and, for ``pmadd2``, ``csrc/g2_pair.cuh``; the lane scan's passes in
``csrc/lane_scan.cuh``), all on the carry-chain Fq product of
``csrc/field_carry.cuh``.  ``pmadd2`` runs a lane on two threads, each holding
one component of every Fq2 value, so that a 72-word point and the formula's
temporaries fit (a launch is 2 L threads); the others run one thread a lane,
their products ordered so that operands die early.  ``pmadd2_rows`` is the
looped form, as ``cuda_g1.pmadd_signed_rows``: one launch walks the R rows of
a scan tile and writes every prefix row.  On an H100 the integer pipe bounds
the wide launches (33 to 36 Fq products a lane against 1,152 to 1,728 bytes,
22 a doubling against 576 bytes a chain); the launches on few lanes, the lane
scan's among them, are bound by latency (PERF.md has the numbers, registers
and spill).

An Fq2 coordinate is one ``(24, 2, *batch)`` int32 tensor (limbs, then the
component, then the batch: ``curves/field_adapters.py``).  The kernel gets
one pointer per coordinate: the c0 and c1 planes of a limb are ``n`` slots
apart and a limb's planes ``2n``, with ``n`` the number of lanes, which is
what a contiguous tensor of that shape gives; ``_check_coords`` holds every
operand to it.

Each wrapper takes its plain version (``*_plain``: the formulas of
``curves/projective.py`` over ``FQ2_PLAIN``; ``padd2_scan_plain``, the scan
kernel's association, ``cuda_g1.lane_scan_plain``) only for tensors on the
CPU.  For CUDA tensors it launches the kernel or raises; there is no
fallback.  The wrappers copy nothing: coordinates must be contiguous and of
one shape, masks contiguous, and anything else raises (the ``*_fast``
routers of ``curves/projective.py`` broadcast and lay out for them).
``LAUNCHES`` counts kernel launches, and nothing else; ``SCAN_LAUNCHES``
splits ``padd2_scan``'s by mode and shape, ``CHAIN_LAUNCHES`` ``pdbl2``'s by
the doublings ``times`` a launch made.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..fields import FQ
from ..fields.cuda_ops import check_launch, check_limbs, stream_ptr
from . import projective as pj
from .cuda_g1 import (SCAN_RUN, _check_mask, lane_scan_plain, launch_scan, scan_mode,
                      scan_threads_checked)
from .field_adapters import FQ2_PLAIN

K = FQ.num_limbs

LAUNCHES = {"pmadd2": 0, "padd2": 0, "pdbl2": 0, "padd2_scan": 0}
# padd2_scan's launches by what each call scanned: (mode, shape) -> launches,
# mode one of cuda_g1.scan_mode's names, shape the coordinates' (24, 2, *batch, L).
SCAN_LAUNCHES = {}
# pdbl2's launches by chain length: times -> launches (the doublings are
# the sum of times * launches).
CHAIN_LAUNCHES = {}

_PTR = ctypes.c_void_p
_ARGTYPES = {
    "g2_pmadd": ([_PTR] * 5 + [ctypes.c_longlong] + [_PTR] * 5
                 + [ctypes.c_longlong, ctypes.c_int, _PTR]),
    "g2_padd": [_PTR] * 9 + [ctypes.c_longlong, _PTR],
    "g2_pdbl": [_PTR] * 6 + [ctypes.c_longlong, ctypes.c_int, _PTR],
    "g2_padd_scan": [_PTR] * 15 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [_PTR],
}
# The libraries this module loads (``_build.library``): one a kernel.
LIBRARIES = tuple(_ARGTYPES)
_ENTRIES: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SCAN_LAUNCHES.clear()
    CHAIN_LAUNCHES.clear()


def _entry(name: str):
    """The C entry point ``name`` of ``csrc/<name>.cu`` (one source and one
    library a kernel), built and loaded on first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(_build.library(name), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


# -----------------------------------------------------------------------------
# Plain versions
# -----------------------------------------------------------------------------


def pmadd2_plain(P, A, sign=None):
    if sign is None:
        return pj.proj_add_mixed(FQ2_PLAIN, P, A)
    return pj.proj_add_mixed_signed(FQ2_PLAIN, P, A, sign)


def pmadd2_rows_plain(x_rows, y_rows, sign_rows, inf_rows):
    """Row scan by R plain signed mixed adds from the identity."""
    return pj.proj_scan_rows(FQ2_PLAIN, x_rows, y_rows, sign_rows, inf_rows)


def padd2_plain(P, Q):
    return pj.proj_add(FQ2_PLAIN, P, Q)


def padd2_scan_plain(P, *, reverse=False, exclusive=False, total=False,
                     run=SCAN_RUN, threads=None):
    """The lane scan of ``padd2_scan`` in the kernel's association, over plain
    G2 additions (``cuda_g1.lane_scan_plain``)."""
    return lane_scan_plain(FQ2_PLAIN, P, reverse=reverse, exclusive=exclusive,
                           total=total, run=run, threads=threads)


def pdbl2_plain(P, times: int = 1):
    """``times`` plain doublings in a row."""
    for _ in range(times):
        P = pj.proj_double(FQ2_PLAIN, P)
    return P


# -----------------------------------------------------------------------------
# Checks
# -----------------------------------------------------------------------------


def _check_coords(ts, name: str):
    """Raise unless the coordinates are contiguous int32 (24, 2, *batch)
    tensors of one shape on one device; returns the batch shape."""
    for i, t in enumerate(ts):
        check_limbs(t, K, f"{name}: coordinate {i}")
        if t.dim() < 2 or t.shape[1] != 2:
            raise ValueError(
                f"{name}: coordinate {i} must be ({K}, 2, *batch), got "
                f"{tuple(t.shape)}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: coordinates on different devices")
        if t.shape != ts[0].shape:
            raise ValueError(
                f"{name}: coordinate {i} has shape {tuple(t.shape)}, "
                f"coordinate 0 has {tuple(ts[0].shape)}")
    return tuple(ts[0].shape[2:])


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------


def pmadd2(P, A, sign=None):
    """Projective + (+-affine) addition over Fq2, elementwise: adds A where
    ``sign`` is False (or None), -A where True; lanes with ``inf2`` return P.
    The kernel always takes a sign: None becomes zeros, as in the JAX
    package."""
    x2, y2, inf2 = A
    coords = [*P, x2, y2]
    batch = _check_coords(coords, "pmadd2")
    dev = P[0].device
    _check_mask(inf2, batch, dev, "pmadd2: inf2")
    if sign is not None:
        _check_mask(sign, batch, dev, "pmadd2: sign")
    if not P[0].is_cuda:
        return pmadd2_plain(P, A, sign)
    if sign is None:
        sign = torch.zeros_like(inf2)
    n = P[0].numel() // (2 * K)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _entry("g2_pmadd")(
            *[t.data_ptr() for t in coords], 2 * K * n,
            inf2.data_ptr(), sign.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            n, 1, stream_ptr(dev))
    check_launch(code, "g2_pmadd")
    LAUNCHES["pmadd2"] += 1
    return tuple(out)


def pmadd2_rows(x_rows, y_rows, sign_rows, inf_rows):
    """The scan: per lane, R dependent signed mixed adds from the identity.

    ``x_rows`` / ``y_rows``: (R, 24, 2, L) int32, each row's (24, 2, L) block
    contiguous; the rows may be strided, by the same stride in both (two
    halves of one (R, 96, L) tile).
    ``sign_rows`` / ``inf_rows``: (R, L) bool.  Returns the inclusive prefix
    rows, three (R, 24, 2, L) tensors; row R-1 holds the column totals.
    """
    for t, name in ((x_rows, "x_rows"), (y_rows, "y_rows")):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"pmadd2_rows: {name} must be an int32 tensor")
        if t.dim() != 4 or tuple(t.shape[1:3]) != (K, 2):
            raise ValueError(
                f"pmadd2_rows: {name} must be (R, {K}, 2, L), got "
                f"{tuple(t.shape)}")
    if x_rows.shape != y_rows.shape or x_rows.device != y_rows.device:
        raise ValueError("pmadd2_rows: x_rows and y_rows differ")
    R, L = x_rows.shape[0], x_rows.shape[3]
    dev = x_rows.device
    _check_mask(sign_rows, (R, L), dev, "pmadd2_rows: sign_rows")
    _check_mask(inf_rows, (R, L), dev, "pmadd2_rows: inf_rows")
    row_stride = x_rows.stride(0) if R > 1 else 2 * K * L
    for t, name in ((x_rows, "x_rows"), (y_rows, "y_rows")):
        if not (t.stride(3) == 1 and t.stride(2) == L and t.stride(1) == 2 * L
                and (R == 1 or t.stride(0) == row_stride >= 2 * K * L)):
            raise ValueError(
                f"pmadd2_rows: {name} must hold contiguous (24, 2, L) row "
                f"blocks at one row stride, got strides {tuple(t.stride())}")
    if not x_rows.is_cuda:
        return pmadd2_rows_plain(x_rows, y_rows, sign_rows, inf_rows)
    out = [torch.empty((R, K, 2, L), dtype=torch.int32, device=dev)
           for _ in range(3)]
    with torch.cuda.device(dev):
        code = _entry("g2_pmadd")(
            None, None, None,
            x_rows.data_ptr(), y_rows.data_ptr(), row_stride,
            inf_rows.data_ptr(), sign_rows.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            L, R, stream_ptr(dev))
    check_launch(code, "g2_pmadd")
    LAUNCHES["pmadd2"] += 1
    return tuple(out)


def padd2(P, Q):
    """Complete projective + projective addition over Fq2."""
    coords = [*P, *Q]
    _check_coords(coords, "padd2")
    if not P[0].is_cuda:
        return padd2_plain(P, Q)
    dev = P[0].device
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _entry("g2_padd")(
            *[t.data_ptr() for t in coords], *[o.data_ptr() for o in out],
            P[0].numel() // (2 * K), stream_ptr(dev))
    check_launch(code, "g2_padd")
    LAUNCHES["padd2"] += 1
    return tuple(out)


def padd2_scan(P, *, reverse=False, exclusive=False, total=False,
               run=SCAN_RUN, threads=None):
    """Scan of complete projective additions over Fq2 along the last axis,
    with ``cuda_g1.padd_scan``'s modes and arguments: ``P`` coordinates
    (24, 2, *batch, L); a total is (24, 2, *batch).  Results are the sums by
    value; their limbs are those of ``padd2_scan_plain`` with the same run and
    threads.  Three launches (two for a total), whatever L is."""
    _check_coords(list(P), "padd2_scan")
    shape = tuple(P[0].shape)
    if len(shape) < 3 or shape[-1] < 1:
        raise ValueError(f"padd2_scan: need (24, 2, *batch, L) with L >= 1, got {shape}")
    threads = scan_threads_checked("padd2_scan", shape[-1], run, threads)
    if not P[0].is_cuda:
        return padd2_scan_plain(P, reverse=reverse, exclusive=exclusive, total=total,
                                run=run, threads=threads)
    out, n = launch_scan(_entry("g2_padd_scan"), "g2_padd_scan", P, (K, 2),
                         reverse=reverse, exclusive=exclusive, total=total, run=run,
                         threads=threads)
    LAUNCHES["padd2_scan"] += n
    key = (scan_mode(reverse, exclusive, total), shape)
    SCAN_LAUNCHES[key] = SCAN_LAUNCHES.get(key, 0) + n
    return out


def pdbl2(P, times: int = 1):
    """``times`` complete projective doublings over Fq2 of every lane,
    2^times P (``proj_double`` contract, applied ``times`` times): one
    launch, the chain in registers."""
    coords = list(P)
    _check_coords(coords, "pdbl2")
    times = int(times)
    if times < 1:
        raise ValueError(f"pdbl2: times must be >= 1, got {times}")
    if not P[0].is_cuda:
        return pdbl2_plain(P, times)
    dev = P[0].device
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _entry("g2_pdbl")(
            *[t.data_ptr() for t in coords], *[o.data_ptr() for o in out],
            P[0].numel() // (2 * K), times, stream_ptr(dev))
    check_launch(code, "g2_pdbl")
    LAUNCHES["pdbl2"] += 1
    CHAIN_LAUNCHES[times] = CHAIN_LAUNCHES.get(times, 0) + 1
    return tuple(out)


# The names the routers of curves/projective.py call, as in cuda_g1.
pmadd = pmadd2
pmadd_signed = pmadd2
pmadd_signed_rows = pmadd2_rows
padd = padd2
pdbl = pdbl2
