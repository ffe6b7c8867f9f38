"""Fused G1 group-law CUDA kernels, with their plain versions beside them.

Counterpart of the JAX package's ``curves/pallas_g1.py``:

* ``pmadd_signed`` / ``pmadd_signed_rows`` take the place of
  ``_pmadd_signed_kernel`` / ``pmadd_signed`` (``curves/pallas_g1.py:430``,
  ``:456``): RCB16 algorithm 8, y2 negated per lane where ``sign``, P passed
  through where ``inf2``;
* ``pmadd`` takes the place of ``_pmadd_kernel`` / ``pmadd`` (``:413``,
  ``:495``): algorithm 8 without the sign (``glv._glv_steps``, the routed
  loop, calls it);
* ``padd`` takes the place of ``_padd_kernel`` / ``padd`` (``:465``, ``:507``):
  RCB16 algorithm 7; ``padd_scan`` is the same addition scanned along the
  last axis (the MSM tail's lane scans, which the JAX package runs as
  log2(L) Hillis-Steele steps of ``padd``; its plain version,
  ``lane_scan_plain``, and its launch, ``launch_scan``, also serve G2's
  ``cuda_g2.padd2_scan``);
* ``pdbl`` takes the place of ``_pdbl_kernel`` / ``pdbl`` (``:478``, ``:519``):
  RCB16 algorithm 9, with a count ``times``: one launch doubles every lane
  ``times`` times in registers, where the JAX package's ``_double_n`` runs a
  ``fori_loop`` of launches (``projective.proj_double_n_fast`` routes the
  MSM's doubling chains to it);
* ``madd``, ``jadd`` and ``jdbl`` take the place of the Jacobian kernels
  ``_madd_kernel`` (``:180``), ``_add_kernel`` (``:252``) and ``_dbl_kernel``
  (``:156``) with their wrappers ``madd``, ``jadd``, ``jdbl``: madd-2007-bl,
  add-2007-bl and dbl-2009-l with the edge-case selections of
  ``curves/points.py``;
* ``jac_ladder`` takes the place of ``_dbl_kernel`` and ``_madd_kernel`` as
  the JAX package's ``points.scalar_mul`` (``curves/points.py:242``) runs
  them, a launch of each a bit: the whole double-and-add ladder in one
  launch, the accumulator in registers (``points.scalar_mul`` routes G1 on
  the card to it, hence ``is_in_subgroup``);
* ``glv_ladder`` takes the place of ``_pdbl_kernel`` and ``_pmadd_kernel`` as
  the JAX package's ``glv.scalar_mul_glv`` (``curves/glv.py:186``) runs them,
  a doubling and two mixed adds a bit: the whole joint GLV ladder in one
  launch, the accumulator in registers, constant time (both adds every bit,
  the selects masks; ``glv.scalar_mul_glv`` routes G1 on the card to it).

The kernels are CUDA C++: the projective ones in ``csrc/g1_kernels.cu``
(formulas in ``csrc/g1.cuh``), the Jacobian ones in ``csrc/g1_jac_kernels.cu``
(formulas in ``csrc/g1_jac.cuh``), field arithmetic in ``csrc/field.cuh``: one
thread per lane, all intermediates in registers.  ``pmadd_signed_rows`` is the looped form: one
launch walks the R rows of a scan tile inside each thread and writes every
prefix row, where the JAX package launches R times.  Every G1 kernel takes
the carry-chain Fq product of ``csrc/field_carry.cuh``.  On an H100 the integer
pipe bounds the wide launches (11 or 12 Fq products per lane against 480 to
864 bytes); the many launches on few lanes are bound by launch latency
(PERF.md has the numbers).

Each wrapper takes its plain version (``*_plain``: the formulas of
``curves/projective.py`` or ``curves/points.py`` over plain PyTorch field ops)
only for tensors on the CPU.  For CUDA tensors it launches the kernel or raises; there is no
fallback.  The wrappers copy nothing: coordinates must be contiguous and of
one shape, masks contiguous, and anything else raises (the ``*_fast`` routers
of ``curves/projective.py`` and ``curves/points.py`` broadcast and lay out
for them).  ``LAUNCHES``
counts kernel launches, and nothing else; ``SCAN_LAUNCHES`` splits the lane
scan's by mode and shape, ``CHAIN_LAUNCHES`` splits ``pdbl``'s by the
doublings ``times`` a launch made.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..fields import FQ
from ..fields.cuda_ops import check_launch, check_limbs, stream_ptr
from . import glv
from . import points as pt
from . import projective as pj
from .field_adapters import FQ_PLAIN

K = FQ.num_limbs
SCALAR_LIMBS = 16      # a scalar's 16-bit limbs, standard form (256 bits)

LAUNCHES = {"pmadd_signed": 0, "pmadd": 0, "padd": 0, "pdbl": 0,
            "madd": 0, "jadd": 0, "jdbl": 0, "padd_scan": 0, "jac_ladder": 0,
            "glv_ladder": 0}
# padd_scan's launches by what each call scanned: (mode, shape) -> launches,
# mode one of scan_mode's names, shape the coordinates' (24, *batch, L).
SCAN_LAUNCHES = {}
# pdbl's launches by chain length: times -> launches (the doublings are
# the sum of times * launches).
CHAIN_LAUNCHES = {}

# The lane scan's lanes a thread folds, and its most threads a block
# (SCAN_MAX_THREADS in csrc/lane_scan.cuh).
SCAN_RUN = 4
SCAN_MAX_THREADS = 128

_PTR = ctypes.c_void_p
# The libraries this module loads (``_build.library``): the MSM's and the
# Jacobian kernels'.
LIBRARY, JAC_LIBRARY = "g1_kernels", "g1_jac_kernels"
_CONFIGURED = False
_JAC_CONFIGURED = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    SCAN_LAUNCHES.clear()
    CHAIN_LAUNCHES.clear()


def scan_mode(reverse=False, exclusive=False, total=False) -> str:
    """A lane scan's mode by name: "total", or prefix/suffix and
    inclusive/exclusive ("prefix exclusive", ...)."""
    if total:
        return "total"
    return f"{'suffix' if reverse else 'prefix'} {'exclusive' if exclusive else 'inclusive'}"


def _lib():
    global _CONFIGURED
    lib = _build.library(LIBRARY)
    if not _CONFIGURED:
        lib.g1_pmadd_signed.argtypes = (
            [_PTR] * 5 + [ctypes.c_longlong] + [_PTR] * 5
            + [ctypes.c_longlong, ctypes.c_int, _PTR])
        lib.g1_padd_scan.argtypes = (
            [_PTR] * 15 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5 + [_PTR])
        lib.g1_pmadd.argtypes = [_PTR] * 9 + [ctypes.c_longlong, _PTR]
        lib.g1_padd.argtypes = [_PTR] * 9 + [ctypes.c_longlong, _PTR]
        lib.g1_pdbl.argtypes = [_PTR] * 6 + [ctypes.c_longlong, ctypes.c_int, _PTR]
        lib.g1_glv_ladder.argtypes = (
            [_PTR] * 2 + [ctypes.c_int] + [_PTR] * 7
            + [ctypes.c_longlong, ctypes.c_int, _PTR])
        for fn in (lib.g1_pmadd_signed, lib.g1_pmadd, lib.g1_padd,
                   lib.g1_pdbl, lib.g1_padd_scan, lib.g1_glv_ladder):
            fn.restype = ctypes.c_int
        _CONFIGURED = True
    return lib


def _jac_lib():
    global _JAC_CONFIGURED
    lib = _build.library(JAC_LIBRARY)
    if not _JAC_CONFIGURED:
        lib.g1_madd.argtypes = [_PTR] * 9 + [ctypes.c_longlong, _PTR]
        lib.g1_jadd.argtypes = [_PTR] * 9 + [ctypes.c_longlong, _PTR]
        lib.g1_jdbl.argtypes = [_PTR] * 6 + [ctypes.c_longlong, _PTR]
        lib.g1_jac_ladder.argtypes = (
            [_PTR] + [ctypes.c_longlong] * 2 + [_PTR] * 6
            + [ctypes.c_longlong, ctypes.c_int, _PTR])
        for fn in (lib.g1_madd, lib.g1_jadd, lib.g1_jdbl, lib.g1_jac_ladder):
            fn.restype = ctypes.c_int
        _JAC_CONFIGURED = True
    return lib


# -----------------------------------------------------------------------------
# Plain versions
# -----------------------------------------------------------------------------


def pmadd_signed_plain(P, A, sign):
    return pj.proj_add_mixed_signed(FQ_PLAIN, P, A, sign)


def pmadd_signed_rows_plain(x_rows, y_rows, sign_rows, inf_rows):
    """Row scan by R plain signed mixed adds from the identity."""
    return pj.proj_scan_rows(FQ_PLAIN, x_rows, y_rows, sign_rows, inf_rows)


def pmadd_plain(P, A):
    return pj.proj_add_mixed(FQ_PLAIN, P, A)


def padd_plain(P, Q):
    return pj.proj_add(FQ_PLAIN, P, Q)


def pdbl_plain(P, times: int = 1):
    """``times`` plain doublings in a row."""
    for _ in range(times):
        P = pj.proj_double(FQ_PLAIN, P)
    return P


def scan_threads(L: int, run: int = SCAN_RUN) -> int:
    """Threads a block of the lane scan for L lanes at ``run`` a thread: a
    power of two, as few as hold the lanes, at most SCAN_MAX_THREADS."""
    need = -(-L // run)
    return min(SCAN_MAX_THREADS, 1 << max(need - 1, 0).bit_length())


def scan_geometry(L: int, run: int, threads: int):
    """(blocks a row, threads of the carry pass, its run) of the lane scan."""
    nblk = -(-L // (run * threads))
    threads2 = min(SCAN_MAX_THREADS, 1 << max(nblk - 1, 0).bit_length())
    return nblk, threads2, -(-nblk // threads2)


def _lanes(P, idx):
    return tuple(c[..., idx] for c in P)


def _fold(F, P, valid):
    """Fold the last axis from its first slot, ((p0 + p1) + p2) + ..., over
    the slots ``valid`` (a mask of them) keeps; a fold of none is the
    identity."""
    ident = _identity_like(F, P, 1)
    acc = pj.proj_cmov(F, valid[..., 0], _lanes(P, 0), tuple(c[..., 0] for c in ident))
    for j in range(1, P[0].shape[-1]):
        acc = pj.proj_cmov(F, valid[..., j], pj.proj_add(F, acc, _lanes(P, j)), acc)
    return acc


def _block_scan(F, P):
    """Inclusive Hillis-Steele scan along the last axis: at step s, slot t
    takes (slot t - s) + (slot t) of the step before."""
    T = P[0].shape[-1]
    s = 1
    while s < T:
        head = pj.proj_add(F, _lanes(P, slice(0, T - s)), _lanes(P, slice(s, T)))
        P = tuple(torch.cat([c[..., :s], h], dim=-1) for c, h in zip(P, head))
        s <<= 1
    return P


def _walk(F, acc, P, exclusive: bool):
    """From ``acc``, add the last axis's slots in order; every slot's sum
    (before its add where ``exclusive``) stacked on the last axis."""
    outs = []
    for j in range(P[0].shape[-1]):
        nxt = pj.proj_add(F, acc, _lanes(P, j))
        outs.append(acc if exclusive else nxt)
        acc = nxt
    return tuple(torch.stack([o[c] for o in outs], dim=-1) for c in range(3))


def _identity_like(F, P, lanes: int):
    return pj.proj_identity(F, F.batch_shape(P[0])[:-1] + (lanes,), P[0].device)


def _pad_last(F, P, length: int):
    pad = length - P[0].shape[-1]
    if pad == 0:
        return P
    return tuple(torch.cat([c, i], dim=-1)
                 for c, i in zip(P, _identity_like(F, P, pad)))


def lane_scan_plain(F, P, *, reverse=False, exclusive=False, total=False,
                    run=SCAN_RUN, threads=None):
    """The lane scan of the scan kernels (``padd_scan``, and
    ``cuda_g2.padd2_scan`` over Fq2) in their association: the same runs,
    blocks and carries (``csrc/lane_scan.cuh``), over the plain additions of
    adapter ``F`` (``FQ_PLAIN`` or ``FQ2_PLAIN``)."""
    L = P[0].shape[-1]
    threads = threads or scan_threads(L, run)
    nblk, threads2, run2 = scan_geometry(L, run, threads)
    x = tuple(c.flip(-1) for c in P) if reverse else P
    x = _pad_last(F, x, nblk * threads * run)
    x = tuple(c.unflatten(-1, (nblk, threads, run)) for c in x)
    lane = torch.arange(nblk * threads * run, device=P[0].device)
    v = _block_scan(F, _fold(F, x, (lane < L).reshape(nblk, threads, run)))   # up
    tot = _pad_last(F, _lanes(v, threads - 1), threads2 * run2)             # carry
    tot = tuple(c.unflatten(-1, (threads2, run2)) for c in tot)
    block = torch.arange(threads2 * run2, device=P[0].device)
    w = _block_scan(F, _fold(F, tot, (block < nblk).reshape(threads2, run2)))
    if total:
        return _lanes(w, threads2 - 1)
    before = lambda T: tuple(torch.cat([i, c[..., :-1]], dim=-1)
                             for i, c in zip(_identity_like(F, T, 1), T))
    carry = tuple(c.flatten(-2)[..., :nblk] for c in _walk(F, before(w), tot, True))
    v_before = before(v)
    cin = pj.proj_add(F, tuple(c.unsqueeze(-1).expand(t.shape).contiguous()
                               for c, t in zip(carry, v_before)), v_before)
    out = tuple(c.flatten(-3)[..., :L] for c in _walk(F, cin, x, exclusive))
    return tuple((c.flip(-1) if reverse else c).contiguous() for c in out)


def padd_scan_plain(P, *, reverse=False, exclusive=False, total=False,
                    run=SCAN_RUN, threads=None):
    """The lane scan of ``padd_scan`` in the kernel's association, over plain
    G1 additions (``lane_scan_plain``)."""
    return lane_scan_plain(FQ_PLAIN, P, reverse=reverse, exclusive=exclusive,
                           total=total, run=run, threads=threads)


def madd_plain(P, A):
    return pt.jac_add_affine(FQ_PLAIN, P, A)


def jadd_plain(P, Q):
    return pt.jac_add(FQ_PLAIN, P, Q)


def jdbl_plain(P):
    return pt.jac_double(FQ_PLAIN, P)


def jac_ladder_plain(scalars, A, num_bits: int = 255):
    """scalars * A by the ladder of ``points.scalar_mul`` in plain steps:
    from the identity, MSB first, per bit ``jdbl_plain``, ``madd_plain`` and
    the select of the sum where the lane's bit is set (constant time: every
    step computes the add).  ``scalars``: (16, *batch) limbs, or one
    (16, 1, ...) column for every lane."""
    acc = pt.jac_identity(FQ_PLAIN, FQ_PLAIN.batch_shape(A[0]), A[0].device)
    for b in range(num_bits - 1, -1, -1):
        bit = ((scalars[b // 16] >> (b % 16)) & 1).bool()
        acc = jdbl_plain(acc)
        acc = pt.jac_cmov(FQ_PLAIN, bit, madd_plain(acc, A), acc)
    return acc


def glv_ladder_plain(k1, k2, A, phi_x, num_bits: int = glv.GLV_HALF_BITS):
    """k1 * A + k2 * phi(A) by ``glv.scalar_mul_glv``'s joint loop
    (``glv._glv_steps``) over ``FQ_PLAIN``'s projective formulas, phi(A) =
    (``phi_x``, y, inf); the bits of ``k2`` above its limbs read 0.  Returns
    the projective batch."""
    return glv._glv_steps(FQ_PLAIN, k1, k2, A, (phi_x, A[1], A[2]), num_bits)


# -----------------------------------------------------------------------------
# Checks and shapes
# -----------------------------------------------------------------------------


def _check_coords(ts, name: str):
    """Raise unless the coordinates are contiguous int32 (24, *batch) limbs
    of one shape on one device; returns the batch shape."""
    for i, t in enumerate(ts):
        check_limbs(t, K, f"{name}: coordinate {i}")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: coordinates on different devices")
        if t.shape != ts[0].shape:
            raise ValueError(
                f"{name}: coordinate {i} has shape {tuple(t.shape)}, "
                f"coordinate 0 has {tuple(ts[0].shape)}")
    return tuple(ts[0].shape[1:])


def _check_mask(m, shape, device, name: str):
    if not isinstance(m, torch.Tensor) or m.dtype != torch.bool:
        raise TypeError(f"{name}: expected a bool tensor")
    if tuple(m.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(m.shape)}")
    if m.device != device:
        raise ValueError(f"{name}: mask on a different device")
    if not m.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous mask")


# -----------------------------------------------------------------------------
# Wrappers
# -----------------------------------------------------------------------------


def pmadd_signed(P, A, sign):
    """Projective + (+-affine) addition, elementwise: adds A where ``sign`` is
    False, -A where True; lanes with ``inf2`` return P."""
    x2, y2, inf2 = A
    coords = [*P, x2, y2]
    batch = _check_coords(coords, "pmadd_signed")
    dev = P[0].device
    _check_mask(inf2, batch, dev, "pmadd_signed: inf2")
    _check_mask(sign, batch, dev, "pmadd_signed: sign")
    if not P[0].is_cuda:
        return pmadd_signed_plain(P, A, sign)
    n = P[0].numel() // K
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _lib().g1_pmadd_signed(
            *[t.data_ptr() for t in coords], K * n,
            inf2.data_ptr(), sign.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            n, 1, stream_ptr(dev))
    check_launch(code, "g1_pmadd_signed")
    LAUNCHES["pmadd_signed"] += 1
    return tuple(out)


def pmadd_signed_rows(x_rows, y_rows, sign_rows, inf_rows):
    """The scan: per lane, R dependent signed mixed adds from the identity.

    ``x_rows`` / ``y_rows``: (R, 24, L) int32, each row's (24, L) block
    contiguous; the rows may be strided, by the same stride in both (two
    halves of one (R, 48, L) tile).
    ``sign_rows`` / ``inf_rows``: (R, L) bool.  Returns the inclusive prefix
    rows, three (R, 24, L) tensors; row R-1 holds the column totals.
    """
    for t, name in ((x_rows, "x_rows"), (y_rows, "y_rows")):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError(f"pmadd_signed_rows: {name} must be an int32 tensor")
        if t.dim() != 3 or t.shape[1] != K:
            raise ValueError(
                f"pmadd_signed_rows: {name} must be (R, {K}, L), got "
                f"{tuple(t.shape)}")
    if x_rows.shape != y_rows.shape or x_rows.device != y_rows.device:
        raise ValueError("pmadd_signed_rows: x_rows and y_rows differ")
    R, _, L = x_rows.shape
    dev = x_rows.device
    _check_mask(sign_rows, (R, L), dev, "pmadd_signed_rows: sign_rows")
    _check_mask(inf_rows, (R, L), dev, "pmadd_signed_rows: inf_rows")
    row_stride = x_rows.stride(0) if R > 1 else K * L
    for t, name in ((x_rows, "x_rows"), (y_rows, "y_rows")):
        if not (t.stride(2) == 1 and t.stride(1) == L and (
                R == 1 or t.stride(0) == row_stride >= K * L)):
            raise ValueError(
                f"pmadd_signed_rows: {name} must hold contiguous (24, L) "
                f"row blocks at one row stride, got strides "
                f"{tuple(t.stride())}")
    if not x_rows.is_cuda:
        return pmadd_signed_rows_plain(x_rows, y_rows, sign_rows, inf_rows)
    out = [torch.empty((R, K, L), dtype=torch.int32, device=dev)
           for _ in range(3)]
    with torch.cuda.device(dev):
        code = _lib().g1_pmadd_signed(
            None, None, None,
            x_rows.data_ptr(), y_rows.data_ptr(), row_stride,
            inf_rows.data_ptr(), sign_rows.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            L, R, stream_ptr(dev))
    check_launch(code, "g1_pmadd_signed")
    LAUNCHES["pmadd_signed"] += 1
    return tuple(out)


def pmadd(P, A):
    """Projective + affine addition, elementwise; lanes with ``inf2`` return
    P (``proj_add_mixed`` contract)."""
    x2, y2, inf2 = A
    coords = [*P, x2, y2]
    batch = _check_coords(coords, "pmadd")
    dev = P[0].device
    _check_mask(inf2, batch, dev, "pmadd: inf2")
    if not P[0].is_cuda:
        return pmadd_plain(P, A)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _lib().g1_pmadd(
            *[t.data_ptr() for t in coords], inf2.data_ptr(),
            *[o.data_ptr() for o in out], P[0].numel() // K, stream_ptr(dev))
    check_launch(code, "g1_pmadd")
    LAUNCHES["pmadd"] += 1
    return tuple(out)


def padd(P, Q):
    """Complete projective + projective addition (``proj_add`` contract)."""
    coords = [*P, *Q]
    _check_coords(coords, "padd")
    if not P[0].is_cuda:
        return padd_plain(P, Q)
    dev = P[0].device
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _lib().g1_padd(
            *[t.data_ptr() for t in coords], *[o.data_ptr() for o in out],
            P[0].numel() // K, stream_ptr(dev))
    check_launch(code, "g1_padd")
    LAUNCHES["padd"] += 1
    return tuple(out)


def scan_threads_checked(name: str, L: int, run: int, threads):
    """The lane scan's threads a block (None: ``scan_threads``); raises
    unless the run is at least 1 and the threads a power of two up to
    SCAN_MAX_THREADS."""
    threads = threads or scan_threads(L, run)
    if run < 1 or threads & (threads - 1) or not 1 <= threads <= SCAN_MAX_THREADS:
        raise ValueError(f"{name}: run {run} must be >= 1 and threads {threads} "
                         f"a power of two up to {SCAN_MAX_THREADS}")
    return threads


def launch_scan(entry, name: str, P, elem: tuple, *, reverse, exclusive, total,
                run, threads):
    """A lane scan's passes on the card: ``entry`` is ``g1_padd_scan`` or
    ``g2_padd_scan`` (one C signature), ``P`` the coordinates
    (*elem, *batch, L), contiguous.  Allocates the scratch and the output
    (the scan's shape, or (*elem, *batch) for a total); returns the output and
    the launches made (3, or 2 for a total)."""
    shape = tuple(P[0].shape)
    L = shape[-1]
    rows = math.prod(shape[len(elem):-1])
    nblk, threads2, _ = scan_geometry(L, run, threads)
    if rows > 65535 or rows * nblk * threads * run >= 1 << 31:
        raise ValueError(f"{name}: {rows} rows of {L} lanes, the kernel takes at "
                         f"most 65535 rows and 2^31 lanes")
    dev = P[0].device
    new = lambda *dims: [torch.empty(elem + dims, dtype=torch.int32, device=dev)
                         for _ in range(3)]
    V, C = new(rows, nblk * threads), new(rows, nblk)
    out = (new(*shape[len(elem):-1]) if total
           else [torch.empty_like(P[0]) for _ in range(3)])
    O, S = ([None] * 3, out) if total else (out, [None] * 3)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        code = entry(*[ptr(t) for t in (*P, *O, *S, *V, *C)], rows, L, run, threads,
                     threads2, int(reverse), int(exclusive), stream_ptr(dev))
    check_launch(code, name)
    return tuple(out), 2 if total else 3


def padd_scan(P, *, reverse=False, exclusive=False, total=False,
              run=SCAN_RUN, threads=None):
    """Scan of complete projective additions along the last axis.

    ``P``: coordinates (24, *batch, L), the batch rows independent.  Prefix
    sums, or suffix sums with ``reverse``; inclusive, or exclusive (slot i
    without lane i itself, the first slot the identity).  ``total``: only the
    row sums, coordinates (24, *batch).  ``run`` lanes a thread, ``threads``
    a block (None: ``scan_threads``).  Results are the sums by value; their
    limbs are those of ``padd_scan_plain`` with the same run and threads.
    Three launches (two for a total), whatever L is.
    """
    _check_coords(list(P), "padd_scan")
    shape = tuple(P[0].shape)
    if len(shape) < 2 or shape[-1] < 1:
        raise ValueError(f"padd_scan: need (24, *batch, L) with L >= 1, got {shape}")
    threads = scan_threads_checked("padd_scan", shape[-1], run, threads)
    if not P[0].is_cuda:
        return padd_scan_plain(P, reverse=reverse, exclusive=exclusive, total=total,
                               run=run, threads=threads)
    out, n = launch_scan(_lib().g1_padd_scan, "g1_padd_scan", P, (K,), reverse=reverse,
                         exclusive=exclusive, total=total, run=run, threads=threads)
    LAUNCHES["padd_scan"] += n
    key = (scan_mode(reverse, exclusive, total), shape)
    SCAN_LAUNCHES[key] = SCAN_LAUNCHES.get(key, 0) + n
    return out


def pdbl(P, times: int = 1):
    """``times`` complete projective doublings of every lane, 2^times P
    (``proj_double`` contract, applied ``times`` times): one launch, the
    chain in registers."""
    coords = list(P)
    _check_coords(coords, "pdbl")
    times = int(times)
    if times < 1:
        raise ValueError(f"pdbl: times must be >= 1, got {times}")
    if not P[0].is_cuda:
        return pdbl_plain(P, times)
    dev = P[0].device
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _lib().g1_pdbl(
            *[t.data_ptr() for t in coords], *[o.data_ptr() for o in out],
            P[0].numel() // K, times, stream_ptr(dev))
    check_launch(code, "g1_pdbl")
    LAUNCHES["pdbl"] += 1
    CHAIN_LAUNCHES[times] = CHAIN_LAUNCHES.get(times, 0) + 1
    return tuple(out)


# -----------------------------------------------------------------------------
# Jacobian wrappers (csrc/g1_jac_kernels.cu)
# -----------------------------------------------------------------------------


def madd(P, A):
    """Jacobian + affine addition, elementwise, complete: the doubling where
    P == A, the identity where P == -A, A where P is the identity, P where
    ``inf2`` (``points.jac_add_affine`` contract)."""
    x2, y2, inf2 = A
    coords = [*P, x2, y2]
    batch = _check_coords(coords, "madd")
    dev = P[0].device
    _check_mask(inf2, batch, dev, "madd: inf2")
    if not P[0].is_cuda:
        return madd_plain(P, A)
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _jac_lib().g1_madd(
            *[t.data_ptr() for t in coords], inf2.data_ptr(),
            *[o.data_ptr() for o in out], P[0].numel() // K, stream_ptr(dev))
    check_launch(code, "g1_madd")
    LAUNCHES["madd"] += 1
    return tuple(out)


def jadd(P, Q):
    """Complete Jacobian + Jacobian addition (``points.jac_add`` contract)."""
    coords = [*P, *Q]
    _check_coords(coords, "jadd")
    if not P[0].is_cuda:
        return jadd_plain(P, Q)
    dev = P[0].device
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _jac_lib().g1_jadd(
            *[t.data_ptr() for t in coords], *[o.data_ptr() for o in out],
            P[0].numel() // K, stream_ptr(dev))
    check_launch(code, "g1_jadd")
    LAUNCHES["jadd"] += 1
    return tuple(out)


def jdbl(P):
    """Jacobian doubling, complete for Z = 0 (``points.jac_double``
    contract)."""
    coords = list(P)
    _check_coords(coords, "jdbl")
    if not P[0].is_cuda:
        return jdbl_plain(P)
    dev = P[0].device
    out = [torch.empty_like(P[0]) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _jac_lib().g1_jdbl(
            *[t.data_ptr() for t in coords], *[o.data_ptr() for o in out],
            P[0].numel() // K, stream_ptr(dev))
    check_launch(code, "g1_jdbl")
    LAUNCHES["jdbl"] += 1
    return tuple(out)


def jac_ladder(scalars, A, num_bits: int = 255):
    """``scalars * A`` lane by lane (the ``points.scalar_mul`` contract): the
    double-and-add ladder over the low ``num_bits`` bits, MSB first, in one
    launch.  ``A``: affine (x, y, inf), contiguous (24, *batch) coordinates
    and a (*batch) mask.  ``scalars``: contiguous int32 (16, *batch) 16-bit
    limbs in standard form, or one contiguous (16, 1, ...) column that every
    lane reads (a lane stride of 0: ``is_in_subgroup``'s r, never copied out
    to the batch).  Returns a Jacobian batch.  A warp in which no lane has a
    bit skips that bit's add: the time, not the value, depends on the bits."""
    x2, y2, inf2 = A
    batch = _check_coords([x2, y2], "jac_ladder")
    dev = x2.device
    _check_mask(inf2, batch, dev, "jac_ladder: inf2")
    check_limbs(scalars, SCALAR_LIMBS, "jac_ladder: scalars")
    if scalars.device != dev:
        raise ValueError("jac_ladder: scalars on a different device")
    if tuple(scalars.shape[1:]) == batch:
        lane_stride = 1
    elif scalars.dim() == 1 + len(batch) and scalars.numel() == SCALAR_LIMBS:
        lane_stride = 0
    else:
        raise ValueError(
            f"jac_ladder: scalars of shape {tuple(scalars.shape)}: expected "
            f"({SCALAR_LIMBS}, *{batch}) or one ({SCALAR_LIMBS}, 1, ...) column")
    num_bits = int(num_bits)
    if not 1 <= num_bits <= 16 * SCALAR_LIMBS:
        raise ValueError(f"jac_ladder: num_bits must be 1 to {16 * SCALAR_LIMBS}, "
                         f"got {num_bits}")
    if not x2.is_cuda:
        return jac_ladder_plain(scalars, A, num_bits)
    n = x2.numel() // K
    out = [torch.empty_like(x2) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _jac_lib().g1_jac_ladder(
            scalars.data_ptr(), n if lane_stride else 1, lane_stride,
            x2.data_ptr(), y2.data_ptr(), inf2.data_ptr(),
            *[o.data_ptr() for o in out], n, num_bits, stream_ptr(dev))
    check_launch(code, "g1_jac_ladder")
    LAUNCHES["jac_ladder"] += 1
    return tuple(out)


def glv_ladder(k1, k2, A, phi_x, num_bits: int = glv.GLV_HALF_BITS):
    """``k1 * A + k2 * phi(A)`` lane by lane, phi(A) = (``phi_x``, y, inf)
    (``glv.scalar_mul_glv``'s joint double-and-add over the low ``num_bits``
    bits, MSB first) in one launch.  ``A``: affine (x, y, inf), contiguous
    (24, *batch) coordinates and a (*batch) mask; ``phi_x``: contiguous
    (24, *batch), beta x.  ``k1``: contiguous int32 (16, *batch) 16-bit limbs
    in standard form; ``k2``: contiguous int32 (k2_limbs, *batch) with 1 to
    16 limbs (``glv.decompose`` keeps 9), whose bits above its limbs read 0.
    Returns the projective batch.  Constant time: both adds run at every bit
    in every lane and the selects are masks."""
    x2, y2, inf2 = A
    batch = _check_coords([x2, y2, phi_x], "glv_ladder")
    dev = x2.device
    _check_mask(inf2, batch, dev, "glv_ladder: inf2")
    check_limbs(k1, SCALAR_LIMBS, "glv_ladder: k1")
    if not isinstance(k2, torch.Tensor) or k2.dim() < 1 or not 1 <= k2.shape[0] <= SCALAR_LIMBS:
        raise ValueError(f"glv_ladder: k2 must be (1 to {SCALAR_LIMBS}, *batch) limbs, got "
                         f"{tuple(k2.shape) if isinstance(k2, torch.Tensor) else type(k2)}")
    check_limbs(k2, k2.shape[0], "glv_ladder: k2")
    for k, name in ((k1, "k1"), (k2, "k2")):
        if k.device != dev:
            raise ValueError(f"glv_ladder: {name} on a different device")
        if tuple(k.shape[1:]) != batch:
            raise ValueError(f"glv_ladder: {name} of shape {tuple(k.shape)}: expected "
                             f"({k.shape[0]}, *{batch})")
    num_bits = int(num_bits)
    if not 1 <= num_bits <= 16 * SCALAR_LIMBS:
        raise ValueError(f"glv_ladder: num_bits must be 1 to {16 * SCALAR_LIMBS}, "
                         f"got {num_bits}")
    if not x2.is_cuda:
        return glv_ladder_plain(k1, k2, A, phi_x, num_bits)
    n = x2.numel() // K
    out = [torch.empty_like(x2) for _ in range(3)]
    with torch.cuda.device(dev):
        code = _lib().g1_glv_ladder(
            k1.data_ptr(), k2.data_ptr(), k2.shape[0], x2.data_ptr(), y2.data_ptr(),
            phi_x.data_ptr(), inf2.data_ptr(), *[o.data_ptr() for o in out], n,
            num_bits, stream_ptr(dev))
    check_launch(code, "g1_glv_ladder")
    LAUNCHES["glv_ladder"] += 1
    return tuple(out)
