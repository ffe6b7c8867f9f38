"""The fused NTT tile kernel and the single-device Bailey four-step.

Counterpart of the JAX package's ``ntt/pallas_ntt.py``.  The radix-2 ladder
(``ntt.py::_butterflies``) streams the whole array through device memory once
per stage, log2(n) round trips.  ``ntt_tile`` computes a full size-m NTT (all
log2(m) stages) on every row of a (K, B, m) array inside a thread block's
shared memory, so a large NTT factored as n = nA * nB costs two such passes
plus transposes:

    X[k2 + nB*k1] = sum_a w_n^(a*k2) w_nA^(a*k1)
                    ( sum_b w_nB^(b*k2) x[a + nA*b] )

The inter-step twiddle multiply (w_n^(a*k2)) and the inverse's 1/n scale are
folded into the tile passes.

``ntt_tile`` takes the place of ``_ntt_tile_kernel_factory`` /
``_ntt_tile_call`` (``ntt/pallas_ntt.py:80``, ``:137``).  The kernel is CUDA
C++ in ``csrc/ntt_kernels.cu`` (device code in ``csrc/ntt.cuh``): a block
holds whole rows in shared memory, 32 bytes an element, and reads each
stage's twiddles from the domain's (K, m/2) table by stride, so the
(stages, K, m) table that the TPU kernel has packed for it does not exist
here.  On an H100 the integer pipe bounds a pass (PERF.md has the
reckoning).  The wrapper takes ``ntt_tile_plain`` only for CPU tensors; for
CUDA tensors it launches the kernel or raises.  It copies nothing.
``LAUNCHES`` counts kernel launches, and nothing else: ``ntt_tile_w`` those
with the table ``w`` folded in, ``ntt_tile`` those without.

The transposes, the bit-reverse gathers and the building of the twiddle table
W are plain torch ops around the kernel, as they are XLA's in the JAX package.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from .. import _build
from ..fields import FR, cuda_ops, fast, ops
from ..fields.cuda_ops import check_launch, check_limbs, stream_ptr
from ..oracle import root_of_unity
from ..runtime.tracing import stage
from ..tuning import chip_profile
from ..vecops import bit_reverse
from .domain import Domain, _powers_on_device, get_domain

K = FR.num_limbs

LAUNCHES = {"ntt_tile": 0, "ntt_tile_w": 0}

_PTR = ctypes.c_void_p
_CONFIGURED = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    global _CONFIGURED
    lib = _build.library("ntt_kernels")
    if not _CONFIGURED:
        lib.fr_ntt_tile.argtypes = (
            [_PTR] * 5 + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _PTR])
        lib.fr_ntt_tile.restype = ctypes.c_int
        _CONFIGURED = True
    return lib


def _cap_log(device) -> int:
    """log2 of the longest row the tile takes: what one block can hold in
    shared memory on ``device`` (``tuning.py``)."""
    return chip_profile(device).ntt_tile_log_cap


# -----------------------------------------------------------------------------
# The tile: plain version and kernel wrapper
# -----------------------------------------------------------------------------


def ntt_tile_plain(x, tw, w=None, scale=None):
    """Plain PyTorch version of the tile kernel: the ladder on every row, then
    the two optional multiplies."""
    B, m = x.shape[1], x.shape[2]
    half = 1
    while half < m:
        x = cuda_ops.butterfly_stage_plain(FR, x, tw, half)
        half *= 2
    if w is not None:
        Bw = w.shape[1]
        x = ops.mont_mul(FR, x.reshape(K, B // Bw, Bw, m), w[:, None])
        x = x.reshape(K, B, m)
    if scale is not None:
        x = ops.mont_mul(FR, x, scale[:, None, None])
    return x


def ntt_tile(x, tw, w=None, scale=None):
    """Size-m NTT of every row of ``x`` (K, B, m): bit-reversed rows in,
    natural rows out.

    ``tw`` is the (K, m/2) twiddle table of the size-m domain (forward or
    inverse).  Optionally the result is multiplied elementwise by ``w``
    (K, Bw, m), where B is a multiple of Bw and row r takes ``w[:, r % Bw]``
    (one period of the table serves a batch), and by the scalar ``scale``
    (K,).
    """
    check_limbs(x, K, "ntt_tile: x")
    if x.dim() != 3:
        raise ValueError(f"ntt_tile: expected x of shape ({K}, B, m), got "
                         f"{tuple(x.shape)}")
    B, m = x.shape[1], x.shape[2]
    log_m = m.bit_length() - 1
    cap_log = _cap_log(x.device)
    if m < 2 or 1 << log_m != m or log_m > cap_log:
        raise ValueError(f"ntt_tile: the row length must be a power of two in "
                         f"[2, 2^{cap_log}], got {m}")
    check_limbs(tw, K, "ntt_tile: tw")
    if tuple(tw.shape) != (K, m // 2):
        raise ValueError(f"ntt_tile: expected twiddles of shape ({K}, {m // 2}), "
                         f"got {tuple(tw.shape)}")
    Bw = 0
    if w is not None:
        check_limbs(w, K, "ntt_tile: w")
        if w.dim() != 3 or w.shape[2] != m or w.shape[1] < 1 or B % w.shape[1]:
            raise ValueError(f"ntt_tile: expected w of shape ({K}, Bw, {m}) with "
                             f"Bw dividing {B}, got {tuple(w.shape)}")
        Bw = w.shape[1]
    if scale is not None:
        check_limbs(scale, K, "ntt_tile: scale")
        if scale.dim() != 1:
            raise ValueError(f"ntt_tile: expected a scalar of shape ({K},), got "
                             f"{tuple(scale.shape)}")
    for name, t in (("tw", tw), ("w", w), ("scale", scale)):
        if t is not None and t.device != x.device:
            raise ValueError(f"ntt_tile: {name} is on {t.device}, x on {x.device}")
    if not x.is_cuda:
        return ntt_tile_plain(x, tw, w, scale)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _lib().fr_ntt_tile(
            x.data_ptr(), tw.data_ptr(),
            w.data_ptr() if w is not None else None,
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), B, Bw, log_m, stream_ptr(x.device))
    check_launch(code, "fr_ntt_tile")
    LAUNCHES["ntt_tile" if w is None else "ntt_tile_w"] += 1
    return out


# -----------------------------------------------------------------------------
# The four-step's inter-step twiddle table, cached per (log_n, nA, dir, device)
# -----------------------------------------------------------------------------

_W_CACHE: dict = {}
_LOCK = threading.Lock()


def _step_w(log_n: int, nA: int, nB: int, inverse: bool, device):
    """W[a, k2] = w_n^(+-a*k2), (K, nA, nB) Montgomery, built on the device by
    doubling along k2.  At 2^22 it is as large as the input."""
    key = (log_n, nA, inverse, torch.device(device))
    with _LOCK:
        got = _W_CACHE.get(key)
    if got is not None:
        return got
    w = root_of_unity(log_n)
    if inverse:
        w = pow(w, FR.modulus - 2, FR.modulus)
    cur = _powers_on_device(w, nA, device)               # (K, nA) = w^a
    Pm = ops.one_mont(FR, (nA, 1), device)
    total = 1
    while total < nB:
        Pm = torch.cat([Pm, fast.mont_mul(FR, Pm, cur[:, :, None])], dim=-1)
        cur = fast.mont_sqr(FR, cur)
        total *= 2
    W = Pm[:, :, :nB].contiguous()
    with _LOCK:
        _W_CACHE[key] = W
    return W


def release_fourstep_cache() -> None:
    with _LOCK:
        _W_CACHE.clear()


# -----------------------------------------------------------------------------
# Single-device four-step NTT
# -----------------------------------------------------------------------------


def _split_top(log_n: int, cap_log: int):
    """(la, lb) split of the top-level Bailey factorization n = nA * nB.

    Balanced while both factors fit a tile (log_n <= 2*cap_log); above that
    the inner factor nB takes everything one recursion level can handle
    (lb <= 2*cap_log) and the outer keeps at least 2^7 elements a row."""
    if log_n <= 2 * cap_log:
        la = log_n // 2
    else:
        lb = min(2 * cap_log, log_n - 7)
        la = log_n - lb
    return la, log_n - la


def fourstep_supported(x) -> bool:
    """True when :func:`ntt_fourstep` handles tensors of this shape.

    The tile kernel computes NTTs up to 2^cap_log in one pass; one level of
    recursion (a Bailey split whose inner factor is itself four-stepped)
    extends that to la + 2*cap_log.  Shapes beyond that, or below 2^10, take
    the radix-2 ladder."""
    if x.ndim < 2:
        return False
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if (1 << log_n) != n or log_n < 10:
        return False
    cap_log = _cap_log(x.device)
    la, lb = _split_top(log_n, cap_log)
    return la <= cap_log and lb <= 2 * cap_log


def _rows_bit_reversed(M):
    """(K, B, r, c) view -> contiguous (K, B*r, c) rows, each bit-reversed.
    One gather reads the view where it lies, so a transposed view costs no
    pass of its own."""
    Kk, B, r, c = M.shape
    return bit_reverse(M, axis=-1).reshape(Kk, B * r, c)


def ntt_fourstep(x, inverse: bool = False, domain: Domain | None = None):
    """(K, ..., n) Montgomery Fr -> NTT along the last axis, natural in/out.

    Factors n = nA * nB and runs two tile passes, with the inter-step twiddle
    multiply folded into the first and the 1/n scale (inverse) folded into
    the second.  Leading axes are batched: rows are laid out (batch * nA) and
    one period of the W table serves them all.  Domains past 2^(2*cap_log)
    recurse once: the inner factor is itself four-stepped and the inter-step
    twiddle becomes one standalone elementwise multiply.  As in the JAX
    package, ``domain`` serves the 1/n scale only: the passes' twiddles come
    from the cached domains of the two factors.
    """
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    lead = tuple(x.shape[1:-1])
    B = 1
    for d in lead:
        B *= d
    dev = x.device
    cap_log = _cap_log(dev)
    la, lb = _split_top(log_n, cap_log)
    nA, nB = 1 << la, 1 << lb
    dom_n = domain or get_domain(log_n, dev)
    W = _step_w(log_n, nA, nB, inverse, dev)             # (K, nA, nB)
    twiddles = lambda d: d.itw if inverse else d.tw

    M = x.reshape(K, B, nB, nA).swapaxes(-1, -2)         # (K, B, nA, nB) view
    if lb <= cap_log:
        with stage("fourstep.layout"):
            Mr = _rows_bit_reversed(M)
        with stage("fourstep.tile_inner"):
            M = ntt_tile(Mr, twiddles(get_domain(lb, dev)), w=W)
        scale = dom_n.n_inv if inverse else None
    else:
        # The inner length-nB NTTs are themselves four-stepped (the leading
        # axes (B, nA) batch them), and W is one elementwise multiply.  The
        # recursive inverse call already scales by 1/nB, so the outer pass
        # folds only the remaining 1/nA.
        Y = ntt_fourstep(M, inverse=inverse)             # (K, B, nA, nB)
        M = fast.mont_mul(FR, Y, W[:, None])
        scale = get_domain(la, dev).n_inv if inverse else None

    # outer NTT over a (length nA); nA <= 2^cap_log by _split_top
    with stage("fourstep.layout"):
        M2r = _rows_bit_reversed(M.reshape(K, B, nA, nB).swapaxes(-1, -2))
    with stage("fourstep.tile_outer"):
        M2 = ntt_tile(M2r, twiddles(get_domain(la, dev)), scale=scale)
    # rows hold OUT[k2 + nB*k1]: transpose back to natural order per batch row
    with stage("fourstep.layout"):
        out = M2.reshape(K, B, nB, nA).swapaxes(-1, -2).reshape((K,) + lead + (n,))
    return out
