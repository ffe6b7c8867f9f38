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
holds a slab of whole rows; each thread holds four elements in registers and
runs two stages a round at rows of up to 2^11 (512 threads), eight and three at
rows of 2^12 (a register radix group), with one exchange through shared
memory between rounds; it reads a group's twiddles once from the
domain's (K, m/2) table, so the (stages, K, m) table that the TPU kernel has
packed for it does not exist here.  It takes rows already bit-reversed (the
ladder's RN and RR, ``ntt_tile``) or in natural order as the columns of the
array where it lies, each element placed at its bit-reversed position as it
loads (``ntt_tile_columns``: the four-step's rows, the NN ladder's).  On an
H100 a pass takes 1.5 to 2.2 times what its butterflies take on registers
alone (PERF.md has the reckoning).  The wrapper takes ``ntt_tile_plain`` only
for CPU tensors; for CUDA tensors it launches the kernel or raises.  It
copies nothing.  ``LAUNCHES`` counts kernel launches, and nothing else:
``ntt_tile_w`` those with the table ``w`` folded in, ``ntt_tile`` those
without.

The four-step's last transpose and the building of the twiddle table W are
plain torch ops around the kernel, as they are XLA's in the JAX package
(folding the transpose into the tile's store measured slower than the copy:
PERF.md, PR 11).
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
# The tile's launches by load mode: rows_bitrev, columns, columns_brev.
MODE_LAUNCHES: dict = {}

# The longest row the kernel takes: 2^12 (csrc/ntt_kernels.cu).
MAX_TILE_LOG = 12

_PTR = ctypes.c_void_p
_CONFIGURED = False


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    MODE_LAUNCHES.clear()


def _lib():
    global _CONFIGURED
    lib = _build.library("ntt_kernels")
    if not _CONFIGURED:
        lib.fr_ntt_tile.argtypes = (
            [_PTR] * 5 + [ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_int] * 3
            + [_PTR])
        lib.fr_ntt_tile.restype = ctypes.c_int
        _CONFIGURED = True
    return lib


def _cap_log(device) -> int:
    """log2 of the longest row the tile takes: what one block can hold in
    shared memory on ``device`` (``tuning.py``), and at most 2^12, a block of
    512 threads with 8 elements each (``csrc/ntt.cuh``)."""
    return min(chip_profile(device).ntt_tile_log_cap, MAX_TILE_LOG)


# -----------------------------------------------------------------------------
# The tile: plain version and kernel wrapper
# -----------------------------------------------------------------------------


def ntt_tile_plain(x, tw, w=None, scale=None):
    """Plain PyTorch version of the tile kernel on bit-reversed rows: the
    ladder on every row, then the two optional multiplies."""
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


def _check_tile(what, x, tw, w, scale, rows, m):
    """Raise unless the tile kernel takes these operands (``rows`` rows of
    ``m`` elements in ``x``); returns (log2 m, Bw)."""
    log_m = m.bit_length() - 1
    cap_log = _cap_log(x.device)
    if m < 2 or 1 << log_m != m or log_m > cap_log:
        raise ValueError(f"{what}: the row length must be a power of two in "
                         f"[2, 2^{cap_log}], got {m}")
    check_limbs(tw, K, f"{what}: tw")
    if tuple(tw.shape) != (K, m // 2):
        raise ValueError(f"{what}: expected twiddles of shape ({K}, {m // 2}), "
                         f"got {tuple(tw.shape)}")
    Bw = 0
    if w is not None:
        check_limbs(w, K, f"{what}: w")
        if w.dim() != 3 or w.shape[2] != m or w.shape[1] < 1 or rows % w.shape[1]:
            raise ValueError(f"{what}: expected w of shape ({K}, Bw, {m}) with "
                             f"Bw dividing {rows}, got {tuple(w.shape)}")
        Bw = w.shape[1]
    if scale is not None:
        check_limbs(scale, K, f"{what}: scale")
        if scale.dim() != 1:
            raise ValueError(f"{what}: expected a scalar of shape ({K},), got "
                             f"{tuple(scale.shape)}")
    for name, t in (("tw", tw), ("w", w), ("scale", scale)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
    return log_m, Bw


def _launch_tile(x, tw, w, scale, rows, m, log_m, Bw, cols_log, brev_cols):
    """One launch of the tile kernel: (K, rows, m) natural rows out."""
    out = torch.empty((K, rows, m), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = _lib().fr_ntt_tile(
            x.data_ptr(), tw.data_ptr(),
            w.data_ptr() if w is not None else None,
            scale.data_ptr() if scale is not None else None,
            out.data_ptr(), rows, Bw, log_m, cols_log, int(bool(brev_cols)),
            stream_ptr(x.device))
    check_launch(code, "fr_ntt_tile")
    LAUNCHES["ntt_tile" if w is None else "ntt_tile_w"] += 1
    mode = "columns" + ("_brev" if brev_cols else "") if cols_log >= 0 else "rows_bitrev"
    MODE_LAUNCHES[mode] = MODE_LAUNCHES.get(mode, 0) + 1
    return out


def ntt_tile(x, tw, w=None, scale=None):
    """Size-m NTT of every row of ``x`` (K, B, m): bit-reversed rows in (the
    ladder's order), natural rows out.  ``ntt_tile_columns`` takes rows in
    natural order.

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
    log_m, Bw = _check_tile("ntt_tile", x, tw, w, scale, B, m)
    if not x.is_cuda:
        return ntt_tile_plain(x, tw, w, scale)
    return _launch_tile(x, tw, w, scale, B, m, log_m, Bw, -1, False)


def _columns_as_rows(x, brev_cols):
    """(K, B, m, C) -> the (K, B*C, m) rows that ``ntt_tile_columns`` takes:
    column j of each block, or column brev(j)."""
    Kk, B, m, C = x.shape
    cols = x.transpose(-1, -2)
    if brev_cols:
        cols = bit_reverse(cols, axis=-2)
    return cols.reshape(Kk, B * C, m)


def ntt_tile_columns_plain(x, tw, w=None, scale=None, brev_cols=False):
    """Plain PyTorch version of ``ntt_tile_columns``: the columns laid out as
    rows and bit-reversed, then the tile's plain version."""
    rows = bit_reverse(_columns_as_rows(x, brev_cols), axis=-1)
    return ntt_tile_plain(rows, tw, w, scale)


def ntt_tile_columns(x, tw, w=None, scale=None, brev_cols=False):
    """The tile on the columns of ``x`` (K, B, m, C): row b*C + j of the
    (K, B*C, m) result is the size-m NTT of ``x[:, b, :, j]`` (natural order
    down the column; C = 1: the rows of x in natural order), or of column
    brev(j) with ``brev_cols``; then times ``w`` and ``scale`` as
    ``ntt_tile``.

    The kernel reads the columns where they lie, each element bit-reversed
    into place as it loads: the four-step's transposes (C = the other
    factor) and the ladder's bit reversal (``brev_cols``, C = n / m) cost no
    pass of their own.
    """
    check_limbs(x, K, "ntt_tile_columns: x")
    if x.dim() != 4:
        raise ValueError(f"ntt_tile_columns: expected x of shape ({K}, B, m, C), got "
                         f"{tuple(x.shape)}")
    B, m, C = x.shape[1], x.shape[2], x.shape[3]
    if C < 1 or C & (C - 1):
        raise ValueError(f"ntt_tile_columns: the columns must be a power of two, got {C}")
    log_m, Bw = _check_tile("ntt_tile_columns", x, tw, w, scale, B * C, m)
    if not x.is_cuda:
        return ntt_tile_columns_plain(x, tw, w, scale, brev_cols)
    return _launch_tile(x, tw, w, scale, B * C, m, log_m, Bw, C.bit_length() - 1, brev_cols)


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
    W = step_rows(_powers_on_device(w, nA, device), nB)  # rows from w^a
    with _LOCK:
        _W_CACHE[key] = W
    return W


def step_rows(cur, nB: int):
    """Rows [v^0, v^1, .., v^(nB-1)] for each entry v of ``cur`` (K, rows),
    Montgomery, (K, rows, nB): log2(nB) doubling steps, each a product of the
    columns so far by v^(their count) and a square of that."""
    Pm = ops.one_mont(FR, (cur.shape[-1], 1), cur.device)
    total = 1
    while total < nB:
        Pm = torch.cat([Pm, fast.mont_mul(FR, Pm, cur[:, :, None])], dim=-1)
        cur = fast.mont_sqr(FR, cur)
        total *= 2
    return Pm[:, :, :nB].contiguous()


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


def ntt_fourstep(x, inverse: bool = False, domain: Domain | None = None):
    """(K, ..., n) Montgomery Fr -> NTT along the last axis, natural in/out.

    Factors n = nA * nB and runs two tile passes, each on the columns of the
    array where it lies (the tile reads a column as a row and bit-reverses it
    as it loads it, so neither the transposes nor the bit reversals take a
    pass of their own), with the inter-step twiddle multiply folded into the
    first and the 1/n scale (inverse) folded into the second; one transpose
    puts the result in natural order.  Leading axes are batched: rows are laid out (batch * nA) and
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

    if lb <= cap_log:
        # rows (b, a) are the columns a of x seen as (K, B, nB, nA)
        with stage("fourstep.tile_inner"):
            M = ntt_tile_columns(x.reshape(K, B, nB, nA).contiguous(),
                                 twiddles(get_domain(lb, dev)), w=W)
        scale = dom_n.n_inv if inverse else None
    else:
        # The inner length-nB NTTs are themselves four-stepped (the leading
        # axes (B, nA) batch them), and W is one elementwise multiply.  The
        # recursive inverse call already scales by 1/nB, so the outer pass
        # folds only the remaining 1/nA.
        M = x.reshape(K, B, nB, nA).swapaxes(-1, -2)     # (K, B, nA, nB) view
        Y = ntt_fourstep(M, inverse=inverse)             # (K, B, nA, nB)
        M = fast.mont_mul(FR, Y, W[:, None])
        scale = get_domain(la, dev).n_inv if inverse else None

    # outer NTT over a (length nA, rows (b, k2): the columns k2 of M seen as
    # (K, B, nA, nB)); nA <= 2^cap_log by _split_top
    with stage("fourstep.tile_outer"):
        M2 = ntt_tile_columns(M.reshape(K, B, nA, nB), twiddles(get_domain(la, dev)),
                              scale=scale)
    # rows hold OUT[k2 + nB*k1]: transpose back to natural order per batch row
    with stage("fourstep.layout"):
        out = M2.reshape(K, B, nB, nA).swapaxes(-1, -2).reshape((K,) + lead + (n,))
    return out
