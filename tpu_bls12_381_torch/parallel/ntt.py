"""Sharded NTT: the Bailey four-step over a 1-D mesh of ranks.

Counterpart of the JAX package's ``parallel/ntt.py``.  A size-n NTT is
factored as n = nA * nB and computed as two batches of local NTTs with a
twiddle product and global transposes between them:

    X[k2 + nB*k1] = sum_{a} w_n^{a*k2} * w_nA^{a*k1}
                    * ( sum_{b} w_nB^{b*k2} * x[a + nA*b] )

The "M-form" of an array v is the row-cut matrix ``M[a, b] = v[a + nA*b]``
((K, nA/p, nB) on each rank).  A rank holds its contiguous block of v's
columns, (K, n/p), which is the row-cut M-form transposed, so a change of
layout is one global transpose (``mesh.global_transpose``: one
``all_to_all_single`` and a local swap).  Forward, natural in:

    T0: natural -> M-form            (all_to_all_single)
    1.  local NTT of length nB along rows
    2.  product by W[a, k2] = w_n^(+-a*k2)   (this rank's rows of it)
    T1: global transpose             (all_to_all_single)
    3.  local NTT of length nA along rows
    ->  the rows hold OUT[k2 + nB*k1]: the "transposed layout"
    T2 (unless transposed_out): back to natural order (all_to_all_single)

The local NTTs are the port's own ``ntt.ntt`` / ``ntt.intt``, whose routing
picks the faster algorithm for the rows' length on the device (the ladder on
the card: the ``ntt_tile`` kernel, and ``butterfly_stages`` above the tile).
The inverse from the transposed layout is the same bracket with (nA, nB)
swapped and the inverse twiddles; 1/nA * 1/nB = 1/n falls out of the two
local inverse NTTs.
"""

from __future__ import annotations

import threading

from ..fields import FR, fast
from ..ntt.cuda_ntt import step_rows
from ..ntt.domain import _fr_element, _powers_on_device, get_domain
from ..ntt.ntt import intt, ntt
from ..oracle import root_of_unity
from .mesh import check_collectives, global_transpose


def split_sizes(log_n: int, p: int) -> tuple[int, int]:
    """Pick nA * nB = n, both multiples of p, as square as possible."""
    n = 1 << log_n
    la = log_n // 2
    lp = max(p.bit_length() - 1, 0)
    la = min(max(la, lp), log_n - lp)
    return 1 << la, n >> la


_STEP_TW_CACHE: dict = {}
_COSET_SHARD_CACHE: dict = {}
_LOCK = threading.Lock()


def _cached(cache: dict, key, build):
    with _LOCK:
        got = cache.get(key)
    if got is None:
        got = build()
        with _LOCK:
            cache[key] = got
    return got


def _offset_powers(base: int, start: int, count: int, device):
    """[base^start, .., base^(start+count-1)] Montgomery, (K, count)."""
    p = _powers_on_device(base, count, device)
    if start == 0:
        return p
    return fast.mont_mul(FR, p, _fr_element(pow(base, start, FR.modulus), device)[:, None])


def build_step_twiddles(log_n: int, nA: int, nB: int, inverse: bool, mesh):
    """This rank's rows of W[a, b] = w_n^(+-a*b), Montgomery, (K, nA/p, nB).

    Built on the rank's device in log2(nB) doubling steps from its w^a
    (``cuda_ntt.step_rows``), cached per (log_n, nA, inverse, rank, size,
    device)."""
    def build():
        w = root_of_unity(log_n)
        if inverse:
            w = pow(w, FR.modulus - 2, FR.modulus)
        rows = nA // mesh.size
        return step_rows(_offset_powers(w, mesh.rank * rows, rows, mesh.device), nB)

    key = (log_n, nA, inverse, mesh.rank, mesh.size, mesh.device)
    return _cached(_STEP_TW_CACHE, key, build)


def _four_step_local(x_loc, W_loc, mesh, *, nA: int, nB: int, inverse: bool,
                     transposed_in: bool, transposed_out: bool):
    """One rank's body.  x_loc: (K, n/p)."""
    K, p = x_loc.shape[0], mesh.size
    if transposed_in:
        M = x_loc.reshape(K, nA // p, nB)          # already M-form rows
    else:
        # natural-contiguous = transposed M-form rows: (K, nB/p, nA)
        M = global_transpose(mesh, x_loc.reshape(K, nB // p, nA))
    local = intt if inverse else ntt
    M = local(M, domain=get_domain(nB.bit_length() - 1, mesh.device))
    M = fast.mont_mul(FR, M, W_loc)
    M2 = global_transpose(mesh, M)                 # (K, nB/p, nA)
    M2 = local(M2, domain=get_domain(nA.bit_length() - 1, mesh.device))
    # M2's rows hold OUT[b + nB*a]: the transposed layout
    if not transposed_out:
        M2 = global_transpose(mesh, M2)            # (K, nA/p, nB): natural rows
    return M2.reshape(K, -1)


def _ntt_sharded_impl(x, mesh, inverse: bool, transposed_in: bool,
                      transposed_out: bool):
    n = x.shape[-1] * mesh.size
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("sharded NTT size must be a power of two")
    p = mesh.size
    nA, nB = split_sizes(log_n, p)
    if transposed_in:
        # roles swap: the transposed layout is the M-form of (nB, nA)
        nA, nB = nB, nA
    if nA % p or nB % p:
        raise ValueError(f"n=2^{log_n} too small to split over {p} devices")
    check_collectives(mesh, "sharded NTT")
    if x.device != mesh.device:
        raise ValueError(f"sharded NTT: the input is on {x.device}, the mesh's rank on "
                         f"{mesh.device}")
    W = build_step_twiddles(log_n, nA, nB, inverse, mesh)
    return _four_step_local(x, W, mesh, nA=nA, nB=nB, inverse=inverse,
                            transposed_in=transposed_in, transposed_out=transposed_out)


def ntt_sharded(x, mesh, *, transposed_out: bool = False):
    """Forward NTT of a Montgomery-Fr array of n elements cut over ``mesh``:
    ``x`` is this rank's contiguous block, (K, n/p); so is the result.

    ``transposed_out=True`` leaves the result in the four-step's transposed
    layout (element k2 + nB*k1 at flat position k2*nA + k1), saving one
    exchange; pair it with ``intt_sharded(..., transposed_in=True)``.
    """
    return _ntt_sharded_impl(x, mesh, False, False, transposed_out)


def intt_sharded(x, mesh, *, transposed_in: bool = False):
    """Inverse NTT (with the 1/n scale); natural or transposed input."""
    return _ntt_sharded_impl(x, mesh, True, transposed_in, False)


def coset_powers_sharded(shift: int, n: int, mesh, inverse: bool = False):
    """This rank's columns of [s^0, .., s^(n-1)] (or s^-i), Montgomery,
    (K, n/p): s^(offset + j), cached per (shift, n, direction, rank, size,
    device)."""
    def build():
        base = pow(shift, FR.modulus - 2, FR.modulus) if inverse else shift
        per = n // mesh.size
        return _offset_powers(base, mesh.rank * per, per, mesh.device)

    key = (shift, n, inverse, mesh.rank, mesh.size, mesh.device)
    return _cached(_COSET_SHARD_CACHE, key, build)


def coset_ntt_sharded(x, mesh, shift: int, *, transposed_out: bool = False):
    """Sharded coset NTT: evaluate on {shift * omega^i} over the mesh (the
    product by this rank's shift powers, then :func:`ntt_sharded`)."""
    n = x.shape[-1] * mesh.size
    cp = coset_powers_sharded(shift, n, mesh)
    return ntt_sharded(fast.mont_mul(FR, x, cp), mesh, transposed_out=transposed_out)


def coset_intt_sharded(x, mesh, shift: int, *, transposed_in: bool = False):
    """Inverse of :func:`coset_ntt_sharded`: the sharded inverse NTT, then the
    product by this rank's inverse shift powers."""
    y = intt_sharded(x, mesh, transposed_in=transposed_in)
    cp = coset_powers_sharded(shift, y.shape[-1] * mesh.size, mesh, inverse=True)
    return fast.mont_mul(FR, y, cp)


def ntt_batch_sharded(x, mesh, *, inverse: bool = False):
    """A batch of independent NTTs with the batch axis cut over the mesh.

    x: this rank's block (K, B/p, n); each rank transforms its rows, with no
    communication."""
    if x.device != mesh.device:
        raise ValueError(f"ntt_batch_sharded: the input is on {x.device}, the mesh's "
                         f"rank on {mesh.device}")
    dom = get_domain(x.shape[-1].bit_length() - 1, mesh.device)
    return (intt if inverse else ntt)(x, domain=dom)


def release_sharded_caches() -> None:
    """Drop the cached step twiddles and coset powers."""
    with _LOCK:
        _STEP_TW_CACHE.clear()
        _COSET_SHARD_CACHE.clear()
