"""Radix-2 Cooley-Tukey NTT over Fr (Montgomery domain), batched.

Counterpart of the JAX package's ``ntt/ntt.py``.  The ladder is log2(n)
butterfly stages over a (K, ..., n) limbs-first tensor.  On the CPU each stage
runs as the JAX package writes it.  On the card the first c stages never
leave aligned runs of 2^c elements, so they are one launch of the NTT tile
kernel on rows of 2^c (``ntt/cuda_ntt.py``; for natural input the tile reads
the bit-reversed rows where they lie, as columns of x, so the ordering's bit
reversal takes no pass), and the stages above c run a few at a time in one
or two launches of the ``butterfly_stages`` kernel (``fields/cuda_ops.py``);
``ladder_tile_log`` says which route a tensor takes.  The four-step of
``ntt/cuda_ntt.py`` (two passes of the tile kernel) is there when asked for;
``auto`` takes the ladder on the card up to 2^24, the largest size measured,
where it was the faster on an H100 (``_FOURSTEP_AUTO_MIN``).

Orderings NN/NR/RN/RR are explicit bit-reverse permutations around one DIT
core.  Data is Montgomery-form Fr and must be canonical (< r).
"""

from __future__ import annotations

import enum

from ..fields import FR, cuda_ops, fast
from ..vecops import bit_reverse
from .domain import Domain, _powers_on_device, get_domain


class Ordering(enum.Enum):
    NN = "NN"  # natural in, natural out
    NR = "NR"  # natural in, bit-reversed out
    RN = "RN"  # bit-reversed in, natural out
    RR = "RR"  # bit-reversed in, bit-reversed out


# log2 of the ladder's tile rows on the card: rows of 2^11 run four values a
# thread, rows of 2^12 (the tile's cap) eight (csrc/ntt.cuh); chip_smoke.py's
# ntt_ladder_split line times the 2^22 ladder with each.
LADDER_TILE_LOG = 11


def ladder_tile_log(x):
    """log2 of the rows that the ladder's first stages take as one tile launch
    on ``x``'s device: the card's (at most ``LADDER_TILE_LOG``); None on the
    CPU, where every stage runs as the JAX package's.  A CPU test
    monkeypatches it to drive the card's split through the plain versions."""
    if not x.is_cuda:
        return None
    from .cuda_ntt import _cap_log

    return min(_cap_log(x.device), LADDER_TILE_LOG)


def ladder_split(log_n: int, c: int):
    """The card's ladder for size 2^log_n: the tile's rows (2^c', c' =
    min(log_n, c)), then the (log2 half, count) of each butterfly_stages
    launch, the stages above c' cut into as few launches of at most
    ``cuda_ops.MAX_STAGES`` as can be, as even as can be."""
    c = min(log_n, c)
    rest = log_n - c
    launches = -(-rest // cuda_ops.MAX_STAGES)
    out, s = [], c
    for i in range(launches):
        count = (rest + launches - 1 - i) // launches
        out.append((s, count))
        s += count
    return c, out


def _stage_table(tw, log_n: int, log_s: int):
    """The size-2^log_s domain's twiddles, from the size-2^log_n table: every
    2^(log_n - log_s)-th entry (``get_domain(log_s)``'s, since the roots
    square down)."""
    if log_s == log_n:
        return tw
    return tw[:, ::1 << (log_n - log_s)][:, :1 << (log_s - 1)].contiguous()


def _butterflies(x, tw, log_n: int, scale=None, natural_in=False):
    """DIT butterfly ladder: expects bit-reversed input (natural input with
    ``natural_in``: the ladder bit-reverses it first), yields natural output,
    times ``scale`` (None or one (K,) element) where given.

    x: (K, ..., n); tw: (K, n/2) Montgomery twiddles w^0..w^(n/2-1).  On the
    card the tile takes the first c stages on rows of 2^c: with
    ``natural_in``, row j of the bit-reversed array is column brev(j) of x
    seen as (2^c, 2^(log_n - c)), which the tile reads where it lies.
    """
    c = ladder_tile_log(x) if log_n > 0 else None
    if c is None:
        x = bit_reverse(x, axis=-1) if natural_in else x.contiguous()
        for s in range(1, log_n + 1):
            x = cuda_ops.butterfly_stage(FR, x, tw, 1 << (s - 1))
        if scale is not None:
            x = fast.mont_mul(FR, x, scale.reshape((FR.num_limbs,) + (1,) * (x.dim() - 1)))
        return x
    c, launches = ladder_split(log_n, c)
    from .cuda_ntt import ntt_tile, ntt_tile_columns

    shape, K = x.shape, FR.num_limbs
    tile_scale = scale if not launches else None
    if natural_in:
        x = ntt_tile_columns(x.reshape(K, -1, 1 << c, 1 << (log_n - c)).contiguous(),
                             _stage_table(tw, log_n, c), scale=tile_scale, brev_cols=True)
    else:
        x = ntt_tile(x.reshape(K, -1, 1 << c).contiguous(), _stage_table(tw, log_n, c),
                     scale=tile_scale)
    x = x.reshape(shape)
    for i, (log_h, count) in enumerate(launches):
        last = i == len(launches) - 1
        x = cuda_ops.butterfly_stages(FR, x, _stage_table(tw, log_n, log_h + count),
                                      1 << log_h, count, scale=scale if last else None)
    return x


def _ntt_core(x, log_n: int, inverse: bool, ordering: Ordering, tw, n_inv):
    x = _butterflies(x, tw, log_n, n_inv if inverse else None,
                     natural_in=ordering in (Ordering.NN, Ordering.NR))
    if ordering in (Ordering.NR, Ordering.RR):
        x = bit_reverse(x, axis=-1)
    return x


def _resolve(x, domain):
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    if domain is None:
        domain = get_domain(log_n, x.device)
    elif domain.log_n != log_n:
        raise ValueError(f"domain is for 2^{domain.log_n}, input is 2^{log_n}")
    return log_n, domain


# Auto algorithm selection: from this size on the card takes the four-step.
# Set from chip_smoke.py's ntt_crossover line on an H100 (PERF.md, PR 11):
# the ladder (one tile launch, then butterfly_stages) won at 2^10, 2^12 and
# from 2^20 to 2^24 in every turn, and the two were within 10% at 2^14 and
# 2^16, so no size from which on the four-step wins exists there, and it is
# kept only above the sizes measured.  The JAX package's value, found on a
# TPU, is 2^16.
_FOURSTEP_AUTO_MIN = 1 << 25


def _route_fourstep(x, ordering: Ordering) -> bool:
    """Whether this call takes the four-step.  ``radix2`` and every ordering
    but NN take the ladder, as does a shape the four-step does not handle;
    ``fourstep`` forces the four-step (on the CPU through the tile's plain
    version); ``auto`` takes it for CUDA tensors from _FOURSTEP_AUTO_MIN on."""
    from ..runtime.config import config
    from .cuda_ntt import fourstep_supported

    algo = config().ntt_algorithm
    if algo == "radix2" or ordering is not Ordering.NN:
        return False
    if not fourstep_supported(x):
        return False
    if algo == "fourstep":
        return True
    return x.is_cuda and x.shape[-1] >= _FOURSTEP_AUTO_MIN


def ntt(x, ordering: Ordering = Ordering.NN, domain: Domain | None = None):
    """Forward NTT along the last axis. x: (K, ..., n) Montgomery Fr."""
    log_n, domain = _resolve(x, domain)
    if _route_fourstep(x, ordering):
        from .cuda_ntt import ntt_fourstep

        return ntt_fourstep(x, inverse=False, domain=domain)
    return _ntt_core(x, log_n, False, ordering, domain.tw, domain.n_inv)


def intt(x, ordering: Ordering = Ordering.NN, domain: Domain | None = None):
    """Inverse NTT along the last axis (includes the 1/n scale)."""
    log_n, domain = _resolve(x, domain)
    if _route_fourstep(x, ordering):
        from .cuda_ntt import ntt_fourstep

        return ntt_fourstep(x, inverse=True, domain=domain)
    return _ntt_core(x, log_n, True, ordering, domain.itw, domain.n_inv)


# -----------------------------------------------------------------------------
# Coset NTT (evaluate on the coset shift * <omega>)
# -----------------------------------------------------------------------------

_COSET_CACHE: dict = {}


def coset_powers(shift: int, n: int, inverse: bool = False, device=None):
    """[s^0, .., s^(n-1)] (or s^-i) Montgomery, cached per (shift, n, dir,
    device)."""
    from ..device import resolve_device

    key = (shift, n, inverse, resolve_device(device))
    got = _COSET_CACHE.get(key)
    if got is None:
        base = pow(shift, FR.modulus - 2, FR.modulus) if inverse else shift
        got = _powers_on_device(base, n, key[-1])
        _COSET_CACHE[key] = got
    return got


def release_coset_cache() -> None:
    """Drop the cached coset power tables."""
    _COSET_CACHE.clear()


def _coset_row(x, shift: int, inverse: bool):
    n = x.shape[-1]
    cp = coset_powers(shift, n, inverse, x.device)
    return cp.reshape((FR.num_limbs,) + (1,) * (x.dim() - 2) + (n,))


def coset_ntt(x, shift: int, ordering: Ordering = Ordering.NN,
              domain: Domain | None = None):
    """Evaluate the polynomial on the coset {shift * omega^i}: multiply by the
    powers of ``shift``, then the plain NTT."""
    if ordering in (Ordering.RN, Ordering.RR):
        raise ValueError("coset_ntt requires natural-order input")
    return ntt(fast.mont_mul(FR, x, _coset_row(x, shift, False)), ordering,
               domain)


def coset_intt(x, shift: int, ordering: Ordering = Ordering.NN,
               domain: Domain | None = None):
    """Inverse of coset_ntt: iNTT, then divide by the powers of ``shift``."""
    if ordering in (Ordering.NR, Ordering.RR):
        raise ValueError("coset_intt requires natural-order output")
    y = intt(x, ordering, domain)
    return fast.mont_mul(FR, y, _coset_row(y, shift, True))
