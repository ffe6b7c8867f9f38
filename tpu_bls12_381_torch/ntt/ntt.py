"""Radix-2 Cooley-Tukey NTT over Fr (Montgomery domain), batched.

Counterpart of the JAX package's ``ntt/ntt.py``.  The ladder is log2(n)
butterfly stages over a (K, ..., n) limbs-first tensor; on the card each stage
is one launch of the ``butterfly_stage`` kernel on the array where it lies
(``fields/cuda_ops.py``), on the CPU the stage as the JAX package writes it.
Large natural-order transforms on the card take the four-step of
``ntt/cuda_ntt.py`` instead: two passes of the fused tile kernel.

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


def _butterflies(x, tw, log_n: int):
    """DIT butterfly ladder: expects bit-reversed input, yields natural output.

    x: (K, ..., n); tw: (K, n/2) Montgomery twiddles w^0..w^(n/2-1).
    """
    x = x.contiguous()
    for s in range(1, log_n + 1):
        x = cuda_ops.butterfly_stage(FR, x, tw, 1 << (s - 1))
    return x


def _ntt_core(x, log_n: int, inverse: bool, ordering: Ordering, tw, n_inv):
    if ordering in (Ordering.NN, Ordering.NR):
        x = bit_reverse(x, axis=-1)
    x = _butterflies(x, tw, log_n)
    if ordering in (Ordering.NR, Ordering.RR):
        x = bit_reverse(x, axis=-1)
    if inverse:
        s = n_inv.reshape((FR.num_limbs,) + (1,) * (x.dim() - 1))
        x = fast.mont_mul(FR, x, s)
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
# The value is the JAX package's, found on a TPU; it is not measured on this
# card (PERF.md says where chip_smoke.py found the two algorithms to cross).
_FOURSTEP_AUTO_MIN = 1 << 16


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
