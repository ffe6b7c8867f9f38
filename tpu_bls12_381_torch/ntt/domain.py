"""NTT twiddle domains: per-log-size, per-device cached roots of unity
(Montgomery form).

Counterpart of the JAX package's ``ntt/domain.py``: a process-wide cache of
twiddle tables that live on the device, built once per size and device and
reused, with explicit release.  The root for size 2^k is ``FR_OMEGA`` squared
down (32 - k) times (``oracle.root_of_unity``), which is what makes results
bit-exact against the golden vectors.

Tables are built on the device in log2(n) doubling steps
(P_2m = [P_m, P_m * w^m], each a full-width Montgomery product through
``fields/fast.py``: the ``mont_mul`` kernel on the card).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants
from ..device import resolve_device
from ..fields import FR, fast, ops
from ..fields.limbs import int_to_limbs
from ..oracle import root_of_unity


@dataclass
class Domain:
    log_n: int
    tw: torch.Tensor      # (K, n/2) forward twiddles w^0..w^(n/2-1), Montgomery
    itw: torch.Tensor     # (K, n/2) inverse twiddles
    n_inv: torch.Tensor   # (K,) Montgomery form of n^-1
    omega: int            # standard-form root (host int, for derivations)

    @property
    def n(self) -> int:
        return 1 << self.log_n


_CACHE: dict[tuple[int, torch.device], Domain] = {}
_LOCK = threading.Lock()


def _fr_element(value: int, device) -> torch.Tensor:
    """One standard-form integer -> its Montgomery limbs (K,) on ``device``."""
    limbs = int_to_limbs(FR.to_mont(value), FR.num_limbs)
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def _powers_on_device(w_int: int, count: int, device=None) -> torch.Tensor:
    """[w^0, .., w^(count-1)] in Montgomery form, built by doubling on device."""
    dev = resolve_device(device)
    if count <= 0:
        return ops.zeros(FR, (0,), dev)
    p = ops.one_mont(FR, (1,), dev)
    cur = _fr_element(w_int, dev)[:, None]     # w^(len p) at each step
    total = 1
    while total < count:
        p = torch.cat([p, fast.mont_mul(FR, p, cur)], dim=-1)
        cur = fast.mont_sqr(FR, cur)
        total *= 2
    return p[:, :count].contiguous()


def get_domain(log_n: int, device=None) -> Domain:
    """Fetch (building if needed) the twiddle domain for size 2^log_n on
    ``device`` (None = the card)."""
    if log_n < 0 or log_n > constants.MAX_NTT_LOG_SIZE:
        raise ValueError(
            f"log_n {log_n} out of range [0, {constants.MAX_NTT_LOG_SIZE}]")
    dev = resolve_device(device)
    key = (log_n, dev)
    with _LOCK:
        dom = _CACHE.get(key)
    if dom is not None:
        return dom
    n = 1 << log_n
    omega = root_of_unity(log_n)
    omega_inv = pow(omega, FR.modulus - 2, FR.modulus)
    dom = Domain(
        log_n=log_n,
        tw=_powers_on_device(omega, n // 2, dev),
        itw=_powers_on_device(omega_inv, n // 2, dev),
        n_inv=_fr_element(pow(n, FR.modulus - 2, FR.modulus), dev),
        omega=omega)
    with _LOCK:
        _CACHE[key] = dom
    return dom


def release_domain(log_n: int | None = None) -> None:
    """Drop cached domain(s) of every device: all of them, or one size."""
    with _LOCK:
        if log_n is None:
            _CACHE.clear()
        else:
            for key in [k for k in _CACHE if k[0] == log_n]:
                del _CACHE[key]
