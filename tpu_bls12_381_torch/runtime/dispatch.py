"""Auto CPU/accelerator dispatch, with the host standing in only for an
accelerator that is not there.

Counterpart of the JAX package's ``runtime/dispatch.py``: size-thresholded
routing (``Config.use_accel_*``, MIDNIGHT_DEVICE and the thresholds) between
the accelerated path of the port and the host: the native Pippenger MSM of
``native/msm_host.cpp`` where it builds, else the big-int oracle.

The accelerated branch runs in two steps.  First, on the host, it resolves
the device and encodes the inputs as limb tensors.  A failure there (no CUDA
device, inputs the host cannot encode) is logged and the call comes back from
the host with the error kept in the result (``Route.ACCEL_FAILED``): that is
the library's documented contract.  Then the inputs go to the device and the
work runs there.  A failure from that point on (a kernel that does not build
or launch, an off-curve result) raises: the host never stands in for a
failed kernel.  The JAX package degrades in both steps.

Inputs are Python ints and int pairs (the consumer-facing form); tensor
callers use the contexts directly.  ``device`` follows the port's device
rule: ``None`` is the CUDA card; ``device="cpu"`` runs the port's plain
versions on the CPU.
"""

from __future__ import annotations

import enum
import logging
from dataclasses import dataclass
from typing import Any

from ..device import resolve_device

logger = logging.getLogger("tpu_bls12_381_torch.dispatch")


class Route(enum.Enum):
    ACCEL = "accel"
    ACCEL_FAILED = "accel_failed"
    CPU = "cpu"


@dataclass
class DispatchResult:
    value: Any
    route: Route
    error: Exception | None = None


def dispatch_msm(scalars: list[int], bases: list, curve: str = "g1",
                 device=None) -> DispatchResult:
    """MSM on int scalars and affine int-pair bases (None = identity).

    Returns the affine int-pair result (or None) and the route taken.
    """
    from .. import oracle
    from ..fields import FR
    from .config import config

    n = len(scalars)
    ops_ns = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    if config().use_accel_msm(n):
        try:
            dev = resolve_device(device)
            sc = _mont_limbs(FR, scalars)
            A = _curve_module(curve).affine_from_ints(bases, "cpu")
        except Exception as e:  # noqa: BLE001 - nothing has reached the device
            logger.warning("accelerated MSM unavailable (%s); falling back to CPU", e)
            value = oracle.jac_to_affine(_host_msm(scalars, bases, curve), ops_ns)
            return DispatchResult(value, Route.ACCEL_FAILED, e)
        value = _accel_msm(sc.to(dev), tuple(c.to(dev) for c in A), curve)
        return DispatchResult(value, Route.ACCEL)
    value = oracle.jac_to_affine(_host_msm(scalars, bases, curve), ops_ns)
    return DispatchResult(value, Route.CPU)


def _host_msm(scalars, bases, curve: str):
    """CPU MSM: the native Pippenger (``native/msm_host.cpp``) where the
    library builds, else the big-int oracle's double-and-add."""
    from .. import native, oracle

    if native.available():
        return native.msm_host(scalars, bases, curve)
    ops_ns = oracle.FQ_OPS if curve == "g1" else oracle.FQ2_OPS
    return oracle.msm(scalars, bases, ops_ns)


def _curve_module(curve: str):
    from ..curves import g1, g2

    return g1 if curve == "g1" else g2


def _accel_msm(sc, A, curve: str):
    """The MSM on the device, on inputs already there; raises on a fault."""
    from .. import oracle

    ctx = _g1_ctx() if curve == "g1" else _g2_ctx()
    P = ctx.msm(sc, A)
    out = _curve_module(curve).jacobian_to_ints(tuple(c[..., None] for c in P))[0]
    # Hold the result to the curve equation before handing it out, as the
    # JAX package does; here an off-curve result raises to the caller.
    ok = oracle.g1_is_on_curve(out) if curve == "g1" else oracle.g2_is_on_curve(out)
    if not ok:
        raise RuntimeError("accelerated MSM produced an off-curve point")
    return out


_G1_CTX = None
_G2_CTX = None


def _g1_ctx():
    global _G1_CTX
    if _G1_CTX is None:
        from .msm_context import g1_context

        _G1_CTX = g1_context()
    return _G1_CTX


def _g2_ctx():
    global _G2_CTX
    if _G2_CTX is None:
        from .msm_context import g2_context

        _G2_CTX = g2_context()
    return _G2_CTX


def dispatch_ntt(values: list[int], inverse: bool = False,
                 device=None) -> DispatchResult:
    """NTT on int coefficient lists, routed by the size threshold."""
    from .. import oracle
    from ..fields import FR
    from .config import config

    n = len(values)
    if config().use_accel_ntt(n):
        try:
            dev = resolve_device(device)
            x = _mont_limbs(FR, values)
        except Exception as e:  # noqa: BLE001 - nothing has reached the device
            logger.warning("accelerated NTT unavailable (%s); falling back to CPU", e)
            return DispatchResult(oracle.ntt(values, inverse), Route.ACCEL_FAILED, e)
        return DispatchResult(_accel_ntt(x.to(dev), inverse), Route.ACCEL)
    return DispatchResult(oracle.ntt(values, inverse), Route.CPU)


_VECOPS = {
    "add": lambda a, b, p: [(x + y) % p for x, y in zip(a, b)],
    "sub": lambda a, b, p: [(x - y) % p for x, y in zip(a, b)],
    "mul": lambda a, b, p: [x * y % p for x, y in zip(a, b)],
}


def dispatch_vecop(op: str, a: list[int], b: list[int], field: str = "fr",
                   device=None) -> DispatchResult:
    """Elementwise vector op on int lists: the host below
    MIDNIGHT_VECOPS_MIN_SIZE, the accelerator from there, with the same
    two steps as the other dispatchers."""
    from ..fields import FQ, FR
    from .config import config

    if op not in _VECOPS:
        raise ValueError(f"unknown vecop {op!r}")
    spec = FR if field == "fr" else FQ
    if config().use_accel_vecops(len(a)):
        try:
            dev = resolve_device(device)
            av, bv = _mont_limbs(spec, a), _mont_limbs(spec, b)
        except Exception as e:  # noqa: BLE001 - nothing has reached the device
            logger.warning("accelerated vecop unavailable (%s); CPU fallback", e)
            return DispatchResult(_VECOPS[op](a, b, spec.modulus),
                                  Route.ACCEL_FAILED, e)
        return DispatchResult(_accel_vecop(op, av.to(dev), bv.to(dev), spec), Route.ACCEL)
    return DispatchResult(_VECOPS[op](a, b, spec.modulus), Route.CPU)


def _mont_limbs(spec, values):
    """Int values -> (K, n) int32 Montgomery limbs, a tensor on the host."""
    import numpy as np
    import torch

    from ..fields.limbs import ints_to_limbs

    limbs = ints_to_limbs([spec.to_mont(v % spec.modulus) for v in values],
                          spec.num_limbs)
    return torch.from_numpy(limbs.astype(np.int32))


def _ints(spec, t):
    from ..fields import fast
    from ..fields.limbs import limbs_to_ints

    return limbs_to_ints(fast.from_mont(spec, t).cpu().numpy())


def _accel_vecop(op: str, av, bv, spec):
    from .. import vecops

    fn = {"add": vecops.vector_add, "sub": vecops.vector_sub,
          "mul": vecops.vector_mul}[op]
    return _ints(spec, fn(spec, av, bv))


def _accel_ntt(x, inverse: bool):
    from ..fields import FR
    from ..ntt import intt, ntt

    return _ints(FR, intt(x) if inverse else ntt(x))
