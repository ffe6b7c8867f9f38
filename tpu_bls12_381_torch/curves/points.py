"""Jacobian-coordinate helpers.

Counterpart of the JAX package's ``curves/points.py`` as far as the MSM
context and the host converters need it: ``jac_to_affine``.  The Jacobian
group law itself (``jac_add``, ``jac_add_affine``, ``jac_double``,
``scalar_mul``, the curve and subgroup checks) is not ported yet.
"""

from __future__ import annotations


def jac_to_affine(F, P):
    """Jacobian -> affine: (X/Z^2, Y/Z^3, inf = Z==0)."""
    X, Y, Z = P
    inf = F.is_zero(Z)
    # inv(0) would poison the lane: put 1 where the point is the identity
    batch = F.batch_shape(X)
    zi = F.inv(F.cmov(inf, F.one(batch, X.device), Z))
    zi2 = F.sqr(zi)
    x = F.mul(X, zi2)
    y = F.mul(Y, F.mul(zi2, zi))
    zero = F.zero(batch, X.device)
    return (F.cmov(inf, zero, x), F.cmov(inf, zero, y), inf)
