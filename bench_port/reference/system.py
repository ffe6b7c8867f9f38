"""The plain reference put where the program stands: the same operations on
the same inputs, from the benchmark's frozen G1 and Fr arithmetic alone.

It imports nothing of the program, and reads nothing that the program made:
the bases are the benchmark's multiples k_j G (``inputs.ks``), so an MSM
against them is (sum_i s_i k_(i mod m)) G, worked out from the scalars as
they were drawn.  Its outputs have the program's encodings (host points as
Montgomery Fq limbs, Fr vectors as Montgomery limbs), so the check compares
the two bit for bit.

``ControlSystem`` breaks one guarantee that the configurations state, as a
faster program might be tempted to: a commitment over scalars cut to their
low 240 bits (one 16-bit window left out), and transforms whose last product
skips its final conditional subtraction (limbs below 2r, not below r).  The
check has to find it not correct.
"""

from __future__ import annotations

import torch

from . import fr, g1

MSM_LIMBS = 16


def encode_points(points) -> torch.Tensor:
    """Affine points (None for the identity) -> (49, B) int32: 24 limbs of x
    and of y in Montgomery form, then the identity flag."""
    out = torch.zeros((2 * g1.FQ_LIMBS + 1, len(points)), dtype=torch.int32)
    for j, pt in enumerate(points):
        if pt is None:
            out[-1, j] = 1
            continue
        for c, v in enumerate(pt):
            m = v * g1.FQ_MONT % g1.P
            out[c * g1.FQ_LIMBS:(c + 1) * g1.FQ_LIMBS, j] = torch.tensor(
                [(m >> (16 * i)) & 0xFFFF for i in range(g1.FQ_LIMBS)], dtype=torch.int32)
    return out


def weighted_sums(scalars: torch.Tensor, ks: torch.Tensor) -> list[int]:
    """sum_i s_i k_(i mod m) over the last axis of (16, B, N) limbs, one
    Python int per column.  Each limb plane's sum is below 2^16 * 2^16 * N,
    exact in int64 up to N = 2^31."""
    n = scalars.shape[-1]
    k = ks.to(scalars.device, torch.int64).repeat(-(-n // ks.numel()))[:n]
    sums = (scalars.to(torch.int64) * k).sum(dim=-1).cpu().tolist()   # (16, B)
    return [sum(int(sums[l][j]) << (16 * l) for l in range(MSM_LIMBS))
            for j in range(scalars.shape[1])]


class ReferenceSystem:
    """The reference, as a system the benchmark's rounds can drive."""

    name = "reference"

    def __init__(self, inputs, config=None, device=None, ops=None):
        self.ks = inputs.ks
        self.shift = inputs.coset_shift
        self.zh_inv = inputs.zh_inv

    def _totals(self, scalars):
        # Montgomery-form scalars m_i stand for s_i = m_i / 2^256 mod r.
        inv = pow(fr.MONT, -1, fr.R)
        return [t * inv % fr.R for t in weighted_sums(scalars, self.ks)]

    def msm(self, scalars):
        return [g1.multiple(t) for t in self._totals(scalars)]

    def to_host(self, points):
        return encode_points(points)

    def intt(self, x):
        return fr.intt(x)

    def coset_ntt(self, x):
        return fr.coset_ntt(x, self.shift)

    def coset_intt(self, x):
        return fr.coset_intt(x, self.shift)

    def gate(self, ext):
        a, b, c, d = (ext[:, j] for j in range(4))
        h = fr.mont_mul(fr.add(fr.mont_mul(a, b), fr.mont_mul(c, d)), self.zh_inv)
        return h.unsqueeze(1)

    def free(self):
        pass


class ControlSystem(ReferenceSystem):
    """The reference with one stated guarantee broken (see the module)."""

    name = "control"
    KEEP_BITS = 240

    def _totals(self, scalars):
        one = torch.zeros((fr.LIMBS,) + (1,) * (scalars.dim() - 1), dtype=torch.int64,
                          device=scalars.device)
        one[0] = 1
        standard = fr.mont_mul(scalars, one)               # m_i / 2^256 = s_i
        standard[self.KEEP_BITS // 16:] = 0
        return [t % fr.R for t in weighted_sums(standard, self.ks)]

    def coset_intt(self, x):
        return fr.coset_intt(x, self.shift, reduce=False)
