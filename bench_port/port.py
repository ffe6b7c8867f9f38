"""The system under test: ``tpu_bls12_381_torch``, called as a prover calls it.

Set-up uploads the bases once through ``MsmContext.upload_bases`` with the
configuration's precompute factor and builds the extended domain with
``NttContext``; a round then commits with ``msm_with_bases`` (one scalar
set) or ``msm_batch`` (several against the shared bases), converts with
``to_affine`` and copies the points to the host, and transforms with
``NttContext``'s inverse and coset calls and the ``vecops`` products and
sums.  Nothing here computes: every operation is the program's.
"""

from __future__ import annotations

import torch

TRANSFORMS = {"intt", "coset_ntt", "coset_intt"}


class PortSystem:
    name = "port"

    def __init__(self, inputs, config: dict, device, ops: set):
        from tpu_bls12_381_torch import vecops
        from tpu_bls12_381_torch.fields import FR
        from tpu_bls12_381_torch.runtime.msm_context import g1_context
        from tpu_bls12_381_torch.runtime.ntt_context import NttContext

        self._vecops, self._fr = vecops, FR
        self.shift = config["coset_shift"]
        self.zh_inv = inputs.zh_inv
        self.ctx = self.bases = self.ntt = None
        if inputs.bases is not None:
            self.ctx = g1_context()
            self.bases = self.ctx.upload_bases(inputs.bases,
                                               precompute_factor=config["precompute_factor"])
        if ops & TRANSFORMS:
            self.ntt = NttContext(max_log_n=config["extended_log_n"], device=device)

    def stages(self):
        """The program's own stage marks (``runtime/tracing.py``), summed in
        ms by CUDA events over the block."""
        from tpu_bls12_381_torch.runtime.tracing import collect_stages

        return collect_stages()

    def msm(self, scalars):
        """(16, B, N) Montgomery scalars -> B Jacobian points, (24, B) each."""
        if scalars.shape[1] == 1:
            P = self.ctx.msm_with_bases(scalars[:, 0], self.bases)
            return tuple(c.reshape(-1, 1) for c in P)
        points = self.ctx.msm_batch([scalars[:, j] for j in range(scalars.shape[1])],
                                    self.bases)
        return tuple(torch.stack([p[c] for p in points], dim=-1) for c in range(3))

    def to_host(self, P):
        x, y, inf = self.ctx.to_affine(P)
        return torch.cat((x, y, inf.reshape(1, -1).to(x.dtype))).cpu()

    def intt(self, x):
        return self.ntt.inverse(x)

    def coset_ntt(self, x):
        return self.ntt.coset_forward(x, self.shift)

    def coset_intt(self, x):
        return self.ntt.coset_inverse(x, self.shift)

    def gate(self, ext):
        """h = (a b + c d) / Z_H on the extended coset, from its 4 columns."""
        mul, add, FR = self._vecops.vector_mul, self._vecops.vector_add, self._fr
        ab = mul(FR, ext[:, 0], ext[:, 1])
        cd = mul(FR, ext[:, 2], ext[:, 3])
        return mul(FR, add(FR, ab, cd), self.zh_inv).unsqueeze(1)

    def free(self):
        """Drop the program's state: bases, contexts and its cached tables."""
        from tpu_bls12_381_torch.ntt.domain import release_domain
        from tpu_bls12_381_torch.ntt.ntt import release_coset_cache

        self.ctx = self.bases = self.ntt = None
        release_domain()
        release_coset_cache()
        self._vecops.release_bit_reverse()
