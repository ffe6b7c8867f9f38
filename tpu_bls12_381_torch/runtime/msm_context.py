"""MSM context: device-resident cached bases, precompute, batch, async.

Counterpart of the JAX package's ``runtime/msm_context.py``: bases are
uploaded once (optionally expanded by a precompute factor and, on G1,
GLV-extended) and reused across many MSMs, which is a PLONK/KZG prover's hot
path: every commitment is ``msm_with_bases`` or ``msm_batch`` against the
same SRS.  The async variants return :class:`AsyncHandle`s (a CUDA event on
the stream the work was queued on); the batch variants run many scalar sets
against shared bases in one batched pipeline.  One class serves both curves:
``g1_context()`` over ``FQ_ADAPTER``, ``g2_context()`` over ``FQ2_ADAPTER``.

Everything runs where the tensors live.  ``warmup`` makes its own inputs and
takes ``device=None`` = the card.  ``upload_bases`` and ``msm`` open the JAX
package's ``msm`` spans (``runtime/tracing.py::span``, MIDNIGHT_TRACE).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from ..curves import points as pt
from ..curves.field_adapters import FQ2_ADAPTER, FQ_ADAPTER
from ..fields.ops import LIMB_DTYPE
from ..msm import pippenger
from .config import config
from .handles import AsyncHandle
from .tracing import span


@dataclass
class PrecomputedBases:
    """Device-resident (possibly expanded) affine bases and their metadata.

    The metadata travels with the buffer: window size, factor and the GLV
    extension are baked into the expansion, and an MSM that used other
    values against it would return a wrong point without any error.
    """

    A: Any  # affine batch (x, y, inf), factor*n points (2x when glv)
    n: int
    factor: int
    window_bits: int
    glv: bool = False

    @property
    def is_precomputed(self) -> bool:
        return self.factor > 1


class MsmContext:
    """MSM orchestration for one curve (G1 or G2)."""

    def __init__(self, adapter, name: str = "g1"):
        self.F = adapter
        self.name = name

    # --- base management ----------------------------------------------------

    def upload_bases(self, A, *, precompute_factor: int | None = None,
                     window_bits: int | None = None,
                     glv: bool | None = None) -> PrecomputedBases:
        """Keep bases on their device, optionally expanded by a precompute
        factor (default MIDNIGHT_TPU_PRECOMPUTE).

        ``glv`` (G1 only; default from MIDNIGHT_MSM_GLV) stores
        [A || phi(A)] and expands for 128-bit scalar halves: every MSM
        against these bases then runs the GLV-split pipeline.  ``auto``
        takes GLV while the doubled and expanded set runs in one shot in the
        device memory budget.  Returns when the expansion is done.
        """
        n = A[2].shape[-1]
        factor = (config().precompute_factor
                  if precompute_factor is None else precompute_factor)
        geo = pippenger.msm_geometry(n, glv, self.F, A[2].device, window_bits,
                                     factor=factor, cached=True)
        glv, w = geo["glv"], geo["w"]
        num_bits = pippenger.GLV_HALF_BITS_STATIC if glv else pippenger.FR_BITS
        label = f"{self.name}.precompute_bases[f={factor}]"
        with span("msm", label):
            if glv:
                A = pippenger.glv_extend_bases(self.F, A)
            A_exp = AsyncHandle(
                pippenger.expand_bases(self.F, A, w, factor, num_bits)).wait()
        return PrecomputedBases(A=A_exp, n=n, factor=factor, window_bits=w,
                                glv=glv)

    # --- sync MSM -------------------------------------------------------------

    def msm(self, scalars, A, *, window_bits: int | None = None,
            scalars_montgomery: bool = True):
        """One MSM against ad-hoc bases; returns a Jacobian point when it is
        ready."""
        label = f"{self.name}.msm[n={A[2].shape[-1]}]"
        with span("msm", label):
            out = self.msm_async(scalars, A, window_bits=window_bits,
                                 scalars_montgomery=scalars_montgomery).wait()
        return out

    def msm_with_bases(self, scalars, bases: PrecomputedBases, *,
                       scalars_montgomery: bool = True):
        """MSM against cached (possibly precomputed) bases; returns when the
        result is ready."""
        return self.msm_with_bases_async(
            scalars, bases, scalars_montgomery=scalars_montgomery).wait()

    # --- async MSM --------------------------------------------------------------

    def msm_async(self, scalars, A, *, window_bits: int | None = None,
                  scalars_montgomery: bool = True) -> AsyncHandle:
        out = pippenger.msm(
            self.F, scalars, A,
            window_bits=window_bits or config().msm_window,
            scalars_montgomery=scalars_montgomery,
        )
        return AsyncHandle(out)

    def msm_with_bases_async(self, scalars, bases: PrecomputedBases, *,
                             scalars_montgomery: bool = True) -> AsyncHandle:
        out = pippenger.msm_precomputed(
            self.F, scalars, bases.A,
            window_bits=bases.window_bits, factor=bases.factor,
            scalars_montgomery=scalars_montgomery, glv=bases.glv,
        )
        return AsyncHandle(out)

    # --- batch MSM (shared bases) -------------------------------------------------

    def msm_batch(self, scalars_list: Sequence, bases: PrecomputedBases, *,
                  scalars_montgomery: bool = True):
        return self.msm_batch_async(
            scalars_list, bases, scalars_montgomery=scalars_montgomery).wait()

    def msm_batch_async(self, scalars_list: Sequence,
                        bases: PrecomputedBases, *,
                        scalars_montgomery: bool = True) -> AsyncHandle:
        """Many MSMs sharing one base set; one handle for all results (a list
        of Jacobian points).

        One batched pipeline (``pippenger.msm_batch_shared``): the batch axis
        is folded into the tile lanes, so every per-window stage (sort,
        shared-table gather, scan) runs once for all B scalar sets.
        """
        for s in scalars_list:
            if s.shape[-1] != bases.n:
                raise ValueError(
                    f"batch MSM scalar count {s.shape[-1]} != base count {bases.n}")
        if len(scalars_list) == 1:
            out = pippenger.msm_precomputed(
                self.F, scalars_list[0], bases.A,
                window_bits=bases.window_bits, factor=bases.factor,
                scalars_montgomery=scalars_montgomery, glv=bases.glv,
            )
            return AsyncHandle([out])
        sc_b = torch.stack(list(scalars_list), dim=1)  # (16, B, N)
        P = pippenger.msm_batch_shared(
            self.F, sc_b, bases.A,
            window_bits=bases.window_bits, factor=bases.factor,
            scalars_montgomery=scalars_montgomery, glv=bases.glv,
        )
        return AsyncHandle([tuple(c[..., i] for c in P)
                            for i in range(len(scalars_list))])

    # --- misc -------------------------------------------------------------------

    def warmup(self, n: int = 256, *, factor: int = 1,
               window_bits: int | None = None, device=None) -> None:
        """Run one MSM of ``n`` generator points with scalar 1, through the
        cached-bases path when ``factor`` > 1.  On the card this builds and
        loads the kernels and pays the first call's allocations, so that the
        first real MSM does not."""
        if self.name == "g1":
            from ..curves import g1 as curve
        else:
            from ..curves import g2 as curve
        A = curve.generator_affine((n,), device)
        scalars = torch.zeros((16, n), dtype=LIMB_DTYPE, device=A[2].device)
        scalars[0] = 1
        if factor > 1:
            bases = self.upload_bases(A, precompute_factor=factor,
                                      window_bits=window_bits)
            self.msm_with_bases(scalars, bases)
        else:
            AsyncHandle(pippenger.msm(self.F, scalars, A, window_bits=window_bits,
                                      scalars_montgomery=True)).wait()

    def to_affine(self, P):
        return pt.jac_to_affine(self.F, P)


def g1_context() -> MsmContext:
    return MsmContext(FQ_ADAPTER, "g1")


def g2_context() -> MsmContext:
    return MsmContext(FQ2_ADAPTER, "g2")
