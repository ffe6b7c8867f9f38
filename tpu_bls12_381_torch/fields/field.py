"""Field specifications: moduli + derived Montgomery constants as limb arrays.

Own copy of the JAX package's ``fields/field.py`` (numpy only): the
constants for 16-bit limbs, plus the 32-bit-word constants that the CUDA
kernels hold in ``csrc/field.cuh``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

from .. import constants
from .limbs import LIMB_BITS, int_to_limbs


@dataclass(frozen=True)
class FieldSpec:
    name: str
    modulus: int
    num_limbs: int  # 16-bit limbs

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def r(self) -> int:
        """Montgomery R = 2^(16*K)."""
        return 1 << (LIMB_BITS * self.num_limbs)

    @cached_property
    def r2(self) -> int:
        return self.r * self.r % self.modulus

    @cached_property
    def n0_inv(self) -> int:
        """-modulus^{-1} mod 2^16 (per-limb Montgomery factor)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @cached_property
    def n0_inv32(self) -> int:
        """-modulus^{-1} mod 2^32: the factor of the kernels' 32-bit CIOS."""
        return (-pow(self.modulus, -1, 1 << 32)) % (1 << 32)

    # --- numpy constant limb arrays (shape (K,)) -----------------------------

    @cached_property
    def modulus_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.num_limbs)

    @cached_property
    def r2_limbs(self) -> np.ndarray:
        return int_to_limbs(self.r2, self.num_limbs)

    @cached_property
    def one_mont_limbs(self) -> np.ndarray:
        """R mod p — the Montgomery image of 1."""
        return int_to_limbs(self.r % self.modulus, self.num_limbs)

    @cached_property
    def zero_limbs(self) -> np.ndarray:
        return np.zeros(self.num_limbs, dtype=np.uint32)

    def to_mont(self, x: int) -> int:
        return x * self.r % self.modulus

    def from_mont(self, x: int) -> int:
        return x * pow(self.r, -1, self.modulus) % self.modulus


FR = FieldSpec("Fr", constants.FR_MODULUS, 16)
FQ = FieldSpec("Fq", constants.FQ_MODULUS, 24)
