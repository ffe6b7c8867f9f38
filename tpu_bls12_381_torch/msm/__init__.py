from .pippenger import (
    msm,
    msm_g1,
    msm_geometry,
    num_windows,
    decompose_signed_digits,
    decompose_window_keys,
    window_bits_for,
)

__all__ = [
    "msm",
    "msm_g1",
    "msm_geometry",
    "num_windows",
    "decompose_signed_digits",
    "decompose_window_keys",
    "window_bits_for",
]
