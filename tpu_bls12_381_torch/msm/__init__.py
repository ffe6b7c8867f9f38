from .pippenger import (
    msm,
    msm_g1,
    msm_g2,
    msm_geometry,
    msm_precomputed,
    msm_batch_shared,
    expand_bases,
    precompute_window_span,
    num_windows,
    decompose_signed_digits,
    decompose_window_keys,
    window_bits_for,
)

__all__ = [
    "msm",
    "msm_g1",
    "msm_g2",
    "msm_geometry",
    "msm_precomputed",
    "msm_batch_shared",
    "expand_bases",
    "precompute_window_span",
    "num_windows",
    "decompose_signed_digits",
    "decompose_window_keys",
    "window_bits_for",
]
