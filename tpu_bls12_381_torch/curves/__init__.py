from .field_adapters import FQ2_ADAPTER, FQ_ADAPTER
from . import projective, g1, g2, points

__all__ = ["FQ_ADAPTER", "FQ2_ADAPTER", "projective", "g1", "g2", "points"]
