from .field_adapters import FQ_ADAPTER
from . import projective, g1

__all__ = ["FQ_ADAPTER", "projective", "g1"]
