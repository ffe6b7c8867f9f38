from .field import FQ, FR, FieldSpec
from . import ops

__all__ = ["FQ", "FR", "FieldSpec", "ops"]
