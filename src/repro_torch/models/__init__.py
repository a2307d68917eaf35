"""The model zoo for the assigned architectures, on torch tensors: the
reference's ``models`` package, layer for layer (no Pallas kernel there)."""
from . import api
from .api import LM
from .config import LMConfig, SHAPES, SUBQUADRATIC, ShapeCell, supports_shape

__all__ = ["LMConfig", "SHAPES", "ShapeCell", "supports_shape",
           "SUBQUADRATIC", "api", "LM"]
