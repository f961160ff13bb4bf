from .ops import flash_attention
from .ref import reference_attention

__all__ = ["flash_attention", "reference_attention"]
