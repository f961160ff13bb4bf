from .kernel import gemm_launch, gemm_plain
from .ops import linear, routes

__all__ = ["gemm_launch", "gemm_plain", "linear", "routes"]
