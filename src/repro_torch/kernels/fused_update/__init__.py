from .ops import IMPLS, decentlam_update, fused_stage, make_stage

__all__ = ["IMPLS", "decentlam_update", "fused_stage", "make_stage"]
