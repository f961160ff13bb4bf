from .ops import IMPLS, decentlam_update, fused_plane_stage, fused_stage, make_plane_stage, make_stage

__all__ = ["IMPLS", "decentlam_update", "fused_plane_stage", "fused_stage", "make_plane_stage",
           "make_stage"]
