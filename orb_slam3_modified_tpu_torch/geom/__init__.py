"""Two-view geometry + triangulation (port of orb_slam3_modified_tpu/geom)."""
from .triangulation import (
    depth_and_reproj_checks,
    projection_matrix,
    triangulate_dlt,
    triangulate_rays,
)
from .two_view import TwoViewResult, reconstruct_two_views

__all__ = [
    "triangulate_dlt",
    "triangulate_rays",
    "projection_matrix",
    "depth_and_reproj_checks",
    "reconstruct_two_views",
    "TwoViewResult",
]
