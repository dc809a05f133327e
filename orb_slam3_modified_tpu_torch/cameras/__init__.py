"""Camera models (port of orb_slam3_modified_tpu/cameras)."""
from .models import (
    FISHEYE_KB8,
    PINHOLE,
    Camera,
    project,
    project_jac,
    project_np,
    unproject,
    unproject_np,
)

__all__ = [
    "Camera",
    "PINHOLE",
    "FISHEYE_KB8",
    "project",
    "unproject",
    "project_np",
    "unproject_np",
    "project_jac",
]
