from . import se3, so3  # noqa: F401
from .se3 import SE3  # noqa: F401
