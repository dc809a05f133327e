from .depth import (  # noqa: F401
    DepthSegNet,
    default_depth_model,
    load_depth_model,
    make_depth_fn,
    make_seg_fn,
)
