"""orb_slam3_modified_tpu_torch — the PyTorch/CUDA port of orb_slam3_modified_tpu.

The JAX package `orb_slam3_modified_tpu` is the reference; every module here
keeps its counterpart's path (``lie/so3.py`` <-> ``lie/so3.py``) so a reader
finds each pair. This package imports torch and numpy only, never JAX and
never the reference package.

Entry points (modules and constructors that create tensors) take
``device=`` and default to ``"cuda"``; without a card they raise unless the
caller asks for the CPU. Plain functions follow the device of their inputs.
"""
import torch

# Pose math (3x3 / 6x6 solves, pose chains, jacobians) needs true float32
# products: the reference sets jax_default_matmul_precision="highest" for the
# same reason. A float32 matmul already runs in full fp32 by default on the
# card, but cuDNN convolutions default to TF32; state and set both.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point builds on; never falls back silently.

    Raises when a CUDA device is asked for and torch sees none.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
