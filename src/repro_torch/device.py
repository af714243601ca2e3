"""Where the port's tensors live.

Entry points take ``device=None`` and resolve it here: the card when CUDA
is present, and otherwise an error that says to ask for the CPU.  There is
no silent CPU fallback.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises RuntimeError without CUDA); anything
    else -> ``torch.device(device)``.

    On CUDA, fp32 matrix products and convolutions are pinned to full
    fp32: TF32 (on by default for cuDNN convolutions) keeps about three
    decimal digits, and the port is held against the fp32 reference.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' "
                "(or --device cpu) to run the port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
