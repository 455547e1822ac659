"""Device resolution for the port's entry points.

An entry point runs on the card unless its caller asks for the CPU. It never
carries on on the CPU by itself: with no card and no device named, it raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the first CUDA card; ``"cpu"`` (as the tests pass) or
    any torch device string is taken as given. Turns TF32 off for both
    matmul and cuDNN, so float32 means float32 on the card as on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for, but no CUDA "
                               "device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
