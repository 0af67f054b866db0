"""The port's device rule, in one place every module can import: entry
points run on the CUDA device unless the caller asks for another one."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the FAVOR port runs on the card "
            "unless the caller passes device='cpu'")
    return dev
