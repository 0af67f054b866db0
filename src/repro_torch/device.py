"""The port's device rule, in one place every module can import: entry
points run on the CUDA device unless the caller asks for another one; and
``to_host``, the one way a result crosses back to numpy."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the FAVOR port runs on the card "
            "unless the caller passes device='cpu'")
    return dev


def to_host(a) -> np.ndarray:
    """A numpy array of ``a``: a tensor on any device is copied with
    ``.cpu()`` (which waits for the work that produces it); anything else
    goes through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)
