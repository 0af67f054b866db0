"""Checks and helpers shared by the kernel wrappers."""
from __future__ import annotations

import ctypes

import torch

BIG = 3.0e38  # "missing" marker inside the kernels; wrappers map it to +inf

PROGRAM_DTYPES = {"valid": torch.float32, "imask": torch.int64,
                  "flo": torch.float32, "fhi": torch.float32}


def on_cuda(t: torch.Tensor) -> bool:
    """Route rule of every wrapper: CPU tensors take the plain version, CUDA
    tensors the kernel."""
    return t.device.type == "cuda"


def require_cuda(name: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA tensors given but no CUDA device is "
                           "available; pass CPU tensors for the plain version")


def check(name: str, arg: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise ValueError unless ``t`` has the dtype, shape (None = any extent)
    and device given and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {arg} must be a torch.Tensor, "
                        f"got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {arg} must start on a 16-byte boundary "
                         "(the kernels read rows as float4)")


def check_programs(name: str, programs: dict, b: int, mi: int, mf: int,
                   device) -> int:
    """Validate a stacked program dict for ``b`` queries; returns its width."""
    w = int(programs["valid"].shape[1]) if programs["valid"].dim() == 2 else -1
    shapes = {"valid": (b, w), "imask": (b, w, mi), "flo": (b, w, mf),
              "fhi": (b, w, mf)}
    for key, shape in shapes.items():
        check(name, f"programs[{key!r}]", programs[key], PROGRAM_DTYPES[key],
              shape, device)
    return w


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def apply_missing(ids: torch.Tensor, dists: torch.Tensor, valid):
    """BIG -> (-1, +inf), and the ``valid`` (B,) lane mask."""
    missing = dists >= BIG
    if valid is not None:
        missing = missing | ~torch.as_tensor(
            valid, dtype=torch.bool, device=dists.device)[:, None]
    return (torch.where(missing, torch.full_like(ids, -1), ids),
            torch.where(missing, torch.full_like(dists, float("inf")), dists))


def no_tf32(device) -> None:
    """The plain versions' matmuls must be IEEE f32 on the card too."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
