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


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (dicts of tensors included; None
    skipped): each read once."""
    out = 0
    for t in tensors:
        if isinstance(t, dict):
            out += nbytes(*t.values())
        elif isinstance(t, (tuple, list)):
            out += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            out += t.numel() * t.element_size()
        elif t is not None:
            out += int(t.nbytes)
    return out


def n_valid(ids: torch.Tensor) -> int:
    """The ids >= 0 a call reads rows for: this call's count (a host read),
    or every id on ``meta``, where values are unknown."""
    if ids.device.type == "meta":
        return ids.numel()
    return int((ids >= 0).sum())


ID_DTYPES = (torch.int32, torch.int64)


def id_dtype(t) -> torch.dtype:
    """The dtype a gather wrapper accepts for ``t``, a tensor of row ids: its
    own when int32 or int64 (the gather kernels read both), else int32, so
    that ``check`` names the mismatch."""
    return t.dtype if getattr(t, "dtype", None) in ID_DTYPES else torch.int32


def lane_mask(name: str, valid, b: int, device):
    """The optional ``valid`` (B,) lane mask as the gather kernels read it:
    None, or a bool tensor on ``device`` (converted only when it is not one
    already), checked as every kernel input is."""
    if valid is None:
        return None
    if not (isinstance(valid, torch.Tensor) and valid.dtype == torch.bool
            and valid.device == device):
        valid = torch.as_tensor(valid, dtype=torch.bool, device=device)
    check(name, "valid", valid, torch.bool, (b,), device)
    return valid


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


def after_mask(keys: torch.Tensor, ids: torch.Tensor, after):
    """(B, n) bool: which (key, id) pairs come strictly after each query's
    lower bound ``after`` = (after_d (B,), after_i (B,)) in (key, id) order;
    all True when ``after`` is None."""
    if after is None:
        return torch.ones_like(keys, dtype=torch.bool)
    ad, ai = after[0][:, None], after[1][:, None]
    return (keys > ad) | ((keys == ad) & (ids > ai))


def chain_topk(scan, k: int, kmax: int, after=None):
    """The top-``k`` of a scan whose lists hold at most ``kmax`` entries.

    ``scan(kk, after)`` returns (ids (B, kk), dists (B, kk)) sorted by
    (distance, id): the first ``kk`` pairs strictly after ``after`` (None:
    from the start), with a missing tail of distance >= BIG (or +inf) and
    id -1.  Passes of ``kmax`` are chained, each starting after the last
    pair of the one before, and concatenated: exactly the one-pass top-k,
    at one scan per ``kmax`` entries.  The chain stops early when every
    query's pass came back short; what is left is filled with -1 / +inf.
    """
    if k <= kmax:
        return scan(k, after)
    ids, dists, got = [], [], 0
    while got < k:
        kk = min(kmax, k - got)
        i, d = scan(kk, after)
        ids.append(i)
        dists.append(d)
        got += kk
        last_d, last_i = d[:, -1].contiguous(), i[:, -1].contiguous()
        if got < k and not bool((last_d < BIG).any()):
            break
        after = (last_d, last_i)
    out_i, out_d = torch.cat(ids, dim=1), torch.cat(dists, dim=1)
    if got < k:
        b = out_i.shape[0]
        out_i = torch.cat([out_i, out_i.new_full((b, k - got), -1)], dim=1)
        out_d = torch.cat([out_d, out_d.new_full((b, k - got),
                                                 float("inf"))], dim=1)
    return out_i, out_d


def stable_topk(keys, k: int, *cols):
    """The ``k`` smallest ``keys`` of each row, ascending, and every
    companion column (ids, TD bits, ...) gathered in the same order.

    ``keys`` is a (B, n) tensor, or a list of (B, n_j) blocks that are
    concatenated along dim 1 in the order given; each of ``cols`` is then
    a list of blocks shaped like the keys' (a single block is used as it
    is: no concatenation, no copy).  Tie rule, the one every top-k of the
    port follows: an earlier input wins an exact tie, and within an input
    the lower column wins -- so a merge that passes its carried entries
    first keeps them.  ``torch.topk`` makes no such promise; a stable sort
    does, as the reference's ``jnp.argsort`` and ``lax.top_k`` do.
    Returns (keys (B, k), *cols (B, k)), fewer than ``k`` columns where
    the inputs hold fewer.
    """
    if isinstance(keys, (list, tuple)):
        keys = torch.cat(keys, dim=1)
        cols = [torch.cat(c, dim=1) for c in cols]
    order = torch.sort(keys, dim=1, stable=True).indices[:, :k]
    return (keys.gather(1, order), *(c.gather(1, order) for c in cols))


ROW_BLOCK = 8   # queries per GEMM in ``rows_mm``


def rows_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b.T`` for a (B, d) and b (N, d) as one batched matmul of
    (ROW_BLOCK, d) @ (d, N) products: ``a`` zero-padded to whole blocks,
    ``b.T`` broadcast over the blocks (stride 0, not copied).  A BLAS picks
    its kernel -- and so the summation order -- by the problem shape (a
    single row goes to a GEMV on the CPU), so a row's dots would otherwise
    depend on the batch width; bucket padding needs them not to.
    """
    rows = a.shape[0]
    pad = (-rows) % ROW_BLOCK
    if pad:
        a = torch.cat([a, a.new_zeros((pad, a.shape[1]))])
    blocks = a.reshape(-1, ROW_BLOCK, a.shape[1])
    out = torch.bmm(blocks, b.T.expand(blocks.shape[0], -1, -1))
    return out.reshape(-1, b.shape[0])[:rows]


def no_tf32(device) -> None:
    """The plain versions' matmuls must be IEEE f32 on the card too."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
