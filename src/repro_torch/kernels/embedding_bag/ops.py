"""Wrapper and plain version of the EmbeddingBag kernel
(``csrc/embedding_bag.cu``; replaces the TPU kernel
``src/repro/kernels/embedding_bag/kernel.py:embedding_bag_pallas``).

Contract of the JAX package's ``ops.embedding_bag``: table (V, d) f32,
bags (B, L) int32 padded with -1 -> (B, d) f32, each bag the sum (``mode=
"sum"``) or mean (``mode="mean"``, divided by max(valid count, 1)) of the
rows its ids name; an all-pad bag is 0 in both modes.  Ids outside [0, V)
count as pad ids.

The sum runs in bag order from l = 0, one ``+`` per id with 0 added for a
pad id -- the sequence the Pallas kernel's ``out += where(valid, row, 0)``
over its sequential l axis computes -- so the kernel, the plain version and
Pallas interpret mode agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _common as C
from .. import check_status, count_launch, counted, library

NAME = "embedding_bag"
MODES = ("sum", "mean")
_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
             + [ctypes.c_void_p] * 2)


def _fn():
    fn = library(NAME).embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(table, bags, mode):
    if mode not in MODES:
        raise ValueError(f"{NAME}: mode must be one of {MODES}, got {mode!r}")
    dev = table.device
    C.check(NAME, "table", table, torch.float32, (None, None), dev)
    C.check(NAME, "bags", bags, torch.int32, (None, None), dev)


def embedding_bag_work(table, bags, *, mode: str = "sum"):
    """(FLOPs, bytes) of one call: the ids and every distinct row the valid
    ids name read once (every id on ``meta``), the bags' rows written once;
    one add per (valid id, element)."""
    d = table.shape[1]
    if bags.device.type == "meta":
        n = rows = bags.numel()
    else:
        ok = bags >= 0
        n, rows = int(ok.sum()), int(torch.unique(bags[ok]).numel())
    return n * d, (C.nbytes(bags) + rows * d * table.element_size()
                   + bags.shape[0] * d * 4)


@counted(NAME, embedding_bag_work)
def embedding_bag(table, bags, *, mode: str = "sum"):
    """EmbeddingBag(table (V, d) f32, bags (B, L) int32 -1-padded) ->
    (B, d) f32.  CPU tensors run ``embedding_bag_plain``; CUDA tensors
    launch the kernel."""
    _check(table, bags, mode)
    if not C.on_cuda(table):
        return embedding_bag_plain(table, bags, mode=mode)
    C.require_cuda(NAME)
    (b, length), (v, d) = bags.shape, table.shape
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    if b * d:
        status = _fn()(C.ptr(bags), C.ptr(table), b, length, v, d,
                       int(mode == "mean"), C.ptr(out),
                       C.stream_ptr(table.device))
        check_status(NAME, status)
        count_launch(NAME)
    return out


def embedding_bag_plain(table, bags, *, mode: str = "sum"):
    """The kernel's function in plain torch: one gathered id column at a
    time, added in l order (not ``torch.sum``, whose order differs)."""
    if mode not in MODES:
        raise ValueError(f"{NAME}: mode must be one of {MODES}, got {mode!r}")
    ok = (bags >= 0) & (bags < table.shape[0])
    safe = torch.where(ok, bags, 0).long()
    out = torch.zeros((bags.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for col in range(bags.shape[1]):
        out = out + torch.where(ok[:, col, None], table[safe[:, col]], 0.0)
    if mode == "mean":
        cnt = torch.zeros((bags.shape[0],), dtype=torch.float32,
                          device=table.device)
        for col in range(bags.shape[1]):
            cnt = cnt + ok[:, col].to(torch.float32)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out
