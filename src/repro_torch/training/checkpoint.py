"""Fault-tolerant checkpointing: flat-key npz shards with atomic rename,
retention, async save, and restore onto devices -- the JAX package's
on-disk format, so a checkpoint either package writes restores in the
other.

Layout:  <dir>/step_<N>/shard_<host>.npz + meta.json, written to a tmp dir
and atomically renamed only after every array is flushed (a preempted save
can never corrupt the latest good checkpoint).  ``latest_step`` scans for
complete checkpoints (meta.json present).  Tensors are read to the host
through ``device.to_host``; bf16 tensors are stored as their 2-byte bit
patterns (numpy's ``|V2``, which is what ``np.savez`` writes for the JAX
package's ml_dtypes bfloat16).  ``restore`` returns numpy, as the JAX
function does, or -- given ``shardings``, a tree of ``torch.device``s --
tensors on those devices (the counterpart of ``jax.device_put``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from ..device import to_host


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return tuple(fix(v) for _, v in items)
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return to_host(x.view(torch.int16)).view("V2")
    return to_host(x)


def save(ckpt_dir: str, step: int, tree, *, meta: dict | None = None,
         keep: int = 3, host_id: int = 0) -> str:
    """Atomic checkpoint write.  ``tree``: nested dicts / tuples of tensors
    (any device), numpy arrays or numbers."""
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, f"shard_{host_id}.npz"), **flat)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def save_async(ckpt_dir: str, step: int, tree, **kw) -> threading.Thread:
    """Save on a background thread.  The device -> host copy happens
    before the thread starts, so training may update its tensors in place
    at once."""
    # the flat {path: array} dict flattens to itself in ``save``
    host = {k: _host(v) for k, v in _flatten(tree).items()}
    t = threading.Thread(target=save, args=(ckpt_dir, step, host),
                         kwargs=kw, daemon=True)
    t.start()
    return t


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_complete_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)


def _complete_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
                out.append(int(name[5:]))
    return out


def latest_step(ckpt_dir: str) -> int | None:
    steps = _complete_steps(ckpt_dir)
    return max(steps) if steps else None


def device_tree(tree):
    """The ``shardings`` tree that restores a checkpoint of ``tree`` where
    ``tree`` lives: each tensor's device, None (stay numpy) for anything
    else; tuples keep their type (an ``OptState`` comes back as one)."""
    if isinstance(tree, dict):
        return {k: device_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [device_tree(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return tuple(device_tree(v) for v in tree)
    return tree.device if isinstance(tree, torch.Tensor) else None


def _to_device(x: np.ndarray, dev) -> torch.Tensor:
    if x.dtype == np.dtype("V2"):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int16)).to(
            dev).view(torch.bfloat16)
    return torch.from_numpy(np.array(x)).to(dev)


def _place(node, sh):
    if isinstance(sh, dict):
        # an empty subtree has no key in the npz: it comes back empty
        return {k: _place(node[k], v) if k in node or v else v
                for k, v in sh.items()}
    if isinstance(sh, tuple):
        items = [_place(n, s) for n, s in zip(node, sh)]
        return type(sh)(*items) if hasattr(sh, "_fields") else tuple(items)
    if sh is None:
        # a host leaf; a 0-d one (a step count, a data-pipeline state) comes
        # back as the Python number it was saved from
        return node.item() if node.ndim == 0 else node
    return _to_device(node, sh)


def restore(ckpt_dir: str, step: int | None = None, *, shardings=None,
            host_id: int = 0):
    """Load a checkpoint.  Returns (tree, meta): numpy leaves, or, given
    ``shardings`` (a tree of the checkpoint's structure whose leaves are
    ``torch.device``s, or None for a host leaf; ``device_tree``), tensors
    on those devices, host leaves as numpy (0-d ones as Python numbers)
    and tuples of the shardings' tuple types."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    z = np.load(os.path.join(d, f"shard_{host_id}.npz"))
    tree = _unflatten({k: z[k] for k in z.files})
    if shardings is not None:
        tree = _place(tree, shardings)
    return tree, meta
