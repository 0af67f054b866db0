"""Kernel profiling hooks: host-side ranges around the dispatch sites.

``annotate(name)`` returns a ``torch.profiler.record_function(name)``
context while ``set_kernel_annotations(True)`` is in force, and a
``nullcontext`` otherwise.  Wrapped around the backend's scans and
traversal (``favor/local/*``, ``favor/sharded/*``), it brackets the host
span that enqueues (and, for the graph route, waits on) the device work,
so a ``torch.profiler`` capture attributes kernel time to routes.  The
router's stages get their ranges from the trace's spans instead
(``obs.trace``: ``favor/<span path>``).  The ``Obs`` facade flips the
switch when ``ObsSpec.kernel_annotations`` is set; off, the hook costs one
global read.

The counterpart of the JAX package's ``jax.profiler.TraceAnnotation``
scopes.  Its trace-time ``jax.named_scope`` metadata has no counterpart:
the port's kernels are launched eagerly, one call each, and a capture names
them itself.
"""
from __future__ import annotations

from contextlib import nullcontext

_KERNEL_ANNOTATIONS = False


def set_kernel_annotations(on: bool) -> None:
    """Globally enable/disable host-side dispatch annotations."""
    global _KERNEL_ANNOTATIONS
    _KERNEL_ANNOTATIONS = bool(on)


def kernel_annotations_enabled() -> bool:
    return _KERNEL_ANNOTATIONS


def annotate(name: str):
    """A ``record_function`` range named ``name`` (nullcontext when
    annotations are off)."""
    if not _KERNEL_ANNOTATIONS:
        return nullcontext()
    import torch
    return torch.profiler.record_function(name)
