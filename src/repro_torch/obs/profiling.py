"""Kernel profiling hooks: host-side ranges around the dispatch sites.

``annotate(name)`` returns a ``torch.profiler.record_function(name)``
context while ``set_kernel_annotations(True)`` is in force, and a
``nullcontext`` otherwise (``Obs.annotate`` reaches it).  The serving
path itself takes its ranges from the trace's spans (``obs.trace``:
``favor/<span path>``, ``favor/graph/search`` around the traversal,
``favor/brute/search`` around the scans), so a ``torch.profiler`` capture
attributes kernel time to the router's stages.  The ``Obs`` facade flips
the switch when ``ObsSpec.kernel_annotations`` is set; off, the hook costs
one global read.

The counterpart of the JAX package's ``jax.profiler.TraceAnnotation``
scopes.  Its trace-time ``jax.named_scope`` metadata has no counterpart:
the port's kernels are launched eagerly, one call each, and a capture names
them itself.
"""
from __future__ import annotations

from contextlib import nullcontext

_KERNEL_ANNOTATIONS = False


def set_kernel_annotations(on: bool) -> None:
    """Globally enable/disable host-side dispatch annotations.  Switching
    them on enters and leaves one range, so that torch's set-up of the
    profiler's ops on their first call (~0.3 ms) falls there and not in the
    first annotated span."""
    global _KERNEL_ANNOTATIONS
    if on and not _KERNEL_ANNOTATIONS:
        import torch
        with torch.profiler.record_function("annotations_on"):
            pass
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
