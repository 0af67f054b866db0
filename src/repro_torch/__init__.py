"""FAVOR on PyTorch and CUDA: the port of the JAX package ``repro``.

Import-light on purpose: nothing here touches a device, builds a kernel or
imports torch.  The public API lives in ``repro_torch.core``; the hand-written
CUDA kernels in ``repro_torch.kernels`` (sources in ``repro_torch/csrc``) are
compiled at first use.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``.
"""
__version__ = "0.1.0"
