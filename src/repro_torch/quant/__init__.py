"""Compressed-domain distance computation for FAVOR (the quantization
subsystem of the port).

Modules:
  pq.py  -- codebook training (k-means per subspace on the device),
            encode/decode, the scalar-quantization fallback, npz persistence
  adc.py -- per-query LUT construction, compressed filtered scans
            (``pq_prefbf_topk`` / ``sq_prefbf_topk``) under the DNF filter
            programs of core.filters, finishing with an exact re-rank

The PQ scan is the ``pq_adc_topr`` kernel (repro_torch/kernels/pq_adc).
"""
from .pq import (PQCodebook, SQCodebook, decode, encode, load_codebook,
                 save_codebook, train_pq, train_sq)
from .adc import build_luts, pq_prefbf_topk, sq_prefbf_topk

__all__ = [
    "PQCodebook", "SQCodebook", "build_luts", "decode", "encode",
    "load_codebook", "pq_prefbf_topk", "save_codebook", "sq_prefbf_topk",
    "train_pq", "train_sq",
]
