"""The model zoo on PyTorch: the decoder-only LM (five architectures), the
recsys models (FM, Wide&Deep, DIEN, DLRM) with FAVOR as their retrieval
layer, and the GCN.  Functions over param trees (nested dicts of tensors),
as in the JAX package, plus one ``nn.Module`` per family."""
