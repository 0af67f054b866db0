"""Training on PyTorch: the optimizers (AdamW, SGD with momentum), the
train step (gradients by ``torch.autograd.grad``, microbatch accumulation,
compression hook, in-place updates), int8 gradient compression with error
feedback, the npz checkpoint format of the JAX package, and the
fault-tolerant loop."""
