"""The dry run of every (architecture x shape) cell on the production mesh,
over ``meta`` tensors (nothing is allocated and no device is touched), and
the perf variants over it."""
