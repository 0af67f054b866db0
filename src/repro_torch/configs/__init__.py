"""Configurations of the port: ``favor_anns`` (the paper's own system at
production scale).  The JAX package's other configurations (the models
off the FAVOR path) come with their slice of the port."""
