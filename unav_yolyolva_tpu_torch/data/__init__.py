"""Inputs of the port. The feature-file pipeline (the JAX package's data/)
is not ported yet; `synthetic` makes in-memory eval and train batches."""
