"""Checkpoints in the JAX package's format; the SVI trainer is the training
slice's work."""
