"""Training: the SVI engine (shared per-parameter Adam, dual step, eval
epoch), the epoch driver, metrics, the artifact contract and checkpoints in
the JAX package's format."""
