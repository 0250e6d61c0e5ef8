"""structured latent ODEs in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``structured_latent_odes_tpu`` (JAX/XLA/Pallas), which stays in the
repository as the reference. Module paths and function names follow the JAX
package so that each module's counterpart is easy to find; inside, the code is
plain PyTorch on tensors with an explicit ``device`` and explicit seeds.

The port imports neither ``jax`` nor any module of the JAX package: what it
needs of the latter's numpy-only code (configs, tableaus, transforms, loader
helpers) it keeps as its own copy.

Slice status: the CVS serving path (``serve.py``) end to end, with the two
forward kernels of the ODE solve (``ops/recurrence.py``, ``ops/fused_step.py``).
Training and the backward kernels are the next slice (see ROADMAP.md).
"""
