"""structured latent ODEs in PyTorch, with hand-written CUDA kernels for Hopper.

A port of ``structured_latent_odes_tpu`` (JAX/XLA/Pallas), which stays in the
repository as the reference. Module paths and function names follow the JAX
package so that each module's counterpart is easy to find; inside, the code is
plain PyTorch on tensors with an explicit ``device`` and explicit seeds.

The port imports neither ``jax`` nor any module of the JAX package: what it
needs of the latter's numpy-only code (configs, tableaus, transforms, loader
helpers) it keeps as its own copy.

Status: everything the JAX package does on one device: serving, training
(with checkpoints, batch-exact resume, a profiler trace and the plots), the
sweeps and the eval of the CVS, proc and challenge workloads, with the four
kernels of the ODE solve, forward and backward (``ops/recurrence.py``,
``ops/fused_step.py``). What is left, the layouts over several devices, is
listed in ROADMAP.md.
"""
