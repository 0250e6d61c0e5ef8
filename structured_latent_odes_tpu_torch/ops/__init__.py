"""Hand-written CUDA kernels (sources in ``csrc/``) with their plain PyTorch
versions: K1 ``recurrence.affine_scan_tm`` and K2
``fused_step.fused_semilinear_fwd``."""
