"""Hand-written CUDA kernels (sources in ``csrc/``) with their plain PyTorch
versions: K1 and K1-bwd ``recurrence.affine_scan_fwd``/``affine_scan_bwd``,
K2 and K3 ``fused_step.fused_semilinear_fwd``/``fused_semilinear_bwd``,
the conv encoder's front end ``conv_encoder.conv_pool_fwd``/``conv_pool_wgrad``,
the draws' counter hash ``counter_normal.counter_normal``/``counter_fold``,
and the shared Adam's update of many leaves ``multi_adam.multi_adam``."""
