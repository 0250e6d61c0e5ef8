"""The least time each ODE kernel call needs, frozen for the benchmark: a
copy of ``chip_smoke.py:314-315`` and ``:520-560`` (``k1_bound_ms``,
``k1_bwd_bound_ms``, ``k_params``, ``k2_bound_ms``, ``k3_bound_ms``,
``bound``): bytes (each input read once, each output written once) and
operations from the call's shapes, against one H100 SXM's 3.35 TB/s and
67 TFLOP/s float32 outside the tensor cores (NVIDIA's data sheet, dense,
at the 700 W limit).

K1 and K1-bwd (``affine_scan_{fwd,bwd}_kernel``) take ``T`` steps over
``M`` lanes (trajectories x state width); K2 and K3
(``fused_semilinear_{fwd,bwd}_kernel``) ``B`` trajectories over ``T``
points with ``S`` stages, hidden width ``H`` and state width ``D``, the
weights of ``members`` models.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound_ms(T: int, M: int):
    nbytes = 4 * (2 * T * M + M + (T + 1) * M)
    ops = 2 * T * M
    return bound(nbytes, ops)


def k1_bwd_bound_ms(T: int, M: int):
    """A, g and xs read once (xs rows 0..T-1: the kernel never reads row T);
    dA, dB, dx0 written once; 3 flops per lane-step."""
    nbytes = 4 * (T * M + (T + 1) * M + T * M + 2 * T * M + M)
    return bound(nbytes, 3 * T * M)


def k_params(H: int, D: int) -> int:
    """The fused kernels' packed weights: w_t, W_a, b_a, W_d, b_d."""
    return H + 2 * D * H + 2 * D


def k2_bound_ms(B: int, T: int, S: int, H: int, D: int, members: int = 1):
    """B trajectories in all (over ``members`` weight sets)."""
    nbytes = 4 * (B * H + B * D + members * k_params(H, D) + (T - 1) * (S + 1) + T * D * B)
    ops = B * (T - 1) * S * (4 * D * H + 2 * H)
    return bound(nbytes, ops)


def k3_bound_ms(B: int, T: int, S: int, H: int, D: int, members: int = 1):
    """u, the weights, the tables, xs and g read once; du, dx0 and the weight
    gradients written once (B trajectories in all, over ``members`` weight
    sets). The stage recompute is S(4DH + 2H) flops per trajectory-step and
    the VJP S(8DH + 4H)."""
    nbytes = 4 * (B * H + members * k_params(H, D) + (T - 1) * (S + 1) + 2 * T * D * B + B * H + B * D
                  + members * k_params(H, D))
    ops = B * (T - 1) * S * (12 * D * H + 6 * H)
    return bound(nbytes, ops)


def call_bound_ms(kernel: str, shapes):
    """The bound in ms of one call of the device record ``kernel`` at the
    cell's ODE ``shapes`` (B trajectories in all, T points, S stages, H, D,
    members), or None for a record that is no ODE kernel. K3's partial sums
    (``reduce_partials``) are part of K3's work and add no bound of their
    own: 0."""
    B, T, S, H, D, members = (shapes[k] for k in ("B", "T", "S", "H", "D", "members"))
    if "affine_scan_fwd_kernel" in kernel:
        return k1_bound_ms(T - 1, B * D)[0]
    if "affine_scan_bwd_kernel" in kernel:
        return k1_bwd_bound_ms(T - 1, B * D)[0]
    if "fused_semilinear_fwd_kernel" in kernel:
        return k2_bound_ms(B, T, S, H, D, members)[0]
    if "fused_semilinear_bwd_kernel" in kernel:
        return k3_bound_ms(B, T, S, H, D, members)[0]
    if "reduce_partials" in kernel:
        return 0.0
    return None
