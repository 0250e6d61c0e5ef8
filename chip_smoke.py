#!/usr/bin/env python3
"""Smoke run of the PyTorch port (structured_latent_odes_tpu_torch) on one
CUDA card: the quickest proof that the port builds, serves and trains on the
GPU.

    python3 chip_smoke.py              # on the card
    python3 chip_smoke.py --rehearse   # on the CPU: plain versions, tiny sizes

Phases, each fatal on any fault:

1. device: the card's name and power limit (nvidia-smi).
2. build: every kernel from csrc/, one nvcc per source and width pair, all
   started together: K2 and K3 at CVS's and challenge's (H, D) = (25, 5) and
   proc's (25, 8); prints nvcc's -Xptxas -v report.
3. kernels: K1 (affine scan), K1-bwd (its reverse sweep), K2 (fused
   semilinear solve) and K3 (its reverse sweep) against their plain PyTorch
   versions on the card: K1 and K1-bwd bit for bit at the edges of their
   batch-major layout and at the proc and challenge shapes (K1_SHAPES,
   B = 16,411 among them), K2 and K3 at the serving and training shapes and
   B = 16,411 and at the edges of their layout (B = 1, 2, 130 by T = 2, 86,
   200, every method), and at proc's (B = 36, 78 by T = 100, D = 8) and
   challenge's (B = 32, 7 by T = 142: 141 steps, two passes) shapes, every
   method; then each timed at B = 100, 128 and 16,411 and at the proc and
   challenge training shapes beside the plain version and the bound on an
   H100 SXM: the kernel's device time from a CUDA event pair right around
   each launch (queued behind a device-side sleep, so no host gap falls
   inside), and the wrapper call (argument preparation included) and the
   plain version with CUDA events after warm-up; and the whole affine_scan
   call at B = 128, forward alone and forward plus backward.
4. serving path: generates CVS with the port's make_dataset on the card, writes
   two random-weight checkpoints (seeds 0 and 1) in the JAX package's format,
   and serves them through serve.main: posterior recon, prior recon with
   --classify, and the ensemble mean of both, on the backends semilinear
   (K1), semilinear_pallas (K1), semilinear_fused (K2) and semilinear_seq
   (plain), plus one Gauss-model request. Launch counts are zeroed just before
   each backend's requests and read just after: each backend must launch its
   own forward kernel and no other. Outputs are checked for shape,
   finiteness and agreement across backends. Then a served request is timed at B = 100 and
   B = 16,411 per backend.
5. training path: training_cvs.main at full width (--num-epochs 1: epochs 0
   and 1, 14 dual steps, per-epoch val/train statistics, the final test
   evaluation) on the same data with the backends semilinear (K1, K1-bwd),
   semilinear_fused (K2, K3) and semilinear_seq (plain), plus one Gauss-model
   run. Launch counts are zeroed just before each run and read just after:
   each run must launch its backend's forward and backward kernels and no
   other (semilinear_seq none). Every logged loss must be finite, the
   artifacts must have the JAX package's shapes, and the trained checkpoint
   is served through serve.main. Then the first dual step's losses and
   gradients are compared across the three backends from one set of params
   and one seed, with the counts read per backend as above, and one dual
   step at B = 128 is timed per backend.
6. proc and challenge, served and trained at full width on the datasets in
   datasets/ (the port's loaders, no generated data): two random-weight
   checkpoints each, served through serve.main (posterior, prior with
   --classify, the ensemble mean of both) on semilinear, semilinear_fused
   and semilinear_seq plus one Gauss request; training_proc.main and
   training_challenge.main with --num-epochs 1 and the config's 200-draw
   sample bands on the same three backends plus one Gauss run, each trained
   checkpoint served; the first dual step compared across the backends; one
   dual step timed per backend (proc at B = 36, challenge at B = 32). Launch
   counts are zeroed and read per backend's requests and per run, as for CVS.

TF32 stays off for matrix products and cuDNN convolutions throughout.

Prints a {"kernels": [...]} line, then the nvidia-smi line, then the last
line {"ok": true, "device": {...}}. Without a CUDA card it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from structured_latent_odes_tpu_torch import serve, training_challenge, training_cvs, training_proc
from structured_latent_odes_tpu_torch.data.configs import LOADERS, load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import challenge_spec, cvs_spec, init_params, proc_spec
from structured_latent_odes_tpu_torch.nn.ode_model import initialize_state
from structured_latent_odes_tpu_torch.ops import _build, fused_step, recurrence
from structured_latent_odes_tpu_torch.train import checkpoint, svi
from structured_latent_odes_tpu_torch.train.driver import device_batch
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

# K1 and K1-bwd do their plain versions' float32 operations in the same
# order: held bit for bit (torch.equal)
K1_RULE = "torch.equal(out, ref): bit for bit"
# K2 and the backends, elementwise |out - ref| <= ATOL + RTOL*|ref|, the JAX
# package's own tolerance for its fused kernel (tests/test_fused_step.py):
# at random weights trajectories reach |x| of tens, where float32 roundoff
# accumulated over 85 steps differs by up to ~1e-6 relative between two
# summation orders (measured on the H100: 6.9e-5 abs at |x| = 78)
ATOL, RTOL = 1e-5, 1e-5
# K3's weight gradients (w_t, W_a, b_a, W_d, b_d) are sums over the batch,
# the steps and the stages: up to 16,411 * 85 * 4 = 5.6M float32 terms, summed
# per thread, per block and across blocks here and per step over the batch in
# the plain version. Each leaf is held to max|out - ref| <= WGRAD_RTOL *
# max|ref| of that leaf; phase 3 prints each error / tolerance.
WGRAD_RTOL = 1e-5
# K3's du (per trajectory) is a sum over the 85 * S stages of terms that
# cancel: its float32 error follows the terms, not the result, so K2's purely
# elementwise 1e-5 + 1e-5*|ref| failed by 1.6x at euler, B = 128 (H100). du is
# held to |out - ref| <= DU_ATOL * max|ref| + RTOL * |ref|; phase 3 prints
# both ratios, and the kernels line the one held.
DU_ATOL = 1e-5
# each kernel's outputs: (name, rule as printed in the kernels line)
TOLERANCE_RULES = {
    "K1": {"xs": K1_RULE},
    "K1-bwd": {name: K1_RULE for name in ("dA", "dB", "dx0")},
    "K2": {"xs": f"|out - ref| <= {ATOL:g} + {RTOL:g}*|ref|, elementwise"},
    "K3": {
        "du": f"|out - ref| <= {DU_ATOL:g}*max|ref| + {RTOL:g}*|ref|, elementwise",
        **{name: f"max|out - ref| <= {WGRAD_RTOL:g}*max|ref| of the leaf"
           for name in ("dwt", "dwa", "dba", "dwd", "dbd")},
        "dx0": f"|out - ref| <= {ATOL:g} + {RTOL:g}*|ref|, elementwise",
    },
}
# first-step gradients across the three backends: max|g - g_seq| /
# max(max|g_seq|, 1) over every leaf, the JAX package's own fused-vs-autodiff
# bound (tests/test_fused_step.py): float32 accumulation order
STEP_GRAD_TOL = 5e-3
BIG_B = 16411
TRAIN_B = 128
SERVE_B = 100
# K1 and K1-bwd (Bt, T, D) at the edges of their layout (csrc/affine_scan.cu:
# four whole trajectories per block): one step, one trajectory, a tile's
# ragged edge (3, 7, 130), 199 steps (past the default 48 KB of shared memory
# backward), D = 8, the serving batch (the CVS test split), the training
# batch and BIG_B; then the proc and challenge workloads' training batches
# and val folds over their horizons
K1_SHAPES = ((1, 1, 5), (1, 85, 5), (3, 85, 5), (SERVE_B, 85, 5), (TRAIN_B, 85, 5), (130, 199, 5), (7, 85, 8),
             (BIG_B, 85, 5), (36, 99, 8), (78, 99, 8), (32, 141, 5), (7, 141, 5))

# the proc and challenge workloads at the repo's configs: the spec, the
# training driver, the training batch (proc's config: 36; challenge's 100
# clamped to its 28 train subjects: 32), the val fold (served, tested and
# sampled as one split), the horizon and the ODE state width
WORKLOADS = {
    "proc": dict(spec=proc_spec, driver=training_proc, train_b=36, val_b=78, T=100, D=8),
    "challenge": dict(spec=challenge_spec, driver=training_challenge, train_b=32, val_b=7, T=142, D=5),
}

K1_SOURCE = "structured_latent_odes_tpu_torch/csrc/affine_scan.cu"
K2_SOURCE = "structured_latent_odes_tpu_torch/csrc/fused_semilinear_fwd.cu"
K3_SOURCE = "structured_latent_odes_tpu_torch/csrc/fused_semilinear_bwd.cu"
K1_REPLACES = "structured_latent_odes_tpu/ops/recurrence.py:39"
K1_BWD_REPLACES = "structured_latent_odes_tpu/ops/recurrence.py:87"
K2_REPLACES = "structured_latent_odes_tpu/ops/fused_step.py:143"
K3_REPLACES = "structured_latent_odes_tpu/ops/fused_step.py:171"
KERNELS = {  # key: wrapper, which counts its launches
    "K1": recurrence.affine_scan_fwd,
    "K1-bwd": recurrence.affine_scan_bwd,
    "K2": fused_step.fused_semilinear_fwd,
    "K3": fused_step.fused_semilinear_bwd,
}


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def ratio(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float = 0.0) -> float:
    """Worst error / tolerance, max(|out - ref| / (atol + rtol*|ref|)): <= 1
    within tolerance."""
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


class Clock:
    """CUDA-event timing on the card; the host clock in a rehearsal."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def ms(self, fn, iters: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        self.sync()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def kernel_device_ms(key: str, fn, iters: int = 20) -> float:
    """Device time per launch of kernel ``key`` over ``iters`` calls of
    ``fn``: a CUDA event pair recorded on the stream right before and after
    each launch, without the wrapper's other work. A device-side sleep holds
    the stream back until every call is enqueued, so no pair waits on the
    host; the sleep doubles until the host finishes enqueueing inside it. The
    wrapper's count must rise by exactly ``iters``, each launch bracketed."""
    wrapper = KERNELS[key]
    launch = _build.launch
    pairs = []

    def bracketed(name, f, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch(name, f, *args)
        end.record()
        pairs.append((start, end))

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(6):
        pairs.clear()
        before = wrapper.launches
        sleep0, sleep1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _build.launch = bracketed
        try:
            sleep0.record()
            torch.cuda._sleep(cycles)
            sleep1.record()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
        finally:
            _build.launch = launch
        torch.cuda.synchronize()
        n = wrapper.launches - before
        check(n == iters == len(pairs), f"{key}: {n} launches counted, {len(pairs)} bracketed, expected {iters}")
        if host_ms < sleep0.elapsed_time(sleep1):
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        cycles *= 2
    fail(f"{key}: the host took longer to enqueue {iters} calls than the longest sleep")


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


def k2_bound_ms(B: int, T: int, S: int, H: int, D: int):
    nbytes = 4 * (B * H + B * D + k_params(H, D) + (T - 1) * (S + 1) + T * D * B)
    ops = B * (T - 1) * S * (4 * D * H + 2 * H)
    return bound(nbytes, ops)


def k3_bound_ms(B: int, T: int, S: int, H: int, D: int):
    """u, the weights, the tables, xs and g read once; du, dx0 and the weight
    gradients written once. The stage recompute is S(4DH + 2H) flops per
    trajectory-step and the VJP S(8DH + 4H)."""
    nbytes = 4 * (B * H + k_params(H, D) + (T - 1) * (S + 1) + 2 * T * D * B + B * H + B * D + k_params(H, D))
    ops = B * (T - 1) * S * (12 * D * H + 6 * H)
    return bound(nbytes, ops)


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_device(rehearse: bool):
    if rehearse:
        print("== device: rehearsal on the CPU (plain versions, tiny sizes)", flush=True)
        return torch.device("cpu"), "rehearsal: no card"
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"== device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    return torch.device("cuda", 0), smi


def phase_build(widths):
    """K1's library, and K2's and K3's at each (H, D) of ``widths``."""
    t0 = time.perf_counter()
    targets = [("affine_scan", ())]
    for H, D in widths:
        defines = (("SLODE_H", H), ("SLODE_D", D))
        targets += [("fused_semilinear_fwd", defines), ("fused_semilinear_bwd", defines)]
    logs = _build.build(targets)
    print(f"== build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s (into {_build.BUILD_DIR})")
    for (name, defines), log in logs.items():
        print(f"-- nvcc -Xptxas -v: {name} {dict(defines)}\n{log.strip()}", flush=True)


def _time(clock: Clock, rehearse: bool, key: str, call, plain, bound_ms, shape: str, plain_iters: int = 3):
    """Kernel device time, wrapper call and plain version (CUDA events),
    beside the bound."""
    wrapper_ms = clock.ms(call, iters=20)
    ms = wrapper_ms if rehearse else kernel_device_ms(key, call)
    plain_ms = clock.ms(plain, iters=plain_iters, warmup=1)
    bms, by = bound_ms
    print(f"time {key} {shape}: kernel {ms:.4f} ms, wrapper call {wrapper_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})", flush=True)
    return dict(shape=shape, ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def phase_kernels(device, clock: Clock, rehearse: bool, odes, H: int, D: int):
    """Each kernel against its plain version; returns per-kernel results.
    ``odes``: the ODE parameters of CVS (at ``H``, ``D``) and of each
    workload."""
    T = 86
    big_b = 64 if rehearse else BIG_B
    res = {k: {"err": 0.0, "worst": dict.fromkeys(TOLERANCE_RULES[k], 0.0)} for k in KERNELS}

    def held(key, name, out, ref, atol, rtol=0.0):
        res[key]["err"] = max(res[key]["err"], float((out - ref).abs().max()))
        r = ratio(out, ref, atol, rtol)
        res[key]["worst"][name] = max(res[key]["worst"][name], r)
        return r

    def k1_inputs(Bt, steps, D, seed):
        gen = torch.Generator().manual_seed(seed)
        A = torch.rand((Bt, steps, D), generator=gen) * 0.5 + 0.5
        B = (torch.rand((Bt, steps, D), generator=gen) - 0.5) * 0.2
        x0 = torch.rand((Bt, D), generator=gen) * 2 - 1
        g = torch.rand((Bt, steps + 1, D), generator=gen) - 0.5
        return A.to(device), B.to(device), x0.to(device), g.to(device)

    def held_equal(key, name, out, ref):
        """Bit equality; the largest difference goes to the kernels line."""
        res[key]["err"] = max(res[key]["err"], float((out - ref).abs().max()) if out.numel() else 0.0)
        equal = torch.equal(out, ref)
        res[key]["worst"][name] = max(res[key]["worst"][name], 0.0 if equal else math.inf)
        return equal

    for Bt, steps, width in K1_SHAPES:
        Bt = min(Bt, big_b)
        A, B, x0, g = k1_inputs(Bt, steps, width, Bt * 1000 + steps * 10 + width)
        xs = recurrence.affine_scan_fwd(A, B, x0)
        clock.sync()
        ref = recurrence.affine_scan_batched_plain(A, B, x0)
        ok = held_equal("K1", "xs", xs, ref)
        print(f"K1 affine_scan_fwd Bt={Bt} T={steps} D={width}: max_abs_err {float((xs - ref).abs().max()):.3e}, "
              f"bit-equal {ok}", flush=True)
        check(ok, f"K1 differs from its plain version at Bt={Bt} T={steps} D={width}")
        out = recurrence.affine_scan_bwd(A, xs, g)
        clock.sync()
        refs = recurrence.affine_scan_bwd_batched_plain(A, xs, g)
        ok = all([held_equal("K1-bwd", name, o, r) for name, o, r in zip(("dA", "dB", "dx0"), out, refs)])
        print(f"K1-bwd affine_scan_bwd Bt={Bt} T={steps} D={width}: max_abs_err "
              f"{max(float((o - r).abs().max()) for o, r in zip(out, refs)):.3e}, bit-equal {ok}", flush=True)
        check(ok, f"K1-bwd differs from its plain version at Bt={Bt} T={steps} D={width}")

    def grid(name: str, steps_plus_one: int = T):
        if name == "uniform":
            return torch.arange(float(steps_plus_one))
        return torch.tensor(np.cumsum(np.abs(np.random.RandomState(0).randn(steps_plus_one)) * 0.2 + 0.05),
                            dtype=torch.float32)

    def k2_inputs(B, grid_name, steps_plus_one: int = T, ode=odes["cvs"]):
        z = torch.randn((B, ode["latent_to_ode"][0]["W"].shape[1]),
                        generator=torch.Generator().manual_seed(B)).to(device)
        W = ode["dyn_hidden"]["W"]
        u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
        return (u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"],
                initialize_state(ode, z), grid(grid_name, steps_plus_one).to(device))

    def k3_inputs(args, method):
        xs = fused_step.fused_semilinear_fwd(*args, method)
        g = torch.randn(xs.shape, generator=torch.Generator().manual_seed(3)).to(device)
        return (*args[:6], xs, g, args[7])

    def check_fused(args, method, where, backward=True):
        """K2 and (unless not backward) K3 against their plain versions."""
        out = fused_step.fused_semilinear_fwd(*args, method)
        clock.sync()
        ref = fused_step.fused_semilinear_fwd_plain(*args, method)
        clock.sync()
        err = float((out - ref).abs().max())
        r = held("K2", "xs", out, ref, ATOL, RTOL)
        print(f"K2 fused_semilinear_fwd {method} {where}: max_abs_err {err:.3e} "
              f"max|x| {float(ref.abs().max()):.3g} (tol {ATOL:g} + {RTOL:g}*|x|)", flush=True)
        check(r <= 1.0, f"K2 disagrees with its plain version ({method}, {where})")
        if not backward:
            return
        bargs = k3_inputs(args, method)
        outs = fused_step.fused_semilinear_bwd(*bargs, method)
        clock.sync()
        refs = fused_step.fused_semilinear_bwd_plain(*bargs, method)
        clock.sync()
        # dx0 elementwise as K2; du elementwise with its absolute part scaled
        # by max|du| (DU_ATOL); each weight gradient against its leaf's
        # largest value
        worst = {}
        for name, o, r in zip(TOLERANCE_RULES["K3"], outs, refs):
            if name == "dx0":
                worst[name] = held("K3", name, o, r, ATOL, RTOL)
            elif name == "du":
                worst[name] = held("K3", name, o, r, DU_ATOL * float(r.abs().max()), RTOL)
                worst["du elementwise as K2"] = ratio(o, r, ATOL, RTOL)  # printed, not held
            else:
                worst[name] = held("K3", name, o, r, max(WGRAD_RTOL * float(r.abs().max()), 1e-30))
        print(f"K3 fused_semilinear_bwd {method} {where}: max_abs_err "
              f"{max(float((o - r).abs().max()) for o, r in zip(outs, refs)):.3e}; "
              f"error / tolerance: " + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()),
              flush=True)
        check(max(v for k, v in worst.items() if k != "du elementwise as K2") <= 1.0,
              f"K3 disagrees with its plain version ({method}, {where}): {worst}")

    with torch.inference_mode():
        for method in fused_step.METHODS:
            for B in (SERVE_B, TRAIN_B, big_b):
                for grid_name in ("uniform", "nonuniform"):
                    # the backward runs at the training shapes
                    check_fused(k2_inputs(B, grid_name), method, f"B={B} T={T} {grid_name}", backward=B != SERVE_B)
            # the edges of the kernels' layout (csrc/fused_semilinear.cuh): one
            # trajectory, two (one more than a block owns at a time), 130; one
            # step, the CVS grid, and 199 steps (two passes of up to 128 steps,
            # more steps than a block has threads)
            for B in (1, 2, 130):
                for steps_plus_one in (2, T, 200):
                    check_fused(k2_inputs(B, "nonuniform", steps_plus_one), method,
                                f"B={B} T={steps_plus_one} nonuniform")
            # each workload's training batch and val fold over its horizon,
            # at its own widths (proc's (25, 8) libraries; challenge's 141
            # steps, two passes)
            for wl, w in WORKLOADS.items():
                for B in (w["train_b"], w["val_b"]):
                    check_fused(k2_inputs(B, "uniform", w["T"], odes[wl]), method,
                                f"{wl} B={B} T={w['T']} D={w['D']} uniform")

    # times at the serving, training and large shapes; midpoint for K2 and K3
    S = 2
    for label, Bt in (("serve", SERVE_B), ("train", TRAIN_B), ("big", big_b)):
        A, B, x0, g = k1_inputs(Bt, T - 1, D, 1)
        shape = f"Bt={Bt} T={T - 1} D={D}"
        res["K1"][label] = _time(clock, rehearse, "K1", lambda: recurrence.affine_scan_fwd(A, B, x0),
                                 lambda: recurrence.affine_scan_batched_plain(A, B, x0),
                                 k1_bound_ms(T - 1, Bt * D), shape)
        xs = recurrence.affine_scan_fwd(A, B, x0)
        res["K1-bwd"][label] = _time(clock, rehearse, "K1-bwd", lambda: recurrence.affine_scan_bwd(A, xs, g),
                                     lambda: recurrence.affine_scan_bwd_batched_plain(A, xs, g),
                                     k1_bwd_bound_ms(T - 1, Bt * D), shape)
    # the whole batch-major entry as the model calls it (the autograd node
    # included): forward alone (serving) and forward plus backward (training)
    A, B, x0, g = k1_inputs(TRAIN_B, T - 1, D, 1)
    leaves = [t.clone().requires_grad_() for t in (A, B, x0)]
    with torch.inference_mode():
        fwd_ms = clock.ms(lambda: recurrence.affine_scan(A, B, x0), iters=20)
    both_ms = clock.ms(lambda: torch.autograd.grad(recurrence.affine_scan(*leaves), leaves, g), iters=20)
    res["K1"]["affine_scan_call"] = {"shape": f"Bt={TRAIN_B} T={T - 1} D={D}", "forward_ms": fwd_ms,
                                     "forward_backward_ms": both_ms}
    print(f"time affine_scan call Bt={TRAIN_B} T={T - 1} D={D}: forward {fwd_ms:.4f} ms, "
          f"forward + backward {both_ms:.4f} ms", flush=True)
    with torch.inference_mode():
        for label, B in (("serve", SERVE_B), ("train", TRAIN_B), ("big", big_b)):
            args = k2_inputs(B, "uniform")
            res["K2"][label] = _time(clock, rehearse, "K2", lambda: fused_step.fused_semilinear_fwd(*args, "midpoint"),
                                     lambda: fused_step.fused_semilinear_fwd_plain(*args, "midpoint"),
                                     k2_bound_ms(B, T, S, H, D), f"midpoint B={B} T={T} H={H} D={D}")
            if label == "serve":
                continue
            bargs = k3_inputs(args, "midpoint")
            res["K3"][label] = _time(clock, rehearse, "K3", lambda: fused_step.fused_semilinear_bwd(*bargs, "midpoint"),
                                     lambda: fused_step.fused_semilinear_bwd_plain(*bargs, "midpoint"),
                                     k3_bound_ms(B, T, S, H, D), f"midpoint B={B} T={T} H={H} D={D}")
    # each workload's training shape
    for wl, w in WORKLOADS.items():
        label, Bt, steps, width = f"{wl}_train", w["train_b"], w["T"] - 1, w["D"]
        A, B, x0, g = k1_inputs(Bt, steps, width, 1)
        shape = f"Bt={Bt} T={steps} D={width}"
        res["K1"][label] = _time(clock, rehearse, "K1", lambda: recurrence.affine_scan_fwd(A, B, x0),
                                 lambda: recurrence.affine_scan_batched_plain(A, B, x0),
                                 k1_bound_ms(steps, Bt * width), shape)
        xs = recurrence.affine_scan_fwd(A, B, x0)
        res["K1-bwd"][label] = _time(clock, rehearse, "K1-bwd", lambda: recurrence.affine_scan_bwd(A, xs, g),
                                     lambda: recurrence.affine_scan_bwd_batched_plain(A, xs, g),
                                     k1_bwd_bound_ms(steps, Bt * width), shape)
        with torch.inference_mode():
            args = k2_inputs(Bt, "uniform", w["T"], odes[wl])
            Hw = args[0].shape[1]
            shape = f"midpoint B={Bt} T={w['T']} H={Hw} D={width}"
            res["K2"][label] = _time(clock, rehearse, "K2", lambda: fused_step.fused_semilinear_fwd(*args, "midpoint"),
                                     lambda: fused_step.fused_semilinear_fwd_plain(*args, "midpoint"),
                                     k2_bound_ms(Bt, w["T"], S, Hw, width), shape)
            bargs = k3_inputs(args, "midpoint")
            res["K3"][label] = _time(clock, rehearse, "K3", lambda: fused_step.fused_semilinear_bwd(*bargs, "midpoint"),
                                     lambda: fused_step.fused_semilinear_bwd_plain(*bargs, "midpoint"),
                                     k3_bound_ms(Bt, w["T"], S, Hw, width), shape)
    return res


def zero_counts():
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def read_counts():
    return {key: wrapper.launches for key, wrapper in KERNELS.items()}


# the kernels each ODE backend launches: its forward kernel when serving, and
# its backward kernel too when training
FORWARD = {"semilinear": ("K1",), "semilinear_pallas": ("K1",), "semilinear_fused": ("K2",), "semilinear_seq": ()}
TRAINING = {"semilinear": ("K1", "K1-bwd"), "semilinear_fused": ("K2", "K3"), "semilinear_seq": ()}


def counted(paths: dict, name: str, expected, rehearse: bool, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after, into ``paths[name]``: each kernel of ``expected`` must have
    launched, and no other kernel (on the CPU none launches)."""
    zero_counts()
    out = fn()
    paths[name] = counts = read_counts()
    print(f"launches {name}: {counts}", flush=True)
    for key, n in counts.items():
        want = key in expected and not rehearse
        check(n > 0 if want else n == 0,
              f"{name}: {key} launched {n} times, expected {'some' if want else 'none'}")
    return out


def _config(data_dir: str, backend: str, model: str = "Mechanistic"):
    cfg = load_cvs_config()
    cfg.data_path = data_dir
    cfg.ode_backend = backend
    cfg.model = model
    return cfg


def phase_serving(device, workdir: str, rehearse: bool, paths: dict):
    """Serve requests through serve.main, counting launches per backend
    into ``paths``."""
    data_dir = os.path.join(workdir, "cvs")
    data_size = 40 if rehearse else 1000
    t0 = time.perf_counter()
    make_dataset(data_dir, data_size=data_size, device=device)
    print(f"== serving path: CVS data_size={data_size} generated on {device} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    n_test = data_size - int(round(data_size * 0.9))
    spec = cvs_spec(_config(data_dir, "semilinear"))
    ckpts = []
    for seed in (0, 1):
        path = os.path.join(workdir, f"member{seed}.npz")
        checkpoint.save(path, params_to_jax(init_params(spec, seed, device=device)))
        ckpts.append(path)

    requests = {
        "posterior": ["--checkpoint", ckpts[0]],
        "prior+classify": ["--checkpoint", ckpts[0], "--prior", "--classify"],
        "ensemble-mean": ["--checkpoint", *ckpts, "--classify"],
    }
    outs = {}

    def serve_all(backend):
        for name, argv in requests.items():
            if backend == "semilinear_pallas" and name != "posterior":
                continue
            out_path = os.path.join(workdir, f"{backend}-{name}.npz")
            outs[backend, name] = serve.main(
                ["--dataset", "cvs", *argv, "--device", str(device), "--output", out_path],
                config=_config(data_dir, backend),
            )

    for backend, expected in FORWARD.items():
        counted(paths, f"serve {backend}", expected, rehearse, lambda: serve_all(backend))
    gauss_cfg = _config(data_dir, "semilinear", "MechanisticGauss")
    gauss_ckpt = os.path.join(workdir, "gauss.npz")
    checkpoint.save(gauss_ckpt, params_to_jax(init_params(cvs_spec(gauss_cfg), 2, device=device)))
    gauss = counted(paths, "serve semilinear Gauss", FORWARD["semilinear"], rehearse, lambda: serve.main(
        ["--dataset", "cvs", "--checkpoint", gauss_ckpt, "--device", str(device),
         "--output", os.path.join(workdir, "gauss-posterior.npz")],
        config=gauss_cfg,
    ))

    outs["Gauss", "posterior"] = gauss
    _check_served(outs, {"mu_50": (n_test, 3, 86), "solution_xt": (n_test, 86, 5)})
    return ckpts, data_dir


def _check_served(outs: dict, shapes: dict, where: str = "") -> None:
    """Served outputs, keyed (backend, request): the shapes, finite values,
    and every backend against semilinear_seq (a "Gauss" entry has no
    counterpart). max |diff| <= ATOL + RTOL * max |ref| per output: scaled by
    the output's largest value, not elementwise, because the bands are sums
    over state components of |x| up to tens and cancel to small values,
    where the state's roundoff survives in absolute terms."""
    for (backend, name), out in outs.items():
        for k, shape in shapes.items():
            check(out[k].shape == shape, f"{where}{backend} {name} {k} shape {out[k].shape} != {shape}")
        check(all(np.isfinite(v).all() for v in out.values()), f"{where}{backend} {name}: non-finite output")
        if backend == "Gauss":
            continue
        ref = outs["semilinear_seq", name]
        worst = 0.0
        for k in ref:
            diff = float(np.abs(np.asarray(out[k]) - np.asarray(ref[k])).max())
            scale = float(np.abs(np.asarray(ref[k])).max())
            check(diff <= ATOL + RTOL * scale,
                  f"{where}{backend} {name} {k} disagrees with semilinear_seq: {diff} (max |ref| {scale})")
            worst = max(worst, diff)
        print(f"{where}{backend:18s} {name:15s} max |diff| vs semilinear_seq {worst:.3e}", flush=True)


def _check_trained(name: str, out, artifacts: dict):
    """A training run's two logged epoch losses and its test ELBOs are
    finite, and each artifact file has its shape and finite values. Returns
    the epoch losses."""
    rd = out["out_dir"]
    with open(os.path.join(rd, "model.log")) as f:
        losses = [float(line.split("loss=")[1].split()[0]) for line in f if "loss=" in line]
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses), f"{name}: losses {losses}")
    check(all(math.isfinite(v) for v in out["test_post"].elbo + out["test_prior"].elbo),
          f"{name}: non-finite test ELBO")
    for fname, shape in artifacts.items():
        arr = np.load(os.path.join(rd, fname))
        check(arr.shape == shape and np.isfinite(arr).all(), f"{name} {fname}: {arr.shape} != {shape}")
    return losses


def phase_request_times(device, clock: Clock, ckpts, data_dir: str, rehearse: bool, smi: str):
    """Host-clock time of one served posterior request, ending in a sync."""
    big_b = 64 if rehearse else BIG_B
    for backend in ("semilinear", "semilinear_fused", "semilinear_seq"):
        spec, params, times, splits = serve.load_model("cvs", ckpts[0], _config(data_dir, backend), device)
        recon_fn, _ = serve.make_predict_fns(spec, times, device)
        test = splits["test"]
        for B in (test["observations"].shape[0], big_b):
            idx = np.arange(B) % test["observations"].shape[0]
            batch = {k: torch.as_tensor(v[idx], device=device) for k, v in test.items()}
            batch["sample_id"] = torch.arange(B, device=device)

            def request():
                out = recon_fn(params, 0, batch, True)
                clock.sync()
                return out

            request()
            t0 = time.perf_counter()
            n = 3 if rehearse else 10
            for _ in range(n):
                request()
            ms = (time.perf_counter() - t0) * 1e3 / n
            print(f"request {backend:16s} B={B:6d}: {ms:.3f} ms ({smi})", flush=True)


# the JAX package's artifact contract at CVS (test split of 100): file, shape
ARTIFACTS = {
    "observations.npy": (3, 86), "times.npy": None, "iext.npy": (), "rtpr.npy": (),
    **{f"{k}_{tag}.npy": (3, 86) for k in ("mu_50", "mu_75", "mu_25") for tag in ("post", "prior")},
    **{f"solution_xt_{tag}.npy": (86, 5) for tag in ("post", "prior")},
    **{f"z_{tag}.npy": (15,) for tag in ("post", "prior")},
}


def phase_training(device, workdir: str, data_dir: str, rehearse: bool, paths: dict):
    """training_cvs.main at full width per backend, plus one Gauss run,
    counting launches per run into ``paths``."""
    n_test = (40 if rehearse else 1000) - int(round((40 if rehearse else 1000) * 0.9))
    runs = [(b, "Mechanistic") for b in TRAINING] + [("semilinear", "MechanisticGauss")]
    results = {}
    for backend, model in runs:
        root = os.path.join(workdir, f"train-{backend}-{model}")
        t0 = time.perf_counter()
        name = f"train {backend}" + (" Gauss" if model == "MechanisticGauss" else "")
        results[backend, model] = counted(paths, name, TRAINING[backend], rehearse, lambda: training_cvs.main([
            "--num-epochs", "1", "--no-plot", "--ode-backend", backend, "--model", model,
            "--data-path", data_dir, "--results-root", root, "--device", str(device),
        ]))
        print(f"== trained {model} on {backend}: 2 epochs in {time.perf_counter() - t0:.2f} s", flush=True)

    artifacts = {name: (86,) if shape is None else (n_test,) + shape for name, shape in ARTIFACTS.items()}
    for (backend, model), out in results.items():
        losses = _check_trained(f"{backend} {model}", out, artifacts)
        print(f"{backend:18s} {model:17s} epoch losses {losses}, test ELBO post {out['test_post'].elbo}, "
              f"artifacts ok", flush=True)

    # the trained checkpoint, served by the port
    rd = results["semilinear", "Mechanistic"]["out_dir"]
    served = serve.main(
        ["--dataset", "cvs", "--checkpoint", os.path.join(rd, "best_model.npz"), "--device", str(device),
         "--output", os.path.join(workdir, "trained-posterior.npz")],
        config=_config(data_dir, "semilinear"),
    )
    check(served["mu_50"].shape == (n_test, 3, 86) and np.isfinite(served["mu_50"]).all(), "trained model serve")


def _first_step(spec, params, batch, ts, lr: float):
    """The first dual step's main loss and gradients at ``params``, then the
    aux loss and gradients after the main update (svi.make_dual_step's
    order), at fixed seeds."""
    optim = svi.make_dual_optimizer(spec, params, lr)
    main_loss, aux_loss = svi.make_losses(spec, ts)
    loss_m, _, g_m = svi.value_and_grad(main_loss, params, 7, batch)
    params2, _ = optim.update_main(g_m, optim.init(params), params)
    loss_a, _, g_a = svi.value_and_grad(aux_loss, params2, 8, batch)
    return [loss_m, loss_a], tree_leaves(g_m) + tree_leaves(g_a)


def first_step_and_times(clock: Clock, rehearse: bool, smi: str, paths: dict, prefix: str, spec_of, params, batch,
                         ts, lr: float):
    """First-step agreement across the backends (launches counted per
    backend into ``paths``, as ``first step {prefix}{backend}``), then one
    dual step timed per backend. ``spec_of(backend)`` is the model's spec on
    that ODE backend."""
    first = {b: counted(paths, f"first step {prefix}{b}", TRAINING[b], rehearse,
                        lambda: _first_step(spec_of(b), params, batch, ts, lr))
             for b in TRAINING}
    losses_ref, grads_ref = first["semilinear_seq"]
    scale = max(max(float(g.abs().max()) for g in grads_ref), 1.0)
    for backend in ("semilinear", "semilinear_fused"):
        losses, grads = first[backend]
        loss_ratio = max(float((l - r).abs()) / (ATOL + RTOL * float(r.abs())) for l, r in zip(losses, losses_ref))
        grad_err = max(float((g - r).abs().max()) for g, r in zip(grads, grads_ref)) / scale
        leaf_err = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1.0) for g, r in zip(grads, grads_ref))
        print(f"first dual step {prefix}{backend} vs semilinear_seq: losses {[float(l) for l in losses]} "
              f"(error / tolerance {loss_ratio:.3f}); gradients max|diff| / max(max|g_seq|, 1) "
              f"{grad_err:.3e} (tol {STEP_GRAD_TOL:g}; worst leaf by its own scale {leaf_err:.3e})", flush=True)
        check(loss_ratio <= 1.0, f"first-step losses of {prefix}{backend} disagree with semilinear_seq")
        check(grad_err < STEP_GRAD_TOL, f"first-step gradients of {prefix}{backend} disagree with semilinear_seq")

    step_ms = {}
    B = batch["observations"].shape[0]
    for backend in TRAINING:
        init_state, train_step, _ = svi.make_train_step(spec_of(backend), ts, lr, params)
        state = init_state(params, 0)
        for _ in range(2):  # warm-up
            state, _m = train_step(state, batch)
        clock.sync()
        n = 2 if rehearse else 10
        t0 = time.perf_counter()
        for _ in range(n):
            state, _m = train_step(state, batch)
        clock.sync()
        step_ms[backend] = (time.perf_counter() - t0) * 1e3 / n
        print(f"dual step {prefix}{backend:16s} B={B}: {step_ms[backend]:.3f} ms ({smi})", flush=True)
    return step_ms


def phase_train_checks(device, clock: Clock, data_dir: str, rehearse: bool, smi: str, paths: dict):
    """First-step agreement across the backends (launches counted per
    backend into ``paths``), then one dual step timed."""
    cfg = _config(data_dir, "semilinear")
    splits, _ = training_cvs.build_splits(cfg, device=device)
    batches = device_batch(stacked_minibatches(splits["train"], TRAIN_B, shuffle=False), device)
    batch = {k: v[0] for k, v in batches.items()}
    ts = torch.arange(86.0, device=device)
    params = init_params(cvs_spec(cfg), 0, device=device)
    return first_step_and_times(clock, rehearse, smi, paths, "", lambda b: cvs_spec(_config(data_dir, b)), params,
                                batch, ts, cfg.learning_rate)


def _workload_config(wl: str, backend: str, model: str = "Mechanistic"):
    cfg = LOADERS[wl]()
    cfg.ode_backend = backend
    cfg.model = model
    return cfg


def phase_workloads(device, clock: Clock, workdir: str, rehearse: bool, smi: str, paths: dict):
    """proc and challenge on their datasets: served, trained, first step
    compared and one dual step timed per backend, each path's launches
    counted into ``paths``. Returns the dual-step times per workload."""
    step_ms = {}
    for wl, w in WORKLOADS.items():
        n, T, D = w["val_b"], w["T"], w["D"]
        spec = w["spec"](_workload_config(wl, "semilinear"), n_time=T)
        print(f"== {wl}: serving the val fold (B = {n}, T = {T}, ODE state {D}, latent {spec.latent_dim})",
              flush=True)
        ckpts = []
        for seed in (0, 1):
            path = os.path.join(workdir, f"{wl}-member{seed}.npz")
            checkpoint.save(path, params_to_jax(init_params(spec, seed, device=device)))
            ckpts.append(path)
        requests = {
            "posterior": ["--checkpoint", ckpts[0]],
            "prior+classify": ["--checkpoint", ckpts[0], "--prior", "--classify"],
            "ensemble-mean": ["--checkpoint", *ckpts, "--classify"],
        }
        outs = {}

        def serve_all(backend):
            for name, argv in requests.items():
                outs[backend, name] = serve.main(
                    ["--dataset", wl, *argv, "--split", "val", "--device", str(device),
                     "--output", os.path.join(workdir, f"{wl}-{backend}-{name}.npz")],
                    config=_workload_config(wl, backend),
                )

        for backend in TRAINING:
            counted(paths, f"serve {wl} {backend}", FORWARD[backend], rehearse, lambda: serve_all(backend))
        gauss_cfg = _workload_config(wl, "semilinear", "MechanisticGauss")
        gauss_ckpt = os.path.join(workdir, f"{wl}-gauss.npz")
        checkpoint.save(gauss_ckpt, params_to_jax(init_params(w["spec"](gauss_cfg, n_time=T), 2, device=device)))
        outs["Gauss", "posterior"] = counted(paths, f"serve {wl} semilinear Gauss", FORWARD["semilinear"], rehearse,
                                             lambda: serve.main(
            ["--dataset", wl, "--checkpoint", gauss_ckpt, "--split", "val", "--device", str(device),
             "--output", os.path.join(workdir, f"{wl}-gauss-posterior.npz")], config=gauss_cfg))
        _check_served(outs, {"mu_50": (n, 4, T), "solution_xt": (n, T, D)}, f"{wl} ")

        # training at full width on the full dataset, 2 epochs, the config's
        # sample bands (2 draws in a rehearsal)
        n_samples = 2 if rehearse else LOADERS[wl]().num_samples
        artifacts = {"observations.npy": (n, 4, T), "times.npy": (T,),
                     **({"treatments.npy": (n, 2), "devices.npy": (n, 7)} if wl == "proc"
                        else {"shedding.npy": (n,), "symptoms.npy": (n,)})}
        for tag in ("post", "prior"):
            artifacts.update({f"{q}_{tag}.npy": (n, 4, T) for q in ("mu_25", "mu_50", "mu_75")})
            artifacts.update({f"{q}_{tag}_sample.npy": (n, 4, T, n_samples) for q in ("mu_25", "mu_50", "mu_75")})
            artifacts[f"solution_xt_{tag}.npy"] = (n, T, D)
            artifacts[f"z_{tag}.npy"] = (n, spec.latent_dim)
        results = {}
        for backend, model in [(b, "Mechanistic") for b in TRAINING] + [("semilinear", "MechanisticGauss")]:
            name = f"train {wl} {backend}" + (" Gauss" if model == "MechanisticGauss" else "")
            argv = ["--num-epochs", "1", "--no-plot", "--ode-backend", backend, "--model", model,
                    "--num-samples", str(n_samples), "--device", str(device),
                    "--results-root", os.path.join(workdir, f"train-{wl}-{backend}-{model}")]
            t0 = time.perf_counter()
            out = results[backend, model] = counted(paths, name, TRAINING[backend], rehearse,
                                                    lambda: w["driver"].main(argv))
            losses = _check_trained(name, out, artifacts)
            print(f"== {name}: 2 epochs, test and {n_samples}-draw bands in {time.perf_counter() - t0:.2f} s; "
                  f"epoch losses {losses}, best epoch {out['best']['epoch']}, artifacts ok", flush=True)
        rd = results["semilinear", "Mechanistic"]["out_dir"]
        served = serve.main(
            ["--dataset", wl, "--checkpoint", os.path.join(rd, "best_model.npz"), "--split", "val",
             "--device", str(device), "--output", os.path.join(workdir, f"{wl}-trained-posterior.npz")],
            config=_workload_config(wl, "semilinear"),
        )
        check(served["mu_50"].shape == (n, 4, T) and np.isfinite(served["mu_50"]).all(), f"{wl}: trained model serve")

        # the first dual step across the backends, and one step timed, at the
        # workload's training batch
        cfg = _workload_config(wl, "semilinear")
        _, splits, times = serve._build(wl, cfg, device)
        batches = device_batch(stacked_minibatches(splits["train"], w["train_b"], shuffle=False), device)
        batch = {k: v[0] for k, v in batches.items()}
        params = init_params(spec, 0, device=device)
        step_ms[wl] = first_step_and_times(
            clock, rehearse, smi, paths, f"{wl} ", lambda b: w["spec"](_workload_config(wl, b), n_time=T), params,
            batch, torch.as_tensor(times, device=device), cfg.learning_rate)
    return step_ms


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rehearse", action="store_true", help="CPU dry run with the plain versions")
    args = p.parse_args(argv)

    device, smi = phase_device(args.rehearse)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_cvs_config()
    H, D = cfg.ode_hidden_dim, cfg.ode_state_dim
    wl_cfgs = {wl: LOADERS[wl]() for wl in WORKLOADS}
    if not args.rehearse:
        phase_build(sorted({(H, D)} | {(c.ode_hidden_dim, c.ode_state_dim) for c in wl_cfgs.values()}))
    clock = Clock(device)
    odes = {"cvs": init_params(cvs_spec(cfg), 0, device=device)["decoder"]["ode"]}
    for wl, w in WORKLOADS.items():
        odes[wl] = init_params(w["spec"](wl_cfgs[wl], n_time=w["T"]), 0, device=device)["decoder"]["ode"]
    res = phase_kernels(device, clock, args.rehearse, odes, H, D)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(REPO, "build"))
    paths = {}  # path name -> launch counts of that path's run
    try:
        ckpts, data_dir = phase_serving(device, workdir, args.rehearse, paths)
        phase_request_times(device, clock, ckpts, data_dir, args.rehearse, smi)
        phase_training(device, workdir, data_dir, args.rehearse, paths)
        phase_train_checks(device, clock, data_dir, args.rehearse, smi, paths)
        phase_workloads(device, clock, workdir, args.rehearse, smi, paths)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # times at the training shapes (B = 128, the training path); the
    # serving and large shapes and the proc and challenge training shapes
    # beside them. "launches" is the count of the kernel's main path, the
    # CVS full-width training run on its backend; every path's count stands
    # beside it.
    kernels = []
    for key, name, source, replaces, main_path in (
        ("K1", "affine_scan_fwd", K1_SOURCE, K1_REPLACES, "train semilinear"),
        ("K1-bwd", "affine_scan_bwd", K1_SOURCE, K1_BWD_REPLACES, "train semilinear"),
        ("K2", "fused_semilinear_fwd", K2_SOURCE, K2_REPLACES, "train semilinear_fused"),
        ("K3", "fused_semilinear_bwd", K3_SOURCE, K3_REPLACES, "train semilinear_fused"),
    ):
        t = res[key]["train"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[main_path][key], "main_path": main_path,
            "launches_by_path": {path: counts[key] for path, counts in paths.items()},
            "max_abs_err": res[key]["err"],
            "tolerance": {out: {"rule": rule, "worst_error_over_tolerance": res[key]["worst"][out]}
                          for out, rule in TOLERANCE_RULES[key].items()},
            "ms": t["ms"], "wrapper_ms": t["wrapper_ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
            **{label: res[key][label] for label in ("serve", "big", "affine_scan_call", "proc_train",
                                                     "challenge_train") if label in res[key]},
        })
    check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite kernel time")
    if args.rehearse:
        print(json.dumps({"kernels": kernels}))
        print("rehearsal ok (no result: no card)")
        return
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
