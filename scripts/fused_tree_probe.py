#!/usr/bin/env python3
"""K1, K1-bwd, K2 and K3 of one checkout of the PyTorch port, at fixed
inputs: their outputs, saved so that two checkouts can be compared element by
element, and their wrapper times.

    python3 scripts/fused_tree_probe.py --tree DIR --out FILE.npz
    python3 scripts/fused_tree_probe.py --compare A.npz B.npz

``--tree`` imports ``structured_latent_odes_tpu_torch`` from DIR, a checkout
of any commit whose port has ``ops/fused_step.fused_semilinear_fwd`` (K3 is
run where the checkout has ``fused_semilinear_bwd``); the kernels build into
DIR's own ``build/cuda/``. Inputs come from numpy seeds at the CVS widths
(H = 25, D = 5, T = 86, uniform grid): K2 and K3 outputs at B = 128 for every
method, saved trajectory-major ``(B, T, D)`` whatever the checkout's layout.
Then each wrapper call is timed with CUDA events over 20 calls after warm-up,
at midpoint, B = 128 and B = 16,411: the same method in every checkout, so
two checkouts run in one call on the card can be compared. ``--compare``
prints, per output, the largest difference and how many elements differ in
their bits.

K1 and K1-bwd run at Bt = 128 and 16,411 (T = 85 steps, D = 5) on
coefficients from a numpy seed. A checkout whose kernels take the time-major
``(T, Bt*D)`` layout (no ``recurrence.affine_scan_batched_plain``) is fed
the transposes, and its outputs are saved batch-major ``(Bt, T+1, D)`` like
the others'. Each wrapper call is timed as above, and so is the model's
entry ``recurrence.affine_scan`` at Bt = 128: forward alone (inference
mode) and forward plus backward (``torch.autograd.grad``), copies included.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

H, D, T = 25, 5, 86
METHODS = ("euler", "midpoint", "heun", "rk4")
BWD_NAMES = ("du", "dwt", "dwa", "dba", "dwd", "dbd", "dx0")


def inputs(B: int, device):
    rng = np.random.RandomState(B)
    lim = 1.0 / np.sqrt(H)
    arrays = (
        rng.randn(B, H),                      # u
        rng.uniform(-lim, lim, H),            # w_t
        rng.uniform(-lim, lim, (D, H)),       # W_a
        rng.uniform(-lim, lim, D),            # b_a
        rng.uniform(-lim, lim, (D, H)),       # W_d
        rng.uniform(-lim, lim, D),            # b_d
        rng.randn(B, D),                      # x0
        np.arange(T, dtype=np.float64),       # ts
    )
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in arrays)


def scan_inputs(Bt: int, device):
    """A, B (Bt, T-1, D), x0 (Bt, D) and the cotangent g (Bt, T, D)."""
    rng = np.random.RandomState(Bt + 1)
    arrays = (
        rng.uniform(0.5, 1.0, (Bt, T - 1, D)),
        rng.uniform(-0.1, 0.1, (Bt, T - 1, D)),
        rng.uniform(-1.0, 1.0, (Bt, D)),
        rng.uniform(-0.5, 0.5, (Bt, T, D)),
    )
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in arrays)


def cuda_ms(call, iters: int = 20) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def probe_scan(recurrence, device, saved: dict, times: dict) -> None:
    """K1 and K1-bwd through the checkout's own layout, outputs batch-major."""
    batch_major = hasattr(recurrence, "affine_scan_batched_plain")

    def tm(x):  # (Bt, n, D) -> (n, Bt*D)
        return x.permute(1, 0, 2).reshape(x.shape[1], -1).contiguous()

    def bm(x, Bt):  # (n, Bt*D) -> (Bt, n, D)
        return x.reshape(x.shape[0], Bt, D).permute(1, 0, 2).contiguous()

    for Bt in (128, 16411):
        A, B, x0, g = scan_inputs(Bt, device)
        if batch_major:
            fwd_args, bwd_args = (A, B, x0), lambda xs: (A, xs, g)
        else:
            fwd_args, bwd_args = (tm(A), tm(B), x0.reshape(-1)), lambda xs: (tm(A), xs, tm(g))
        xs = recurrence.affine_scan_fwd(*fwd_args)
        grads = recurrence.affine_scan_bwd(*bwd_args(xs))
        if batch_major:
            out = (xs, *grads)
        else:
            out = (bm(xs, Bt), bm(grads[0], Bt), bm(grads[1], Bt), grads[2].reshape(Bt, D))
        for name, v in zip(("xs", "dA", "dB", "dx0"), out):
            saved[f"K1/B={Bt}/{name}"] = v.cpu().numpy()
        b_args = bwd_args(xs)
        times[f"K1 wrapper ms, B={Bt}"] = cuda_ms(lambda: recurrence.affine_scan_fwd(*fwd_args))
        times[f"K1-bwd wrapper ms, B={Bt}"] = cuda_ms(lambda: recurrence.affine_scan_bwd(*b_args))
    A, B, x0, g = scan_inputs(128, device)
    with torch.inference_mode():
        times["affine_scan forward ms, B=128"] = cuda_ms(lambda: recurrence.affine_scan(A, B, x0))
    leaves = [t.clone().requires_grad_() for t in (A, B, x0)]
    times["affine_scan forward+backward ms, B=128"] = cuda_ms(
        lambda: torch.autograd.grad(recurrence.affine_scan(*leaves), leaves, g))


def probe(tree: str, out_path: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    from structured_latent_odes_tpu_torch.ops import fused_step, recurrence

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    has_bwd = hasattr(fused_step, "fused_semilinear_bwd")

    def fwd(args, method):
        xs = fused_step.fused_semilinear_fwd(*args, method)
        time_major = tuple(xs.shape) == (T, D, args[0].shape[0])
        return xs, time_major

    def cotangent(B, time_major):
        g = torch.tensor(np.random.RandomState(3).randn(B, T, D), dtype=torch.float32, device=device)
        return g.permute(1, 2, 0).contiguous() if time_major else g

    def bwd(args, xs, g, method):
        return fused_step.fused_semilinear_bwd(*args[:6], xs, g, args[7], method)

    saved = {}
    args = inputs(128, device)
    for method in METHODS:
        xs, time_major = fwd(args, method)
        saved[f"K2/{method}/xs"] = (xs.permute(2, 0, 1) if time_major else xs).cpu().numpy()
        if has_bwd:
            for name, v in zip(BWD_NAMES, bwd(args, xs, cotangent(128, time_major), method)):
                saved[f"K3/{method}/{name}"] = v.cpu().numpy()

    times = {}
    for B in (128, 16411):
        args = inputs(B, device)
        xs, time_major = fwd(args, "midpoint")
        calls = {"K2": lambda: fwd(args, "midpoint")}
        if has_bwd:
            g = cotangent(B, time_major)
            calls["K3"] = lambda: bwd(args, xs, g, "midpoint")
        for key, call in calls.items():
            times[f"{key} wrapper ms, midpoint B={B}"] = cuda_ms(call)
    probe_scan(recurrence, device, saved, times)
    np.savez(out_path, **saved)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": tree, "card": card, **times}), flush=True)


def compare(path_a: str, path_b: str) -> None:
    a, b = np.load(path_a), np.load(path_b)
    for key in sorted(set(a.files) & set(b.files)):
        x, y = a[key], b[key]
        differ = int((x.view(np.uint32) != y.view(np.uint32)).sum())
        print(f"{key:24s} max|diff| {float(np.abs(x - y).max()):.3e}  elements differing in bits "
              f"{differ} of {x.size}", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--tree", help="checkout whose port to probe")
    p.add_argument("--out", help="where to save the outputs (.npz)")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"), help="compare two saved probes")
    args = p.parse_args(argv)
    if args.compare:
        compare(*args.compare)
    elif args.tree and args.out:
        probe(args.tree, args.out)
    else:
        p.error("give --tree and --out, or --compare")


if __name__ == "__main__":
    main()
