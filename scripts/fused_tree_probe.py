#!/usr/bin/env python3
"""K2 and K3 of one checkout of the PyTorch port, at fixed inputs: their
outputs, saved so that two checkouts can be compared element by element, and
their wrapper times.

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
their bits. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
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


def probe(tree: str, out_path: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    from structured_latent_odes_tpu_torch.ops import fused_step

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
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            times[f"{key} wrapper ms, midpoint B={B}"] = start.elapsed_time(end) / 20
    np.savez(out_path, **saved)
    print(json.dumps({"tree": tree, "card": torch.cuda.get_device_name(0), **times}), flush=True)


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
