#!/usr/bin/env python3
"""End-to-end host-clock times of two checkouts of the PyTorch port, in
alternating pairs on one CUDA card.

    python3 scripts/port_ab_times.py --parent DIR --change DIR [--pairs 10] [--json PATH]

A run is a fresh process (``--one DIR``) that imports
``structured_latent_odes_tpu_torch`` from one checkout (its kernels build into
that checkout's ``build/cuda/``), generates the CVS data on the card (1000
trajectories, the generator's own seed), draws the repo's full CVS model's
weights from seed 0, and times, on each ported ODE backend, one served
posterior request at B = 100 (the test split) and B = 16,411 (the split
tiled) and one dual SVI step at B = 128 (the first train minibatch), as
chip_smoke.py's phases 4 and 5 do: the host clock over REQUESTS requests or
STEPS steps after warm-up, ending in a synchronize. Pair i runs the parent
first when i is even and the change first when it is odd.

Prints each run's times, then per metric each side's median and quartiles
and in how many pairs the change was faster. Needs a CUDA card; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

BACKENDS = ("semilinear", "semilinear_fused", "semilinear_seq")
TRAIN_B = 128
BIG_B = 16411
STEPS = 20
REQUESTS = 10


def run_one(tree: str) -> dict:
    """The times of one checkout, in this process."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch

    from structured_latent_odes_tpu_torch import serve
    from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
    from structured_latent_odes_tpu_torch.data.cvs import make_dataset
    from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
    from structured_latent_odes_tpu_torch.interop import params_to_jax
    from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
    from structured_latent_odes_tpu_torch.train import checkpoint
    from structured_latent_odes_tpu_torch.train.driver import device_batch
    from structured_latent_odes_tpu_torch.train.svi import make_train_step
    from structured_latent_odes_tpu_torch.training_cvs import build_splits
    from structured_latent_odes_tpu_torch.utils.device import full_fp32

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    full_fp32()
    os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="ab-", dir=os.path.join(tree, "build"))
    times = {}

    def config(backend):
        cfg = load_cvs_config()
        cfg.data_path = workdir
        cfg.ode_backend = backend
        return cfg

    def clocked(fn, n):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    try:
        make_dataset(workdir, device=device)
        ckpt = os.path.join(workdir, "member0.npz")
        checkpoint.save(ckpt, params_to_jax(init_params(cvs_spec(config("semilinear")), 0, device=device)))
        for backend in BACKENDS:
            spec, params, ts, splits = serve.load_model("cvs", ckpt, config(backend), device)
            recon_fn, _ = serve.make_predict_fns(spec, ts, device)
            test = splits["test"]
            for B in (test["observations"].shape[0], BIG_B):
                idx = np.arange(B) % test["observations"].shape[0]
                batch = {k: torch.as_tensor(v[idx], device=device) for k, v in test.items()}
                batch["sample_id"] = torch.arange(B, device=device)
                times[f"request {backend} B={B}"] = clocked(lambda: recon_fn(params, 0, batch, True), REQUESTS)

        cfg = config("semilinear")
        splits, _ = build_splits(cfg, device=device)
        stack = device_batch(stacked_minibatches(splits["train"], TRAIN_B, shuffle=False), device)
        batch = {k: v[0] for k, v in stack.items()}
        ts = torch.arange(86.0, device=device)
        params = init_params(cvs_spec(cfg), 0, device=device)
        for backend in BACKENDS:
            init_state, train_step, _ = make_train_step(cvs_spec(config(backend)), ts, cfg.learning_rate, params)
            state = [init_state(params, 0)]

            def step():
                state[0], _m = train_step(state[0], batch)

            step()  # warm-up beyond clocked's own
            times[f"dual step {backend} B={TRAIN_B}"] = clocked(step, STEPS)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return times


def quartiles(v):
    return [float(x) for x in np.percentile(v, (25, 50, 75))]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--one", metavar="DIR", help="time one checkout in this process and print one JSON line")
    p.add_argument("--parent", metavar="DIR")
    p.add_argument("--change", metavar="DIR")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--json", help="also write every run and the summary here")
    args = p.parse_args(argv)
    if args.one:
        print(json.dumps(run_one(args.one)), flush=True)
        return
    if not (args.parent and args.change):
        p.error("give --one DIR, or --parent DIR and --change DIR")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
            tree = args.parent if side == "parent" else args.change
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tree],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise SystemExit(f"pair {i} {side} failed (exit {out.returncode}):\n{out.stderr[-4000:]}")
            runs[side].append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(f"pair {i} {side}: {json.dumps(runs[side][-1])}", flush=True)
    summary = {}
    for metric in runs["parent"][0]:
        par = [r[metric] for r in runs["parent"]]
        chg = [r[metric] for r in runs["change"]]
        summary[metric] = {"parent_q1_median_q3_ms": quartiles(par), "change_q1_median_q3_ms": quartiles(chg),
                           "change_faster_pairs": sum(c < q for c, q in zip(chg, par)), "pairs": len(par)}
        s = summary[metric]
        print(f"{metric:36s} parent {s['parent_q1_median_q3_ms']} change {s['change_q1_median_q3_ms']} ms "
              f"(q1, median, q3); change faster in {s['change_faster_pairs']} of {s['pairs']} pairs ({card})",
              flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "runs": runs, "summary": summary}, f, indent=1)


if __name__ == "__main__":
    main()
