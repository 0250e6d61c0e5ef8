#!/usr/bin/env python3
"""How far a sweep member drifts from the sequential CLI run of its seed, per
parameter leaf, for the PyTorch port on a CUDA card.

    python3 scripts/sweep_member_parity.py [--backend semilinear_fused] [--seeds 12..21]
        [--members 0,9] [--num-epochs 1] [--twice] [--json PATH]

Generates the CVS dataset (1000 trajectories) on the card, runs
``sweep.run`` over the seeds and ``training_cvs.main`` at the chosen
members' seeds, and prints for each member, for the final and the best
params, every leaf whose largest |sweep - sequential| exceeds
1e-6 + 2e-4 * |sequential| (tests/test_ensemble.py's bound): its name, the
largest difference in units of the learning rate, the number of elements
over the bound, and the worst element's values; with ``--twice``, the same
for a second sequential run of the seed against the first (the card's
run-to-run reproducibility, under the cuDNN settings that the sweep and the
trainer choose: ``utils.device.full_fp32(deterministic=True)``). Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from structured_latent_odes_tpu_torch import sweep, training_cvs  # noqa: E402
from structured_latent_odes_tpu_torch.data.cvs import make_dataset  # noqa: E402


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--backend", default="semilinear_fused")
    p.add_argument("--seeds", default="12..21")
    p.add_argument("--members", default="0,9")
    p.add_argument("--num-epochs", default="1")
    p.add_argument("--twice", action="store_true",
                   help="also run each chosen member's sequential CLI run a second time and hold the two runs "
                        "to the same bound (the card's run-to-run reproducibility)")
    p.add_argument("--json", help="also write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="parity-", dir=os.path.join(repo, "build"))
    rows = []
    try:
        data = os.path.join(workdir, "cvs")
        make_dataset(data, device="cuda")
        common = ["--num-epochs", args.num_epochs, "--ode-backend", args.backend, "--data-path", data]
        run = sweep.run(sweep.parse_args(["cvs", "--seeds", args.seeds, "--results-root",
                                          os.path.join(workdir, "sweep")] + common))
        seeds = sweep.parse_seeds(args.seeds)
        lr = run.members[0]["config"].learning_rate
        for i in (int(m) for m in args.members.split(",")):
            out = training_cvs.main(["--seed", str(seeds[i]), "--no-plot", "--no-eval-train", "--results-root",
                                     os.path.join(workdir, f"seq{i}")] + common)
            pairs = [("sweep final", run.result.state.params, out["state"].params, True),
                     ("sweep best", run.result.best_params, out["best"]["params"], True)]
            if args.twice:
                again = training_cvs.main(["--seed", str(seeds[i]), "--no-plot", "--no-eval-train", "--results-root",
                                           os.path.join(workdir, f"seq{i}-again")] + common)
                pairs.append(("sequential again final", again["state"].params, out["state"].params, False))
            for what, tree, ref, stacked in pairs:
                for (name, a), (_, b) in zip(_leaves(tree), _leaves(ref)):
                    a = a[i] if stacked else a
                    err = (a - b).abs()
                    over = err > 1e-6 + 2e-4 * b.abs()
                    if over.any():
                        k = int(torch.argmax(err / (1e-6 + 2e-4 * b.abs())))
                        row = {"member": i, "seed": seeds[i], "params": what, "leaf": name, "backend": args.backend,
                               "max_err_over_lr": float(err.max()) / lr, "n_over": int(over.sum()),
                               "n": a.numel(), "worst_sweep": float(a.flatten()[k]),
                               "worst_sequential": float(b.flatten()[k]),
                               "worst_ratio": float((err / (1e-6 + 2e-4 * b.abs())).flatten()[k]), "card": card}
                        rows.append(row)
                        print(json.dumps(row), flush=True)
            print(f"{args.backend} member {i} (seed {seeds[i]}): "
                  f"{sum(r['member'] == i for r in rows)} leaves over the bound; best epoch "
                  f"{run.result.best_epoch[i]} vs {out['best']['epoch']} ({card})", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
