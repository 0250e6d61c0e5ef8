#!/usr/bin/env python3
"""One dual SVI step of the repo's CVS model per ODE backend, timed on a
CUDA card, with the adaptive solvers' trips.

    python3 scripts/menu_step_times.py [--batch B] [--steps N] [BACKEND ...]

Random weights from seed 0 and random data of the CVS shapes made on the card
(T = 86, latent 15, ODE state 5, hidden 25); each backend takes one warm-up
dual step, then ``--steps`` timed ones (host clock ending in a synchronize).
Prints, per backend, the time a step and the adaptive solves, trips (accepted
and rejected steps) and accepted steps a step. Default backends: generic,
adjoint, adaptive, adaptive_per_sample. Needs a CUDA card; imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from structured_latent_odes_tpu_torch.data.configs import load_cvs_config  # noqa: E402
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params  # noqa: E402
from structured_latent_odes_tpu_torch.ode import solvers  # noqa: E402
from structured_latent_odes_tpu_torch.train import svi  # noqa: E402
from structured_latent_odes_tpu_torch.utils.device import full_fp32  # noqa: E402


def _trips():
    return solvers.odeint_adaptive.trips + solvers.odeint_adaptive_per_sample.trips


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("backends", nargs="*", default=["generic", "adjoint", "adaptive", "adaptive_per_sample"])
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--steps", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    full_fp32(deterministic=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    B, T = args.batch, load_cvs_config().seq_len
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {"observations": torch.rand((B, 3, T), generator=gen, device=device),
             "iext": (torch.rand((B, 1), generator=gen, device=device) > 0.5).float(),
             "rtpr": (torch.rand((B, 1), generator=gen, device=device) > 0.5).float(),
             "sample_id": torch.arange(B, device=device), "mask": torch.ones(B, device=device)}
    ts = torch.arange(float(T), device=device)
    for backend in args.backends:
        cfg = load_cvs_config()
        cfg.ode_backend = backend
        spec = cvs_spec(cfg)
        params = init_params(spec, 0, device=device)
        init_state, step, _ = svi.make_train_step(spec, ts, cfg.learning_rate, params)
        state, _ = step(init_state(params, 0), batch)  # warm-up
        torch.cuda.synchronize()
        before = _trips()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, mets = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args.steps
        after = _trips()
        per = {k: (after[k] - before[k]) / args.steps for k in ("solves", "trips", "accepted")}
        print(f"{backend:20s} B={B}: {ms:.1f} ms a dual step; a step: {per['solves']:.0f} adaptive solves, "
              f"{per['trips']:.0f} trips, {per['accepted']:.0f} accepted; loss {float(mets['loss_main']):.4f} "
              f"({card})", flush=True)


if __name__ == "__main__":
    main()
