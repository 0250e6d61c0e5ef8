#!/usr/bin/env python3
"""Where a training step's time goes, for the PyTorch port on a CUDA card.

    python3 scripts/profile_port_train.py [--json PATH]

Runs the dual SVI step (the main ELBO's forward and backward and its Adam
update, then the aux ELBO's) of the repo's full CVS model, random weights
from seed 0, on the first B = 128 minibatch of the generated CVS train split,
on each ported ODE backend, and reads a torch.profiler trace of REPEATS steps
after warm-up, with scripts/profile_port_serve.py's reader: per step the wall
time (host clock, ending in a synchronize), the device busy time, the device
idle share, the number of device operations, the kernels that take the most
device time and the port's own kernels (K1, K1-bwd, K2, K3). Needs a CUDA
card; imports nothing of JAX.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_port_serve import BACKENDS, profile_request  # noqa: E402

from structured_latent_odes_tpu_torch.data.configs import load_cvs_config  # noqa: E402
from structured_latent_odes_tpu_torch.data.cvs import make_dataset  # noqa: E402
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches  # noqa: E402
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params  # noqa: E402
from structured_latent_odes_tpu_torch.train.driver import device_batch  # noqa: E402
from structured_latent_odes_tpu_torch.train.svi import make_train_step  # noqa: E402
from structured_latent_odes_tpu_torch.training_cvs import build_splits  # noqa: E402
from structured_latent_odes_tpu_torch.utils.device import full_fp32  # noqa: E402

REPEATS = 5
B = 128


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", help="also write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    full_fp32(deterministic=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="profile-", dir=os.path.join(repo, "build"))
    results = []
    try:
        cfg = load_cvs_config()
        cfg.data_path = workdir
        make_dataset(workdir, device=device)
        train = build_splits(cfg, device=device)[0]["train"]
        stack = device_batch(stacked_minibatches(train, B, shuffle=False), device)
        batch = {k: v[0] for k, v in stack.items()}
        ts = torch.arange(float(cfg.seq_len), device=device)
        for backend in BACKENDS:
            cfg.ode_backend = backend
            spec = cvs_spec(cfg)
            params = init_params(spec, 0, device=device)
            init_state, train_step, _ = make_train_step(spec, ts, cfg.learning_rate, params)
            state = [init_state(params, 0)]

            def step():
                state[0], _ = train_step(state[0], batch)

            step()  # warm-up beyond profile_request's own
            r = profile_request(step, REPEATS)
            r.update(backend=backend, batch=B, card=card)
            results.append(r)
            print(json.dumps(r), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
