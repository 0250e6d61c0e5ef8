#!/usr/bin/env python3
"""Where a served request's time goes, for the PyTorch port on a CUDA card.

    python3 scripts/profile_port_serve.py [--json PATH]

Serves the CVS posterior request (the repo's full CVS model, random weights
from seed 0) at B = 100 (the whole test split) and at B = 16,411 (the split
tiled, distinct sample ids) on each ported ODE backend, and reads a
torch.profiler trace of REPEATS requests after warm-up, eager and replayed
as a CUDA graph (``serve.make_predict_fns``' default on the card; the
warm-up runs the graph's eager first call, its capture and a replay). Per
request it reports the wall time (host clock, ending in a synchronize), the
device busy time (the sum of the device operations on the one stream), the
device idle share, the number of device operations, the kernels and copies
that take the most device time, and the device time of the port's own
kernels (K1 to K3); and a replayed request taken apart: the copies into
the graph's buffers, the replay, the copies out. Needs a CUDA card; imports
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
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from structured_latent_odes_tpu_torch import serve  # noqa: E402
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config  # noqa: E402
from structured_latent_odes_tpu_torch.data.cvs import make_dataset  # noqa: E402
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params  # noqa: E402
from structured_latent_odes_tpu_torch.train import svi  # noqa: E402
from structured_latent_odes_tpu_torch.training_cvs import build_splits  # noqa: E402

REPEATS = 5
TOP = 8  # the device operations reported by name
BACKENDS = ("semilinear", "semilinear_fused", "semilinear_seq")
PORT_KERNELS = ("affine_scan_fwd_kernel", "affine_scan_bwd_kernel",
                "fused_semilinear_fwd_kernel", "fused_semilinear_bwd_kernel")


def profile_request(request, repeats: int):
    for _ in range(3):  # a graph's eager first call, its capture, a replay
        request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            request()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / repeats
    busy_us = 0.0
    per_kernel = defaultdict(float)
    n_ops = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            per_kernel[e.name] += us
            n_ops += 1
    if n_ops == 0:
        raise SystemExit("the profiler recorded no device operation")
    busy_ms = busy_us / 1e3 / repeats
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_ops": n_ops // repeats,
        "top_kernels_ms": {name[:80]: us / 1e3 / repeats for name, us in top},
        "port_kernels_ms": {
            k: sum(us for name, us in per_kernel.items() if k in name) / 1e3 / repeats
            for k in PORT_KERNELS
        },
    }


def replay_parts(spec, recon_fn, params, batch, repeats: int):
    """A replayed request taken apart (``train/svi.py::_EvalGraph``): the
    copies of the params, the seed and the batch into the graph's buffers,
    the replay, and the copies of the outputs; median host ms of each, a
    synchronize after each part."""
    recon_fn(params, 0, batch, True)
    (graph,) = [g for k, g in svi._EVAL_FN_GRAPHS._d.items() if k[0] == spec and k[-2] == ("recon", True)
                and k[-1] == svi._signature(batch)]
    seed = svi.seed_tensor([0], batch["observations"].device)[0]
    parts = {"copy_in_ms": [], "replay_ms": [], "copy_out_ms": []}
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svi._copy_in(svi.tree_leaves(graph.params), svi.tree_leaves(params))
        svi._copy_in([graph.batches[k] for k in sorted(graph.batches)], [batch[k] for k in sorted(batch)])
        graph.seeds.copy_(seed)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = graph.run()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        svi.tree_map(torch.clone, out)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3))):
            parts[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", help="also write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
        test = build_splits(cfg, device=device)[0]["test"]
        times = np.arange(0.0, cfg.seq_len * cfg.delta_t, cfg.delta_t, dtype=np.float32)
        for backend in BACKENDS:
            cfg.ode_backend = backend
            spec = cvs_spec(cfg)
            params = init_params(spec, 0, device=device)
            for dispatch in ("eager", None):
                recon_fn, _ = serve.make_predict_fns(spec, times, device, dispatch=dispatch)
                for B in (test["observations"].shape[0], 16411):
                    idx = np.arange(B) % test["observations"].shape[0]
                    batch = {k: torch.as_tensor(v[idx], device=device) for k, v in test.items()}
                    batch["sample_id"] = torch.arange(B, device=device)
                    r = profile_request(lambda: recon_fn(params, 0, batch, True), REPEATS)
                    if dispatch is None:
                        r["replay_parts"] = replay_parts(spec, recon_fn, params, batch, REPEATS)
                    r.update(backend=backend, batch=B, dispatch=recon_fn.dispatch, card=card)
                    results.append(r)
                    print(json.dumps(r), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
