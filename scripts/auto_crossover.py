#!/usr/bin/env python3
"""Where ``semilinear_auto`` should switch between the K1 path and the fused
K2/K3 path on a CUDA card: both paths end to end over batch, members, solver
and widths.

    python3 scripts/auto_crossover.py [--json PATH] [--repeats N] [--quick]

The K1 path is the ``semilinear`` backend (the dynamics heads in PyTorch at
every stage time, kernels K1 and K1-bwd for the recurrence); the fused path
is ``semilinear_fused`` (kernels K2 and K3: the whole solve). Two end-to-end
measures of the repo's CVS model (random weights from seed 0, random data of
the CVS shapes made on the card):

- a served request: ``serve.make_predict_fns``'s posterior reconstruction of
  B trajectories;
- a dual step: ``svi.make_stacked_dual_step`` of S members (each member's
  main ELBO forward and backward and Adam update, then the aux ELBO's), at B
  trajectories a member.

Grid: B in {7, 32, 36, 100, 128, 1024, 16411}, S in {1, 5, 10} (dual steps;
requests at S = 1), solvers midpoint, rk4 and dopri5, (H, D) in {(25, 5),
(25, 8)} (the ODE state widened to 8 in the CVS model). At each point the
two paths alternate, ``--repeats`` times each after two warm-ups, each call
timed on the host clock ending in ``torch.cuda.synchronize()``: the median
and the quartiles per path, and the device operations of one call per path
(torch.profiler). The verdict per point: the faster median where the medians
differ by more than the larger quartile spread, else the path with fewer
device operations. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from structured_latent_odes_tpu_torch.data.configs import load_cvs_config  # noqa: E402
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params  # noqa: E402
from structured_latent_odes_tpu_torch.prob import fold_seed  # noqa: E402
from structured_latent_odes_tpu_torch.serve import make_predict_fns  # noqa: E402
from structured_latent_odes_tpu_torch.train import ensemble, svi  # noqa: E402
from structured_latent_odes_tpu_torch.utils.device import full_fp32  # noqa: E402

BATCHES = (7, 32, 36, 100, 128, 1024, 16411)
MEMBERS = (1, 5, 10)
SOLVERS = ("midpoint", "rk4", "dopri5")
WIDTHS = ((25, 5), (25, 8))
PATHS = {"K1": "semilinear", "fused": "semilinear_fused"}


def _ops(fn) -> int:
    """Device operations (kernels, copies, sets) of one call of ``fn``."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _batch(device, S: int, B: int, T: int, seed: int):
    """CVS-shaped data on the card: S members' batches (leading member axis
    when S > 1 is asked for by ``stacked``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "observations": torch.rand((S, B, 3, T), generator=gen, device=device),
        "iext": (torch.rand((S, B, 1), generator=gen, device=device) > 0.5).float(),
        "rtpr": (torch.rand((S, B, 1), generator=gen, device=device) > 0.5).float(),
        "sample_id": torch.arange(B, device=device).expand(S, B).contiguous(),
    }


def _config(solver: str, D: int, backend: str):
    cfg = load_cvs_config()
    cfg.solver, cfg.ode_state_dim, cfg.ode_backend = solver, D, backend
    return cfg


def _request(device, solver, D, backend, B, T):
    cfg = _config(solver, D, backend)
    spec = cvs_spec(cfg)
    params = init_params(spec, 0, device=device)
    recon_fn, _ = make_predict_fns(spec, np.arange(float(T), dtype=np.float32), device)
    batch = {k: v[0] for k, v in _batch(device, 1, B, T, B).items()}

    def call():
        recon_fn(params, 0, batch, True)
        torch.cuda.synchronize()

    return call


def _dual_step(device, solver, D, backend, B, S, T):
    cfg = _config(solver, D, backend)
    spec = cvs_spec(cfg)
    params = [init_params(spec, fold_seed(12 + m, "init"), device=device) for m in range(S)]
    optim = svi.make_dual_optimizer(spec, params[0], cfg.learning_rate)
    state = [ensemble.stack_states([svi.SVIState(p, optim.init(p), fold_seed(12 + m, "train"), 0)
                                    for m, p in enumerate(params)])]
    step = svi.make_stacked_dual_step(spec, torch.arange(float(T), device=device), optim)
    batch = _batch(device, S, B, T, B + S)
    batch["mask"] = torch.ones(B, device=device)
    dims = {k: 0 for k in batch}
    dims["mask"] = None
    seeds = svi.stacked_step_seeds(state[0].seed, range(4), device=device)
    k = [0]

    def call():
        state[0], _ = step(state[0], batch, dims, seeds[k[0] % 4])
        k[0] += 1
        torch.cuda.synchronize()

    return call


def _measure(calls: dict, repeats: int) -> dict:
    """Both paths in turn, ``repeats`` timed calls each after two warm-ups:
    median, quartiles and one call's device operations per path."""
    out = {}
    for name, call in calls.items():
        try:
            for _ in range(2):
                call()
        except torch.cuda.OutOfMemoryError:
            out[name] = {"oom": True}
            torch.cuda.empty_cache()
    live = [n for n in calls if n not in out]
    times = {n: [] for n in live}
    for r in range(repeats):
        order = live if r % 2 == 0 else live[::-1]
        for name in order:
            t0 = time.perf_counter()
            calls[name]()
            times[name].append((time.perf_counter() - t0) * 1e3)
    for name in live:
        q1, med, q3 = np.percentile(times[name], [25, 50, 75])
        out[name] = {"median_ms": float(med), "q1_ms": float(q1), "q3_ms": float(q3), "ops": _ops(calls[name])}
    return out


def verdict(r: dict) -> str:
    """The faster path where the medians differ by more than the larger
    quartile spread (q3 - q1), else the path with fewer device operations."""
    k1, fu = r["K1"], r["fused"]
    if k1.get("oom") or fu.get("oom"):
        return "fused" if k1.get("oom") and not fu.get("oom") else "K1"
    spread = max(k1["q3_ms"] - k1["q1_ms"], fu["q3_ms"] - fu["q1_ms"])
    if abs(k1["median_ms"] - fu["median_ms"]) > spread:
        return "fused" if fu["median_ms"] < k1["median_ms"] else "K1"
    return "fused" if fu["ops"] <= k1["ops"] else "K1"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", help="write every point here, one JSON object a line, as it is measured")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--quick", action="store_true", help="B in {7, 128}, S in {1, 5}, midpoint: a short check")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    batches, members, solvers = (BATCHES, MEMBERS, SOLVERS) if not args.quick else ((7, 128), (1, 5), ("midpoint",))
    T = load_cvs_config().seq_len
    sink = open(args.json, "w") if args.json else None
    t_start = time.perf_counter()
    try:
        for (H, D) in WIDTHS:
            for solver in solvers:
                for mode, S_list in (("request", (1,)), ("dual_step", members)):
                    for S in S_list:
                        for B in batches:
                            full_fp32(deterministic=mode == "dual_step")
                            if mode == "request":
                                calls = {n: _request(device, solver, D, b, B, T) for n, b in PATHS.items()}
                            else:
                                calls = {n: _dual_step(device, solver, D, b, B, S, T) for n, b in PATHS.items()}
                            r = _measure(calls, args.repeats)
                            row = {"mode": mode, "solver": solver, "H": H, "D": D, "S": S, "B": B,
                                   "lanes": S * B * D, **r, "verdict": verdict(r), "card": card}
                            del calls
                            torch.cuda.empty_cache()
                            print(json.dumps(row), flush=True)
                            if sink:
                                sink.write(json.dumps(row) + "\n")
                                sink.flush()
    finally:
        if sink:
            sink.close()
    print(f"done in {time.perf_counter() - t_start:.1f} s ({card})", flush=True)


if __name__ == "__main__":
    main()
