#!/usr/bin/env python3
"""Smoke run of the PyTorch port (structured_latent_odes_tpu_torch) on one
CUDA card: the quickest proof that the port builds and serves on the GPU.

    python3 chip_smoke.py              # on the card
    python3 chip_smoke.py --rehearse   # on the CPU: plain versions, tiny sizes

Phases, each fatal on any fault:

1. device: the card's name and power limit (nvidia-smi).
2. build: every kernel from csrc/, one nvcc per source, all started together;
   prints nvcc's -Xptxas -v report.
3. kernels: K1 (affine scan) and K2 (fused semilinear solve) against their
   plain PyTorch versions on the card at the serving shapes and at
   B = 16,411; then timed at both sizes beside the plain version and the
   bound on an H100 SXM: the kernel's own device time from a torch.profiler
   trace, and the wrapper call (argument preparation included) and the plain
   version with CUDA events after warm-up.
4. main path: generates CVS with the port's make_dataset on the card, writes
   two random-weight checkpoints (seeds 0 and 1) in the JAX package's format,
   and serves them through serve.main: posterior recon, prior recon with
   --classify, and the ensemble mean of both, on the backends semilinear
   (K1), semilinear_pallas (K1), semilinear_fused (K2) and semilinear_seq
   (plain), plus one Gauss-model request. Launch counts are zeroed just before
   and read just after; outputs are checked for shape, finiteness and
   agreement across backends. Then a served request is timed at B = 100 and
   B = 16,411 per backend.

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
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from structured_latent_odes_tpu_torch import serve
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.nn.ode_model import initialize_state
from structured_latent_odes_tpu_torch.ops import _build, fused_step, recurrence
from structured_latent_odes_tpu_torch.train import checkpoint

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

K1_TOL = 1e-6  # K1 does the plain version's float32 operations exactly
# K2 and the backends, elementwise |out - ref| <= ATOL + RTOL*|ref|, the JAX
# package's own tolerance for its fused kernel (tests/test_fused_step.py):
# at random weights trajectories reach |x| of tens, where float32 roundoff
# accumulated over 85 steps differs by up to ~1e-6 relative between two
# summation orders (measured on the H100: 6.9e-5 abs at |x| = 78)
ATOL, RTOL = 1e-5, 1e-5
BIG_B = 16411

K1_SOURCE = "structured_latent_odes_tpu_torch/csrc/affine_scan.cu"
K2_SOURCE = "structured_latent_odes_tpu_torch/csrc/fused_semilinear_fwd.cu"
K1_REPLACES = "structured_latent_odes_tpu/ops/recurrence.py:39"
K2_REPLACES = "structured_latent_odes_tpu/ops/fused_step.py:143"


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def excess(out: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float) -> float:
    """max(|out - ref| - rtol*|ref|) / atol: <= 1 within tolerance."""
    return float(((out - ref).abs() - rtol * ref.abs()).max()) / atol


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


def kernel_device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device time of the kernel named ``kernel`` per call of ``fn``, from a
    torch.profiler trace: the kernel alone, without the wrapper's host work
    or its argument preparation."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    check(len(us) == iters, f"profiler saw {len(us)} launches of {kernel}, expected {iters}")
    return sum(us) / iters / 1e3


def k1_bound_ms(T: int, M: int):
    nbytes = 4 * (2 * T * M + M + (T + 1) * M)
    ops = 2 * T * M
    return bound(nbytes, ops)


def k2_bound_ms(B: int, T: int, S: int, H: int, D: int):
    nbytes = 4 * (B * H + B * D + (H + 2 * D * H + 2 * D) + (T - 1) * (S + 1) + T * D * B)
    ops = B * (T - 1) * S * (4 * D * H + 2 * H)
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


def phase_build(H: int, D: int):
    t0 = time.perf_counter()
    logs = _build.build([("affine_scan", ()), ("fused_semilinear_fwd", (("SLODE_H", H), ("SLODE_D", D)))])
    print(f"== build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s (into {_build.BUILD_DIR})")
    for (name, defines), log in logs.items():
        print(f"-- nvcc -Xptxas -v: {name} {dict(defines)}\n{log.strip()}", flush=True)


def phase_kernels(device, clock: Clock, rehearse: bool, ode, H: int, D: int):
    """Each kernel against its plain version; returns per-kernel results."""
    T = 86
    big_b = 64 if rehearse else BIG_B
    res = {"K1": {"err": 0.0}, "K2": {"err": 0.0}}

    def k1_inputs(M, seed):
        gen = torch.Generator().manual_seed(seed)
        A = torch.rand((T - 1, M), generator=gen) * 0.5 + 0.5
        B = (torch.rand((T - 1, M), generator=gen) - 0.5) * 0.2
        x0 = torch.rand((M,), generator=gen) * 2 - 1
        return A.to(device), B.to(device), x0.to(device)

    for M in (5 * 100, 5 * big_b, 777):
        args = k1_inputs(M, M)
        out = recurrence.affine_scan_tm(*args)
        clock.sync()
        err = float((out - recurrence.affine_scan_plain(*args)).abs().max())
        clock.sync()
        res["K1"]["err"] = max(res["K1"]["err"], err)
        print(f"K1 affine_scan_fwd T={T - 1} M={M}: max_abs_err {err:.3e} (tol {K1_TOL:g})", flush=True)
        check(err <= K1_TOL, f"K1 disagrees with its plain version at M={M}: {err}")

    grids = {
        "uniform": torch.arange(float(T)),
        "nonuniform": torch.tensor(np.cumsum(np.abs(np.random.RandomState(0).randn(T)) * 0.2 + 0.05),
                                   dtype=torch.float32),
    }

    def k2_inputs(B, grid):
        z = torch.randn((B, ode["latent_to_ode"][0]["W"].shape[1]),
                        generator=torch.Generator().manual_seed(B)).to(device)
        W = ode["dyn_hidden"]["W"]
        u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
        return (u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"],
                initialize_state(ode, z), grids[grid].to(device))

    with torch.inference_mode():
        for method in fused_step.METHODS:
            for B in (100, big_b):
                for grid in grids:
                    args = k2_inputs(B, grid)
                    out = fused_step.fused_semilinear_fwd(*args, method)
                    clock.sync()
                    ref = fused_step.fused_semilinear_fwd_plain(*args, method)
                    clock.sync()
                    err = float((out - ref).abs().max())
                    ratio = excess(out, ref, ATOL, RTOL)
                    res["K2"]["err"] = max(res["K2"]["err"], err)
                    print(f"K2 fused_semilinear_fwd {method} B={B} T={T} {grid}: max_abs_err {err:.3e} "
                          f"max|x| {float(ref.abs().max()):.3g} (tol {ATOL:g} + {RTOL:g}*|x|)", flush=True)
                    check(ratio <= 1.0, f"K2 disagrees with its plain version ({method}, B={B}, {grid})")

    # times at the serving shapes (first) and at B = 16,411, midpoint for K2
    for label, M in (("serve", 5 * 100), ("big", 5 * big_b)):
        args = k1_inputs(M, 1)
        call = lambda: recurrence.affine_scan_tm(*args)  # noqa: E731
        wrapper_ms = clock.ms(call, iters=50)
        ms = wrapper_ms if rehearse else kernel_device_ms(call, "affine_scan_fwd_kernel")
        plain_ms = clock.ms(lambda: recurrence.affine_scan_plain(*args), iters=5)
        bms, by = k1_bound_ms(T - 1, M)
        res["K1"][label] = dict(shape=f"T={T - 1} M={M}", ms=ms, wrapper_ms=wrapper_ms,
                                plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        print(f"time K1 T={T - 1} M={M}: kernel {ms:.4f} ms, wrapper call {wrapper_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})", flush=True)
    S = 2
    for label, B in (("serve", 100), ("big", big_b)):
        args = k2_inputs(B, "uniform")
        call = lambda: fused_step.fused_semilinear_fwd(*args, "midpoint")  # noqa: E731
        with torch.inference_mode():
            wrapper_ms = clock.ms(call, iters=20)
            ms = wrapper_ms if rehearse else kernel_device_ms(call, "fused_semilinear_fwd_kernel")
            plain_ms = clock.ms(lambda: fused_step.fused_semilinear_fwd_plain(*args, "midpoint"), iters=3, warmup=1)
        bms, by = k2_bound_ms(B, T, S, H, D)
        res["K2"][label] = dict(shape=f"midpoint B={B} T={T} H={H} D={D}", ms=ms, wrapper_ms=wrapper_ms,
                                plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        print(f"time K2 midpoint B={B} T={T}: kernel {ms:.4f} ms, wrapper call {wrapper_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by})", flush=True)
    return res


def _config(data_dir: str, backend: str, model: str = "Mechanistic"):
    cfg = load_cvs_config()
    cfg.data_path = data_dir
    cfg.ode_backend = backend
    cfg.model = model
    return cfg


def phase_main_path(device, workdir: str, rehearse: bool):
    """Serve requests through serve.main; returns the launch counts."""
    data_dir = os.path.join(workdir, "cvs")
    data_size = 40 if rehearse else 1000
    t0 = time.perf_counter()
    make_dataset(data_dir, data_size=data_size, device=device)
    print(f"== main path: CVS data_size={data_size} generated on {device} in "
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
    backends = ("semilinear", "semilinear_pallas", "semilinear_fused", "semilinear_seq")
    recurrence.affine_scan_tm.launches = 0
    fused_step.fused_semilinear_fwd.launches = 0
    outs = {}
    for backend in backends:
        for name, argv in requests.items():
            if backend == "semilinear_pallas" and name != "posterior":
                continue
            out_path = os.path.join(workdir, f"{backend}-{name}.npz")
            outs[backend, name] = serve.main(
                ["--dataset", "cvs", *argv, "--device", str(device), "--output", out_path],
                config=_config(data_dir, backend),
            )
    gauss_cfg = _config(data_dir, "semilinear", "MechanisticGauss")
    gauss_ckpt = os.path.join(workdir, "gauss.npz")
    checkpoint.save(gauss_ckpt, params_to_jax(init_params(cvs_spec(gauss_cfg), 2, device=device)))
    gauss = serve.main(
        ["--dataset", "cvs", "--checkpoint", gauss_ckpt, "--device", str(device),
         "--output", os.path.join(workdir, "gauss-posterior.npz")],
        config=gauss_cfg,
    )
    launches = {"K1": recurrence.affine_scan_tm.launches, "K2": fused_step.fused_semilinear_fwd.launches}
    print(f"main path launches: K1 {launches['K1']}, K2 {launches['K2']}", flush=True)

    for out in list(outs.values()) + [gauss]:
        check(out["mu_50"].shape == (n_test, 3, 86), f"mu_50 shape {out['mu_50'].shape}")
        check(out["solution_xt"].shape == (n_test, 86, 5), f"solution shape {out['solution_xt'].shape}")
        check(all(np.isfinite(v).all() for v in out.values()), "non-finite output")
    # served outputs: max |diff| <= ATOL + RTOL * max |ref| per output. Scaled
    # by the output's largest value, not elementwise: the bands are sums over
    # state components of |x| up to tens and cancel to small values, where
    # the state's roundoff survives in absolute terms.
    for (backend, name), out in outs.items():
        ref = outs["semilinear_seq", name]
        worst = 0.0
        for k in ref:
            diff = float(np.abs(np.asarray(out[k]) - np.asarray(ref[k])).max())
            scale = float(np.abs(np.asarray(ref[k])).max())
            check(diff <= ATOL + RTOL * scale,
                  f"{backend} {name} {k} disagrees with semilinear_seq: {diff} (max |ref| {scale})")
            worst = max(worst, diff)
        print(f"{backend:18s} {name:15s} max |diff| vs semilinear_seq {worst:.3e}", flush=True)
    if not rehearse:
        check(launches["K1"] > 0, "K1 was not launched on the main path")
        check(launches["K2"] > 0, "K2 was not launched on the main path")
    return launches, ckpts, data_dir


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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rehearse", action="store_true", help="CPU dry run with the plain versions")
    args = p.parse_args(argv)

    device, smi = phase_device(args.rehearse)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_cvs_config()
    H, D = cfg.ode_hidden_dim, cfg.ode_state_dim
    if not args.rehearse:
        phase_build(H, D)
    clock = Clock(device)
    ode = init_params(cvs_spec(cfg), 0, device=device)["decoder"]["ode"]
    res = phase_kernels(device, clock, args.rehearse, ode, H, D)

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke-", dir=os.path.join(REPO, "build"))
    try:
        launches, ckpts, data_dir = phase_main_path(device, workdir, args.rehearse)
        phase_request_times(device, clock, ckpts, data_dir, args.rehearse, smi)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    kernels = []
    for key, name, source, replaces, atol, rtol in (
        ("K1", "affine_scan_fwd", K1_SOURCE, K1_REPLACES, K1_TOL, 0.0),
        ("K2", "fused_semilinear_fwd", K2_SOURCE, K2_REPLACES, ATOL, RTOL),
    ):
        serve_t = res[key]["serve"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[key], "max_abs_err": res[key]["err"], "atol": atol, "rtol": rtol,
            "ms": serve_t["ms"], "wrapper_ms": serve_t["wrapper_ms"], "plain_ms": serve_t["plain_ms"],
            "bound_ms": serve_t["bound_ms"],
            "bound_by": serve_t["bound_by"], "library_ms": None, "shape": serve_t["shape"],
            "big": res[key]["big"],
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
