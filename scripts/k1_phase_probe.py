#!/usr/bin/env python3
"""Where a launch of K1 and K1-bwd spends its time at the training shape, on a
CUDA card.

    python3 scripts/k1_phase_probe.py [--json PATH]

Builds csrc/affine_scan.cu a second time with -DAFFINE_SCAN_STAMPS=1, where
thread 0 of every block reads the SM's cycle counter (clock64) at four
points: the kernel's start, the end of the mbarrier wait (the inputs have
landed in shared memory), the barrier after the chain, and the end of the
stores. It reports, per phase, the median over the blocks of one launch at
Bt = 128, T = 85, D = 5 (the CVS training batch), after warm-up. The stamps'
own cost is a few instructions per phase.

Beside it, the device time of one launch bracketed by a CUDA event pair (the
method of chip_smoke.py phase 3: each pair right around one launch, the
stream held by a device-side sleep until all are queued), for three
launches: an empty kernel of the same grid (the floor of the bracket: launch,
event pair, an empty block), and K1 and K1-bwd through their wrappers. Needs
a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from structured_latent_odes_tpu_torch.ops import _build, recurrence  # noqa: E402

Bt, T, D = 128, 85, 5
STAMPED = (("AFFINE_SCAN_STAMPS", 1),)
MAX_BLOCKS = 4096  # the blocks whose stamps the stamped library keeps


def stamped(symbol: str, argtypes):
    """A C function of the stamped build of csrc/affine_scan.cu."""
    return _build.function("affine_scan", symbol, argtypes, defines=STAMPED)


def bracket_ms(call, iters: int = 20) -> float:
    """Mean device time of one call between a CUDA event pair, behind a
    device-side sleep that holds the stream until all are queued."""
    call()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(8):
        pairs = []
        s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            pairs.append((a, b))
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < s0.elapsed_time(s1):
            return sum(a.elapsed_time(b) for a, b in pairs) / iters
        cycles *= 2
    raise SystemExit("the host took longer to enqueue than the longest sleep")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--json", help="also write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    A = torch.tensor(rng.uniform(0.5, 1.0, (Bt, T, D)), dtype=torch.float32, device=dev)
    B = torch.tensor(rng.uniform(-0.1, 0.1, (Bt, T, D)), dtype=torch.float32, device=dev)
    x0 = torch.tensor(rng.uniform(-1.0, 1.0, (Bt, D)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.uniform(-0.5, 0.5, (Bt, T + 1, D)), dtype=torch.float32, device=dev)
    xs = recurrence.affine_scan_fwd(A, B, x0)

    fwd = stamped("affine_scan_fwd", recurrence._FWD_ARGTYPES)
    bwd = stamped("affine_scan_bwd", recurrence._BWD_ARGTYPES)
    read_stamps = stamped("affine_scan_read_stamps", [ctypes.c_void_p, ctypes.c_int])
    launch_empty = stamped("affine_scan_launch_empty", [ctypes.c_uint, ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(xs)
    dA, dB, dx0 = torch.empty_like(A), torch.empty_like(A), torch.empty_like(x0)
    calls = {
        "K1": lambda: fwd(A.data_ptr(), B.data_ptr(), x0.data_ptr(), out.data_ptr(), Bt, T, D, stream),
        "K1-bwd": lambda: bwd(A.data_ptr(), xs.data_ptr(), g.data_ptr(), dA.data_ptr(), dB.data_ptr(),
                              dx0.data_ptr(), Bt, T, D, stream),
    }
    result = {"card": card, "shape": f"Bt={Bt} T={T} D={D}", "phases_cycles": {}}
    blocks = 0
    for key, call in calls.items():
        for _ in range(5):
            if call() != 0:
                raise SystemExit(f"{key}: launch failed")
        torch.cuda.synchronize()
        host = np.zeros(MAX_BLOCKS * 4, dtype=np.int64)
        read_stamps(host.ctypes.data, MAX_BLOCKS * 4)
        st = host.reshape(MAX_BLOCKS, 4)
        st = st[st[:, 3] != 0]  # the blocks of the grid: a stamp is never 0
        blocks = len(st)
        result["phases_cycles"][key] = {
            "inputs landed": int(np.median(st[:, 1] - st[:, 0])),
            "chain": int(np.median(st[:, 2] - st[:, 1])),
            "stores": int(np.median(st[:, 3] - st[:, 2])),
            "total": int(np.median(st[:, 3] - st[:, 0])),
        }
    if not torch.equal(out, xs):
        raise SystemExit("the stamped K1 disagrees with the port's")
    result["blocks"] = blocks
    result["bracket_ms"] = {
        "empty kernel, same grid": bracket_ms(lambda: launch_empty(blocks, stream)),
        "K1 wrapper": bracket_ms(lambda: recurrence.affine_scan_fwd(A, B, x0)),
        "K1-bwd wrapper": bracket_ms(lambda: recurrence.affine_scan_bwd(A, xs, g)),
    }
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
