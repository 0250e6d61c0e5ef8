"""Run cells of the benchmark as the check runs them, one process a run,
one after another, and keep each run's result.

    python3 port_bench/tools/runs.py --out FILE.jsonl \\
        --run CELL:SEED:SECONDS:TRACE [--run ...] [--spread]

Each ``--run`` is started as ``python3 port_bench/run.py --workload CELL
--seed SEED --seconds SECONDS --trace TRACE`` from the checkout's root; its
exit code, its result line (or the end of its output) and the end of its
standard error go to one line of ``FILE.jsonl``. With ``--spread`` it
prints, per cell and metric, the median and the spread (the distance
between the quartiles of ``statistics.quantiles(values, n=4)`` over the
median) of the runs without a trace; with ``--set-size N`` also of each
consecutive set of N such runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def one(cell: str, seed: str, seconds: str, trace: str, timeout: float) -> dict:
    cmd = [sys.executable, "port_bench/run.py", "--workload", cell, "--seed", seed, "--seconds", seconds,
           "--trace", trace]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    rec = {"cell": cell, "seed": int(seed), "seconds": float(seconds), "trace": int(trace), "rc": rc,
           "wall_s": time.perf_counter() - t0, "stderr_tail": err[-3000:]}
    lines = out.strip().splitlines()
    try:
        rec["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        rec["stdout_tail"] = out[-3000:]
    return rec


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q2, (q3 - q1) / q2


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", required=True)
    p.add_argument("--run", action="append", default=[])
    p.add_argument("--timeout", type=float, default=1200.0)
    p.add_argument("--spread", action="store_true")
    p.add_argument("--set-size", type=int, default=0)
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    values = defaultdict(list)
    with open(args.out, "a") as f:
        for spec in args.run:
            rec = one(*spec.split(":"), timeout=args.timeout)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            r = rec.get("result", {})
            m = {k: round(v["value"], 6) for k, v in r.get("metrics", {}).items()}
            c = {k: v["value"] for k, v in r.get("checks", {}).items()}
            print(f"{spec} rc={rec['rc']} wall={rec['wall_s']:.1f}s correct={r.get('correct')} {m} checks={c}",
                  flush=True)
            if rec["rc"] != 0 or not r:
                print(rec["stderr_tail"][-2000:], flush=True)
            if not rec["trace"]:
                for k, v in r.get("metrics", {}).items():
                    values[(rec["cell"], k)].append(v["value"])
    if args.spread:
        for (cell, k), vs in sorted(values.items()):
            if len(vs) >= 2:
                med, sp = spread(vs)
                print(f"spread {cell} {k}: n={len(vs)} median={med:.6g} spread={sp:.4%}", flush=True)
            n = args.set_size
            for i in range(0, len(vs) - n + 1 if n else 0, n or 1):
                med, sp = spread(vs[i:i + n])
                print(f"  set {i // n + 1} {cell} {k}: median={med:.6g} spread={sp:.4%} values={vs[i:i + n]}",
                      flush=True)


if __name__ == "__main__":
    main()
