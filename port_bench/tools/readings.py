"""The readings that a cell's limits are set from, on the card at the cell's
own size, in one process: for each seed, the cell's set-up, its first steps
and a short window, then the numbers that decide ``correct``
for the program (the lower readings), for the control (the reference in
TF32, ``port_bench/reference/control.py``) and for the faults planted in
the reference put in the program's place (training: half of each batch
left out).

    python3 port_bench/tools/readings.py --cell CELL --seeds 1,2,3 \\
        [--seconds 0.5] --out FILE.json

Prints, per number, the largest program reading (and of the readings that
are not compared) and the smallest reading of the control and of each fault
over the seeds; ``FILE.json`` keeps every seed's readings.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[0] = ROOT


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import importlib

    import torch

    from port_bench import harness

    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        raise SystemExit("the readings are taken on a CUDA card")
    bench = harness.benchmark()
    cell = harness.workload(bench, args.cell)
    cfg, mix = harness.configuration(bench, cell["config"]), harness.traffic(cell["traffic"])
    loop = importlib.import_module(f"port_bench.loops.{mix['loop']}")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell=args.cell, cfg=cfg, traffic=mix, seed=seed, seconds=args.seconds, trace=False,
                          t0=time.perf_counter(), device=torch.device("cuda", 0), readings={})
        loop.run(run)
        rows.append({"seed": seed, "program": run.checks, **run.readings})
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for side in (k for k in rows[0] if isinstance(rows[0][k], dict)):
        how = max if side.startswith("program") else min
        summary[f"{side} ({how.__name__})"] = {name: how(r[side][name] for r in rows) for name in rows[0][side]}
    print(json.dumps(summary, indent=1), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"cell": args.cell, "device": torch.cuda.get_device_name(0), "rows": rows, "summary": summary}, f,
                  indent=1)


if __name__ == "__main__":
    main()
