"""The port's benchmark, driven by data.

A cell of ``BENCHMARK.json``'s ``workloads`` names a configuration (its file
under ``port_bench/configs/``) and a traffic mix
(``port_bench/traffic/<mix>.json``). A configuration's ``dataset`` names its
data source, ``port_bench/data/<dataset>.py``, whose ``splits(run, device)``
makes or reads the splits from the run's seed. The mix's ``loop`` names the
general generator that drives the program (``port_bench/loops/<loop>.py``:
the training driver's epochs, a stacked sweep, closed-loop scoring), and its
other keys are that generator's parameters. Each metric is read by its own
file, ``port_bench/metrics/<metric>.py`` (or, for ``<quantity>.<part>``,
the quantity's shared ``<quantity>.py``), whose ``read(run)`` returns a
number or None; the limits that decide ``correct`` are the cell's own file,
``port_bench/limits/<cell>.json``. A cell, a mix, a configuration, a data
source or a metric is added as files alone.

One run: the generator makes its inputs from ``--seed``, warms up every
shape the cell uses (set-up, ``setup_s``: from the process's start to the
first timed unit of work), drives the program for ``--seconds``, and with
``--trace 1`` profiles a bounded, steady stretch after the window. Then the
peak device memory is read, the program's state is freed and the plain
reference (``port_bench/reference/``) follows what the timed path produced.
The result is one JSON line; a run that finds fewer cards than the cell
asks for, or finds JAX or the JAX package loaded once the window has closed,
prints none and exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "port_bench")
# top-level module names that nothing the benchmark runs may load: JAX and
# the JAX package, whose name the port's begins with (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "structured_latent_odes_tpu", "bench")
# the cells' build outputs and logs, inside the checkout (listed in .gitignore)
OUT_DIR = os.path.join(ROOT, "build", "port_bench")


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def configuration(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return load_json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(cell: str) -> Dict[str, float]:
    path = os.path.join(BENCH_DIR, "limits", f"{cell}.json")
    return {k: v["limit"] for k, v in load_json(path)["numbers"].items()} if os.path.exists(path) else {}


def load_module(path: str, name: str):
    """The module of the file ``path``, under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    """The module of ``port_bench/metrics/<name>.py``; for a metric named
    ``<quantity>.<part>`` (``mfu.train``) without a file of its own, the
    quantity's shared reader, ``<quantity>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", f"{name.split('.')[0]}.py")
    return load_module(path, f"port_bench_metric_{name.replace('.', '_')}")


def metrics_for(bench: Dict, cell: str, kind: str) -> List[Dict]:
    """The cell's metrics of ``kind`` ('end_to_end' or 'per_layer'): those
    that list the cell, and those without a list (an end-to-end metric in
    every cell; a per-layer one wherever the metric it moves is reported)."""
    e2e = [m["name"] for m in metrics_for(bench, cell, "end_to_end")] if kind == "per_layer" else None
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_modules() -> List[str]:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """One run of a cell: its inputs, and what the generator leaves for the
    metric readers and the result line."""

    cell: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: object
    chips: int = 1
    limits: Dict[str, float] = field(default_factory=dict)
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    work: Dict[str, float] = field(default_factory=dict)  # counts of the window: trajectories, steps, epochs
    traced_work: Dict[str, float] = field(default_factory=dict)  # the same counts of the traced stretch
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, float] = field(default_factory=dict)  # number compared -> its value
    trace_summary: Optional[Dict] = None
    memory_peak_bytes: int = 0
    readings: Optional[Dict] = None  # the control's and the faults' numbers, where a calibration asks for them
    phases: List[Tuple[str, float]] = field(default_factory=list)  # set-up's phases: (name, seconds since t0)
    ticks: List[float] = field(default_factory=list)  # the window's unit ends (epochs, chunks), host clock

    def mark(self, phase: str) -> None:
        """The end of one phase of set-up, for its breakdown on stderr."""
        import time

        self.phases.append((phase, time.perf_counter() - self.t0))

    def seed_for(self, tag: str) -> int:
        """A 63-bit seed for one use (``tag``) from the run's seed."""
        words = np.random.SeedSequence([self.seed & (2 ** 64 - 1), zlib.crc32(tag.encode())]).generate_state(2)
        return (int(words[0]) << 31) ^ int(words[1])

    def log_path(self, what: str) -> str:
        os.makedirs(OUT_DIR, exist_ok=True)
        return os.path.join(OUT_DIR, f"{self.cell}.{what}.log")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = benchmark()
    cell = workload(bench, args.workload)
    import torch

    torch.set_num_threads(2)
    need = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: {args.workload} needs {need} CUDA card(s), found {have}; no result", file=sys.stderr)
        return 2
    run = Run(cell=args.workload, cfg=configuration(bench, cell["config"]), traffic=traffic(cell["traffic"]),
              seed=args.seed, seconds=args.seconds, trace=bool(args.trace), t0=t0, device=torch.device("cuda", 0),
              chips=need, limits=limits(args.workload))
    return execute(run, bench)


def execute(run: Run, bench: Dict) -> int:
    """Drive the cell's generator, then judge and print the result."""
    loop = importlib.import_module(f"port_bench.loops.{run.traffic['loop']}")
    loop.run(run)
    return finish(run, bench)


def judged(run: Run) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each number compared beside its limit, and whether every one is
    within it (a number with no limit, or not finite, is not)."""
    checks = {k: {"value": v, "limit": run.limits.get(k)} for k, v in run.checks.items()}
    ok = bool(checks) and all(c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    return ok, checks


def finish(run: Run, bench: Dict) -> int:
    found = forbidden_modules()
    if found:
        print(f"port_bench: loaded once the window closed: {', '.join(found)}; no result", file=sys.stderr)
        return 3
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, run.cell, kind):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct, checks = judged(run)
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type, "count": run.chips,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.device.type == "cuda":
        import torch

        device["kind"] = torch.cuda.get_device_name(run.device)
    line = {"correct": correct, "attempted": int(run.attempted), "failed": int(run.failed), "metrics": metrics,
            "device": device}
    if run.trace and run.trace_summary is not None:
        device["busy_s"] = run.trace_summary["busy_s"]
        device["window_s"] = run.trace_summary["window_s"]
        line["breakdown"] = {"device_ops": run.trace_summary["device_ops"],
                             "idle_gaps": run.trace_summary["idle_gaps"]}
    line["checks"] = checks
    sys.stdout.flush()
    if run.phases:
        print("set-up phases (s since start): " + ", ".join(f"{n} {t:.3f}" for n, t in run.phases), file=sys.stderr)
    if len(run.ticks) >= 8:
        q = len(run.ticks) // 4
        rates = [q / (run.ticks[(i + 1) * q] - run.ticks[i * q]) for i in range(3)]
        print("window: " + f"{len(run.ticks)} units; units/s by quarter " + " ".join(f"{r:.4g}" for r in rates),
              file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
