"""The proc plate reads, frozen for the benchmark: a copy of the ``csv`` path
of ``structured_latent_odes_tpu_torch/data/proc.py:45-215`` (``parse_file``
without the native parser, ``merge_observations``, ``scale_data``,
``get_cassettes``, ``build_dataset``, ``split_folds``, ``build_splits``)
over the configuration's ``data`` section.

Each file: the first data row is the time row, a header is cut at its first
``.``, the signal is the text in the header's first parentheses, readings
are float32. Files merge on the grid of the file with the fewest series by
nearest neighbour (the reference's quirk: a 100-point grid), each signal is
scaled by its maximum and each series has its minimum subtracted, devices
become a multi-one-hot cassette code, input concentrations go through
log1p, and the fold is a permutation of the series from the split seed.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict

import numpy as np

from port_bench import harness


def _signal(header: str) -> str:
    m = re.search(r"\(([^)]*)\)", header)
    return m.group(1) if m else header


def _conditions(s: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    if "=" not in s:
        return out
    for part in s.split(";"):
        k, _, v = part.partition("=")
        out[k.strip()] = float(v)
    return out


def parse_file(path: str, d: Dict):
    """(device indices (L,), treatments (L, C), times (T,), observations
    (L, S, T)) of one file, or None if no configured device appears."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    header, time_row, data_rows = rows[0], rows[1], rows[2:]
    data_rows = [r for r in data_rows if r[0] in d["devices"]]
    if not data_rows:
        return None
    device_idx = np.array([d["devices"].index(r[0]) for r in data_rows], dtype=int)
    conds = [_conditions(r[4]) for r in data_rows]
    keys = []
    for c in conds:
        keys += [k for k in c if k not in keys]
    extra = [k for k in keys if k not in d["conditions"]]
    keep = [i for i, c in enumerate(conds) if all(c.get(k, 0.0) == 0.0 for k in extra)]
    treatments = np.array([[conds[i].get(k, 0.0) for k in d["conditions"]] for i in keep], dtype=np.float32)
    signals = np.array([_signal(h.split(".")[0]) for h in header[5:]])
    readings = np.stack([np.array([float(x) for x in data_rows[i][5:]], dtype=np.float32) for i in keep])
    obs = np.stack([readings[:, signals == s] for s in d["signals"]], axis=1)
    times = np.array([float(x) for x in time_row[5:]], dtype=np.float32)[signals == "OD"]
    return device_idx[keep], treatments, times, obs


def build_dataset(root: str, d: Dict) -> Dict[str, np.ndarray]:
    parsed = [p for p in (parse_file(os.path.join(root, d["dir"], f), d) for f in d["files"]) if p is not None]
    lengths = [len(p[3]) for p in parsed]
    grid = parsed[int(np.argmin(lengths))][2]
    aligned = []
    for _, _, t, obs in parsed:
        idx = np.abs(t[None, :] - grid[:, None]).argmin(axis=1)
        aligned.append(obs[:, :, idx])
    X = np.vstack(aligned).copy()
    for i in range(X.shape[1]):
        X[:, i, :] /= float(np.max(X[:, i, :]))
        if d["subtract_background"]:
            X[:, i, :] -= X[:, i, :].min(axis=1, keepdims=True)
    devices = np.concatenate([p[0] for p in parsed])
    depths = [len(set(g)) for g in d["groups"].values()]
    cassettes = []
    for dev in devices:
        parts = []
        for n, group in zip(depths, d["groups"].values()):
            v = np.zeros(n, dtype=np.float32)
            v[group[int(dev)]] = 1.0
            parts.append(v)
        cassettes.append(np.concatenate(parts))
    return {
        "observations": X.astype(np.float32),
        "dev_1hot": np.stack(cassettes),
        "inputs": np.log1p(np.concatenate([p[1] for p in parsed])).astype(np.float32),
        "times": np.asarray(grid, dtype=np.float32),
    }


def splits(run, device):
    """The fold ``config.split`` of ``config.folds`` (val), drawn from the
    run's seed, and the rest (train), each a dict of float32 host arrays with
    the labels aR, aS, C12, C6; and the time grid. The files lie under the
    checkout's root; ``device`` is not used."""
    c, d = run.cfg["config"], run.cfg["data"]
    data = build_dataset(harness.ROOT, d)
    n = len(data["observations"])
    split_seed = run.seed_for("fold") & 0xFFFFFFFF
    chunks = np.array_split(np.random.RandomState(split_seed).permutation(n), int(c["folds"]))
    val = np.sort(chunks[int(c["split"]) - 1])
    train = np.setdiff1d(np.arange(n, dtype=int), val)

    def pack(ids):
        return {
            "observations": data["observations"][ids],
            "aR": data["dev_1hot"][ids][:, :3],
            "aS": data["dev_1hot"][ids][:, 3:],
            "C12": data["inputs"][ids][:, 0:1],
            "C6": data["inputs"][ids][:, 1:2],
        }

    return {"train": pack(train), "val": pack(val)}, data["times"]
