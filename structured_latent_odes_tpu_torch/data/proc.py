"""Synthetic-biology plate-reader ("proc") dataset pipeline, copied from the
JAX package's ``data/proc.py``:

- parse each plate-reader CSV: device rows, ``C6=x;C12=y`` condition strings,
  per-signal reading columns (the signal name taken from the ``Raw Data
  (EYFP) ...`` headers), the time row of the OD signal;
- merge all files onto one file's time grid by nearest-neighbour alignment;
- per-signal max scaling and per-series background subtraction;
- device -> multi-one-hot cassette encoding (aR/aS RBS groups);
- log1p of the input concentrations;
- a 4-fold cross-validation split or a held-out-device (zero-shot) split.

Each file is parsed by the repo's C++ parser (``native/``, bound by the
port's own ``native`` module) where the library builds, and otherwise with
the standard library's ``csv`` module, with the semantics of the JAX
package's pandas path (``read_csv(na_filter=False)``): the first data row is
the time row, a header is cut at its first ``.``, and readings are parsed as
floats and stored as float32. The two parses give equal arrays (tested). The
C++ parser releases the GIL, so ``build_dataset`` parses the files in
threads.
"""

from __future__ import annotations

import csv
import os
import re
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from structured_latent_odes_tpu_torch import native


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def _extract_signal(header: str) -> str:
    """Signal name from a column header: text inside the first parentheses,
    else the header itself (e.g. 'Raw Data (EYFP) 12 - 2 h' -> 'EYFP')."""
    m = re.search(r"\(([^)]*)\)", header)
    return m.group(1) if m else header


def _parse_conditions(s: str) -> OrderedDict:
    """'C6=25000;C12=5' -> {'C6': 25000.0, 'C12': 5.0}; non-assignments -> {}."""
    out: OrderedDict = OrderedDict()
    if "=" not in s:
        return out
    for part in s.split(";"):
        k, _, v = part.partition("=")
        out[k.strip()] = float(v)
    return out


def _floats(cells: List[str]) -> np.ndarray:
    return np.array([float(c) for c in cells], dtype=np.float32)


def parse_file(csv_path: str, data_cfg, use_native: bool = True) -> Optional[Tuple[np.ndarray, ...]]:
    """Parse one plate-reader CSV, with the C++ parser where ``use_native``
    and the library loads, else with ``csv``.

    Returns (device_indices (L,), treatments (L, C), times (T,),
    observations (L, S, T)) or None if no configured device appears.
    """
    dtype = np.float32 if data_cfg.dtype == "float32" else np.float64
    if use_native:
        res = native.parse_proc_csv_native(csv_path, data_cfg.devices, data_cfg.conditions, data_cfg.signals)
        if res is not None:
            dev, treat, times, obs = res
            return dev, treat.astype(dtype), times.astype(dtype), obs.astype(dtype)
        if native.lib() is not None:
            return None  # parsed, and no configured device appears
    with open(csv_path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]  # blank lines skipped, as pandas does
    header, time_row, data_rows = rows[0], rows[1], rows[2:]
    data_rows = [r for r in data_rows if r[0] in data_cfg.devices]
    if not data_rows:
        return None

    device_idx = np.array([int(data_cfg.device_map[r[0]]) for r in data_rows], dtype=int)

    conds = [_parse_conditions(r[4]) for r in data_rows]
    all_keys: List[str] = []
    for c in conds:
        for k in c:
            if k not in all_keys:
                all_keys.append(k)
    extra_keys = [k for k in all_keys if k not in data_cfg.conditions]
    # keep rows whose non-configured treatments are all zero
    keep_locs = [i for i, c in enumerate(conds) if all(c.get(k, 0.0) == 0.0 for k in extra_keys)]
    treatments = np.array(
        [[conds[i].get(k, 0.0) for k in data_cfg.conditions] for i in keep_locs], dtype=np.float32
    )
    device_idx = device_idx[keep_locs]

    headers = [h.split(".")[0] for h in header[5:]]
    header_signals = np.array([_extract_signal(h) for h in headers])
    readings = np.stack([_floats(data_rows[i][5:]) for i in keep_locs])
    obs = np.stack([readings[:, header_signals == sig] for sig in data_cfg.signals], axis=1)  # (L, S, T)
    times = _floats(time_row[5:])[header_signals == "OD"]
    return device_idx, treatments.astype(dtype), times.astype(dtype), obs.astype(dtype)


# ---------------------------------------------------------------------------
# merging / preprocessing
# ---------------------------------------------------------------------------


def merge_observations(times_list, observations_list):
    """Align every file's series to one file's time grid by nearest-neighbour
    index lookup, then stack.

    The reference's quirk is kept: it picks the grid of the file with the
    fewest observation rows (``len(observations)`` counts series, not time
    points), which selects a 100-point grid although one file has only 86
    time points. The dataset is then (312, 4, 100).
    """
    lengths = [len(obs) for obs in observations_list]
    chosen = times_list[int(np.argmin(lengths))]
    aligned = []
    for t, obs in zip(times_list, observations_list):
        idx = np.abs(np.asarray(t)[None, :] - np.asarray(chosen)[:, None]).argmin(axis=1)
        aligned.append(obs[:, :, idx])
    return chosen, np.vstack(aligned)


def scale_data(X: np.ndarray, data_cfg) -> Tuple[np.ndarray, List[float]]:
    """Per-signal max scaling (or configured scales) and per-series
    background subtraction. X: (L, S, T); a modified copy is returned."""
    X = X.copy()
    n_signals = X.shape[1]
    if data_cfg.normalize is None:
        scales = [float(np.max(X[:, i, :])) for i in range(n_signals)]
    else:
        scales = list(data_cfg.normalize)
    for i, scale in enumerate(scales):
        X[:, i, :] /= scale
        if data_cfg.subtract_background:
            X[:, i, :] -= X[:, i, :].min(axis=1, keepdims=True)
    return X, scales


def get_cassettes(device_indices: np.ndarray, data_cfg) -> np.ndarray:
    """Multi-one-hot cassette encoding: per group (aR then aS), one-hot of the
    device's component id. Shape (L, device_depth)."""
    group_depths = [
        len(set(v for v in cm.values() if v is not None)) for cm in data_cfg.component_maps.values()
    ]
    rows = []
    for d in device_indices:
        name = data_cfg.device_idx_to_device_name[int(d)]
        parts = []
        for n, cm in zip(group_depths, data_cfg.component_maps.values()):
            v = np.zeros(n, dtype=np.float32)
            if cm[name] is not None:
                v[cm[name]] = 1.0
            parts.append(v)
        rows.append(np.concatenate(parts))
    return np.stack(rows)


def build_dataset(config) -> Dict[str, np.ndarray]:
    """Parse and merge all configured files into one dataset dict:
    observations (L, S, T), dev_1hot (L, depth), inputs (L, 2) [log1p],
    devices (L,), times (T,), scales (S,)."""
    paths = [os.path.join(config.data_path, f) for f in config.data.files]
    with ThreadPoolExecutor(max_workers=len(paths)) as ex:
        parsed = list(ex.map(lambda p: parse_file(p, config.data), paths))
    parsed = [p for p in parsed if p is not None]
    devices = np.concatenate([p[0] for p in parsed])
    inputs = np.concatenate([p[1] for p in parsed])
    times, observations = merge_observations([p[2] for p in parsed], [p[3] for p in parsed])
    obs_scaled, scales = scale_data(observations, config.data)
    return {
        "observations": obs_scaled,  # (L, S, T): already channel-major
        "dev_1hot": get_cassettes(devices, config.data),
        "inputs": np.log1p(inputs).astype(np.float32),
        "devices": devices,
        "times": np.asarray(times, dtype=np.float32),
        "scales": np.asarray(scales, dtype=np.float32),
    }


# ---------------------------------------------------------------------------
# splits
# ---------------------------------------------------------------------------


def split_holdout_device(dataset, config) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-shot split: the named device becomes the validation set."""
    if config.heldout not in config.data.device_map:
        raise ValueError(
            f"--heldout must be one of {list(config.data.device_map)} (got {config.heldout!r})"
        )
    holdout_id = int(config.data.device_map[config.heldout])
    devices = dataset["devices"].astype(int)
    val = np.where(devices == holdout_id)[0]
    train = np.where(devices != holdout_id)[0]
    return train, val


def split_folds(dataset, config) -> Tuple[np.ndarray, np.ndarray]:
    n = len(dataset["devices"])
    if not 1 <= config.split <= config.folds:
        raise ValueError(f"--split must be in [1, {config.folds}] (got {config.split})")
    split_seed = config.get("data_seed")  # --data-seed pins the fold
    if split_seed is None:
        split_seed = config.seed
    rng = np.random.RandomState(split_seed)
    indices = rng.permutation(n)
    chunks = np.array_split(indices, config.folds)
    val_ids = np.sort(chunks[config.split - 1])
    train_ids = np.setdiff1d(np.arange(n, dtype=int), val_ids)
    return train_ids, val_ids


def build_splits(config):
    """Returns (splits, times): train/val dicts in the model layout, with the
    labels unpacked as the reference's ``batch_to_device`` does: aR =
    dev_1hot[:, :3], aS = dev_1hot[:, 3:], C12 = inputs[:, 0:1], C6 =
    inputs[:, 1:2]."""
    dataset = build_dataset(config)
    if config.get("heldout"):
        train_ids, val_ids = split_holdout_device(dataset, config)
    else:
        train_ids, val_ids = split_folds(dataset, config)

    def pack(ids):
        return {
            "observations": dataset["observations"][ids].astype(np.float32),
            "aR": dataset["dev_1hot"][ids][:, :3],
            "aS": dataset["dev_1hot"][ids][:, 3:],
            "C12": dataset["inputs"][ids][:, 0:1],
            "C6": dataset["inputs"][ids][:, 1:2],
            "dev_1hot": dataset["dev_1hot"][ids],
            "inputs": dataset["inputs"][ids],
        }

    return {"train": pack(train_ids), "val": pack(val_ids)}, dataset["times"]
