"""The synthetic cardiovascular-system (CVS) trajectories, frozen for the
benchmark: the simulator is a copy of
``structured_latent_odes_tpu_torch/data/cvs.py:22-96`` (``CVS_PARAMS``,
``cvs_rhs``, ``states_to_observations``, ``simulate_batch``, with the RK4
tableau of ``ode/tableaus.py:41-47``), and the dataset of ``make_dataset``
and ``load_splits`` (``:99-201``): interventions i_ext in {0, -2} and
r_tpr_mod in {0, 0.5}, Gaussian observation noise of 0.05, min-max
normalization from the train part, labels i_ext >= 0 and r_tpr_mod > 0.

Here every draw comes from a ``torch.Generator`` on the card seeded from
the run's seed, and the whole set is simulated in one batch there.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

CVS_PARAMS = {
    "f_hr_max": 3.0,
    "f_hr_min": 2.0 / 3.0,
    "r_tpr_max": 2.134,
    "r_tpr_min": 0.5335,
    "sv_mod": 0.0001,
    "ca": 4.0,
    "cv": 111.0,
    "k_width": 0.1838,
    "p_aset": 70.0,
    "tau": 20.0,
}
RK4_A = ((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def cvs_rhs(state: torch.Tensor, i_ext: torch.Tensor, r_tpr_mod: torch.Tensor) -> torch.Tensor:
    p = CVS_PARAMS
    p_a = 100.0 * state[..., 0]
    p_v = 10.0 * state[..., 1]
    s = state[..., 2]
    sv = 100.0 * state[..., 3]
    f_hr = s * (p["f_hr_max"] - p["f_hr_min"]) + p["f_hr_min"]
    r_tpr = s * (p["r_tpr_max"] - p["r_tpr_min"]) + p["r_tpr_min"] - r_tpr_mod
    dva_dt = -1.0 * (p_a - p_v) / r_tpr + sv * f_hr
    dvv_dt = -1.0 * dva_dt + i_ext
    dpa_dt = dva_dt / (p["ca"] * 100.0)
    dpv_dt = dvv_dt / (p["cv"] * 10.0)
    ds_dt = (1.0 / p["tau"]) * (1.0 - 1.0 / (1.0 + torch.exp(-p["k_width"] * (p_a - p["p_aset"]))) - s)
    dsv_dt = i_ext * p["sv_mod"]
    return torch.stack([dpa_dt, dpv_dt, ds_dt, dsv_dt], dim=-1)


def simulate(i_ext: torch.Tensor, r_tpr_mod: torch.Tensor, seq_len: int, delta_t: float,
             substeps: int = 10) -> torch.Tensor:
    """States (B, T, 4) from x = 1, RK4 on a ``substeps``-times finer grid."""
    x = torch.ones((i_ext.shape[0], 4), dtype=torch.float32, device=i_ext.device)
    ts = np.arange(0.0, (seq_len - 1) * delta_t + delta_t / substeps, delta_t / substeps, dtype=np.float32)
    f32 = np.float32
    kept = [x]
    for n in range(ts.shape[0] - 1):
        h = ts[n + 1] - ts[n]
        ks = []
        for ai in RK4_A:
            y = x
            for aij, kj in zip(ai, ks):
                if aij != 0.0:
                    y = y + float(h * f32(aij)) * kj
            ks.append(cvs_rhs(y, i_ext, r_tpr_mod))
        for bi, ki in zip(RK4_B, ks):
            x = x + float(h * f32(bi)) * ki
        if (n + 1) % substeps == 0:
            kept.append(x)
    return torch.stack(kept, dim=1)


def observations(states: torch.Tensor) -> torch.Tensor:
    """(B, T, 4) states -> (B, T, 3) observations (p_a, p_v, f_hr)."""
    p = CVS_PARAMS
    f_hr = states[..., 2] * (p["f_hr_max"] - p["f_hr_min"]) + p["f_hr_min"]
    return torch.stack([states[..., 0], states[..., 1], f_hr], dim=-1)


def trajectories(n: int, seed: int, device, seq_len: int = 86, delta_t: float = 1.0, noise_std: float = 0.05):
    """``n`` noisy trajectories (n, T, 3) and their labels, drawn from
    ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFFFFFF)
    u = torch.rand((2, n), generator=gen, device=device)
    i_ext = torch.where(u[0] > 0.5, 0.0, -2.0)
    r_tpr = torch.where(u[1] > 0.5, 0.0, 0.5)
    clean = observations(simulate(i_ext, r_tpr, seq_len, delta_t))
    noisy = clean + noise_std * torch.randn(clean.shape, generator=gen, device=device)
    return noisy, {"iext": (i_ext >= 0).float()[:, None], "rtpr": (r_tpr > 0).float()[:, None]}


def min_max(train: torch.Tensor):
    """Per channel (min, max) over the trajectories and steps."""
    flat = train.reshape(-1, train.shape[-1])
    return flat.min(0).values, flat.max(0).values


def model_layout(obs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Min-max normalized, channels before time: (n, K, T)."""
    return ((obs - lo) / (hi - lo)).transpose(1, 2).contiguous()


def splits(run, device) -> Tuple[Dict[str, Dict[str, np.ndarray]], np.ndarray]:
    """The configuration's train/val/test splits, simulated on ``device``
    from the run's seed, normalized by the train and val parts, in the model
    layout, as host arrays; and the time grid."""
    c, d = run.cfg["config"], run.cfg["data"]
    n_train, n_val, n_test = int(d["n_train"]), int(d["n_val"]), int(d["n_test"])
    obs, labels = trajectories(n_train + n_val + n_test, run.seed_for("data"), device, int(c["seq_len"]),
                               float(c["delta_t"]), float(c["noise_std"]))
    lo, hi = min_max(obs[:n_train + n_val])
    obs = model_layout(obs, lo, hi)
    cuts = {"train": (0, n_train), "val": (n_train, n_train + n_val), "test": (n_train + n_val, len(obs))}
    parts = {name: {"observations": obs[a:b], **{k: v[a:b] for k, v in labels.items()}}
             for name, (a, b) in cuts.items()}
    times = np.arange(0.0, c["seq_len"] * c["delta_t"], c["delta_t"], dtype=np.float32)
    return {k: {n: v.cpu().numpy() for n, v in s.items()} for k, s in parts.items()}, times
