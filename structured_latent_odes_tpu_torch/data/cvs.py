"""Synthetic cardiovascular-system (CVS) dataset (the JAX package's
``data/cvs.py``).

The 4-state mechanistic ODE integrates for the whole batch at once with
fixed-step RK4 on a 10x refined grid, in PyTorch on the caller's device. The
interventions and the observation noise come from numpy ``RandomState(seed)``
in the JAX package's order, so they are bit-identical to its draws.

States: normalized (p_a/100, p_v/10, s, sv/100); observations (p_a, p_v, f_hr).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from structured_latent_odes_tpu_torch.data.transforms import find_norm_params
from structured_latent_odes_tpu_torch.ode.tableaus import RK4

# Fixed physiological parameters; i_ext / r_tpr_mod vary per trajectory.
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


def cvs_rhs(t, state: torch.Tensor, i_ext: torch.Tensor, r_tpr_mod: torch.Tensor) -> torch.Tensor:
    """Mechanistic RHS d(state)/dt; state (..., 4) normalized."""
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
    ds_dt = (1.0 / p["tau"]) * (
        1.0 - 1.0 / (1.0 + torch.exp(-p["k_width"] * (p_a - p["p_aset"]))) - s
    )
    dsv_dt = i_ext * p["sv_mod"]
    return torch.stack([dpa_dt, dpv_dt, ds_dt, dsv_dt], dim=-1)


def states_to_observations(states: np.ndarray) -> np.ndarray:
    """(.., T, 4) states -> (.., T, 3) observations (p_a_norm, p_v_norm, f_hr)."""
    p = CVS_PARAMS
    f_hr = states[..., 2] * (p["f_hr_max"] - p["f_hr_min"]) + p["f_hr_min"]
    return np.stack([states[..., 0], states[..., 1], f_hr], axis=-1)


def simulate_batch(i_ext: torch.Tensor, r_tpr_mod: torch.Tensor, seq_len: int = 86,
                   delta_t: float = 1.0, substeps: int = 10) -> torch.Tensor:
    """Integrate a batch of CVS systems from x = 1 on ``i_ext``'s device.

    Returns states (B, T, 4) at every ``substeps``-th point of the refined
    grid. The grid is the JAX package's float32 ``arange`` and each step size
    and tableau product is rounded to float32 as there.
    """
    x = torch.ones((i_ext.shape[0], 4), dtype=torch.float32, device=i_ext.device)
    ts = np.arange(0.0, (seq_len - 1) * delta_t + delta_t / substeps, delta_t / substeps,
                   dtype=np.float32)
    f32 = np.float32
    kept = [x]
    for n in range(ts.shape[0] - 1):
        h = ts[n + 1] - ts[n]
        ks = []
        for ai in RK4.a:
            y = x
            for aij, kj in zip(ai, ks):
                if aij != 0.0:
                    y = y + float(h * f32(aij)) * kj
            ks.append(cvs_rhs(None, y, i_ext, r_tpr_mod))
        for bi, ki in zip(RK4.b, ks):
            x = x + float(h * f32(bi)) * ki
        if (n + 1) % substeps == 0:
            kept.append(x)
    return torch.stack(kept, dim=1)


def make_dataset(output_dir: str, data_size: int = 1000, seq_len: int = 86, delta_t: float = 1.0,
                 noise_std: float = 0.05, seed: int = 12, device="cuda") -> str:
    """Generate and write ``cvs.npz``: a 90/10 train/test split, observation
    noise, norm params, and the ground-truth latents and interventions."""
    rng = np.random.RandomState(seed)
    i_ext = np.where(rng.rand(data_size) > 0.5, 0.0, -2.0).astype(np.float32)
    r_tpr_mod = np.where(rng.rand(data_size) > 0.5, 0.0, 0.5).astype(np.float32)

    states = simulate_batch(
        torch.from_numpy(i_ext).to(device), torch.from_numpy(r_tpr_mod).to(device), seq_len, delta_t
    ).cpu().numpy()  # (N, T, 4)
    raw = states_to_observations(states)  # (N, T, 3)

    buffer = int(round(data_size * 0.9))
    train_clean, test_clean = raw[:buffer], raw[buffer:]
    noisy_train = train_clean + noise_std * rng.standard_normal(train_clean.shape)
    noisy_test = test_clean + noise_std * rng.standard_normal(test_clean.shape)

    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "cvs.npz")
    norm_params = find_norm_params(noisy_train)
    np.savez(
        path,
        train_obs=noisy_train.astype(np.float32),
        test_obs=noisy_test.astype(np.float32),
        gt_test_obs=test_clean.astype(np.float32),
        train_latent=states[:buffer].astype(np.float32),
        test_latent=states[buffer:].astype(np.float32),
        train_iext=i_ext[:buffer],
        train_rtpr=r_tpr_mod[:buffer],
        test_iext=i_ext[buffer:],
        test_rtpr=r_tpr_mod[buffer:],
        **{f"norm_{k}": v for k, v in norm_params.items()},
    )
    return path


def load_splits(config, device="cuda"):
    """Train/val/test splits with binarized labels, and the norm params.

    Generates ``cvs.npz`` under ``config.data_path`` (on ``device``) when it
    is missing. The train part splits 90/10 into train/val. Each split is a
    dict of numpy arrays: observations (N, T, K), labels (N, 1).
    """
    path = os.path.join(config.data_path, "cvs.npz")
    if not os.path.exists(path):
        print(f"CVS dataset not found at {path} — generating on {device}...")
        make_dataset(
            config.data_path,
            data_size=config.data_size,
            seq_len=config.seq_len,
            delta_t=config.delta_t,
            noise_std=config.get("noise_std", 0.05),
            seed=config.seed,
            device=device,
        )
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    norm_params = {k[len("norm_"):]: d[k] for k in list(d) if k.startswith("norm_")}

    buffer = int(round(d["train_obs"].shape[0] * 0.9))

    def pack(obs, iext, rtpr):
        return {
            "observations": obs.astype(np.float32),
            "iext": (iext >= 0).astype(np.float32)[:, None],
            "rtpr": (rtpr > 0).astype(np.float32)[:, None],
        }

    splits = {
        "train": pack(d["train_obs"][:buffer], d["train_iext"][:buffer], d["train_rtpr"][:buffer]),
        "val": pack(d["train_obs"][buffer:], d["train_iext"][buffer:], d["train_rtpr"][buffer:]),
        "test": pack(d["test_obs"], d["test_iext"], d["test_rtpr"]),
    }
    return splits, norm_params
