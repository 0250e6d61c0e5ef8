"""Dataset configuration factories, copied from the JAX package's
``data/configs.py`` with the same keys and defaults: CVS, challenge and proc,
with proc's plate-reader metadata and its derived cassette and relevance
maps (``proc_data_config``).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from structured_latent_odes_tpu_torch.utils.config import Config

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_cvs_config() -> Config:
    c = Config()
    # Data
    c.data_path = os.path.join(_REPO_ROOT, "datasets", "cvs") + os.sep
    c.seq_len = 86
    c.data_size = 1000
    c.delta_t = 1.0
    c.noise_std = 0.05
    c.norm = "zero_to_one"
    c.obs_dim = 3
    c.iext_dim = 1
    c.rtpr_dim = 1
    # Model
    c.z_iext_dim = 5
    c.z_rtpr_dim = 5
    c.z_epsilon_dim = 5
    c.u_hidden_dim = 25
    c.aux_loss_multiplier = 46.0
    # Training
    c.seed = 12
    c.num_epochs = 1000
    c.plot_epoch = 100
    c.mini_batch_size = 128
    # CNN
    c.n_filters = 10
    c.filter_size = 10
    c.pool_size = 5
    c.cnn_hidden_dim = 50
    # ODE
    c.ode_state_dim = 5
    c.ode_hidden_dim = 25
    c.system_input_dim = 2
    c.learning_rate = 0.001
    c.num_particles = 1
    c.optimizer = "shared"
    c.prior_lr_mult = 1.0
    c.data_parallel = 0
    c.time_parallel = 0
    c.adjoint_solver = False
    c.ode_backend = "semilinear"
    c.ode_rtol = 1e-6  # adaptive backends only
    c.ode_atol = 1e-8
    c.solver = "midpoint"
    c.constant_std = 1e-2
    c.quantile_diff = 0.475  # select from [0.25, 0.475]
    c.model = "Mechanistic"  # or MechanisticGauss (ablation)
    return c


def load_challenge_config() -> Config:
    c = Config()
    c.data_path = os.path.join(_REPO_ROOT, "datasets", "challenge") + os.sep
    c.norm = "zero_to_one"
    c.obs_dim = 4
    c.shedding_dim = 1
    c.symptoms_dim = 1
    c.z_shedding_dim = 5
    c.z_symptoms_dim = 5
    c.z_epsilon_dim = 5
    c.u_hidden_dim = 25
    c.aux_loss_multiplier = 46.0
    c.seed = 12
    c.num_epochs = 500
    c.plot_epoch = 250
    c.mini_batch_size = 100
    c.folds = 5
    c.split = 5  # select from [1..5]
    c.n_filters = 10
    c.filter_size = 10
    c.pool_size = 5
    c.cnn_hidden_dim = 50
    c.ode_state_dim = 5
    c.ode_hidden_dim = 25
    c.system_input_dim = 2
    c.learning_rate = 0.001
    c.num_particles = 1
    c.optimizer = "shared"  # Pyro-parity single per-param Adam; "split" = round-1
    c.prior_lr_mult = 1.0  # >1: conditional-prior nets track faster (anti-collapse)
    c.data_parallel = 0  # >1: shard the batch over an N-device mesh
    c.time_parallel = 0  # >1: shard the ODE horizon over the mesh's time axis
    c.num_samples = 200
    c.adjoint_solver = False
    c.ode_backend = "semilinear"
    c.ode_rtol = 1e-6  # adaptive backends only
    c.ode_atol = 1e-8
    c.solver = "midpoint"
    c.constant_std = 1e-2
    c.quantile_diff = 0.475
    c.model = "Mechanistic"
    return c


def load_proc_config() -> Config:
    c = Config()
    c.data_path = os.path.join(_REPO_ROOT, "datasets", "proc") + os.sep
    c.seq_len = 86
    c.obs_dim = 4
    c.aR_dim = 3
    c.aS_dim = 4
    c.C12_dim = 1
    c.C6_dim = 1
    c.num_epochs = 2500
    c.mini_batch_size = 36
    c.seed = 12
    c.plot_epoch = 200
    # heldout device name (zero-shot) or None for cross-validation
    c.heldout = None  # e.g. "R33S34_Y81C76"
    c.folds = 4
    c.split = 1  # select from [1..4]
    c.n_filters = 10
    c.filter_size = 10
    c.pool_size = 5
    c.cnn_hidden_dim = 50
    c.z_aR_dim = 10
    c.z_aS_dim = 10
    c.z_C12_dim = 10
    c.z_C6_dim = 10
    c.z_epsilon_dim = 10
    c.u_hidden_dim = 25
    c.aux_loss_multiplier = 46.0
    c.ode_state_dim = 8
    c.ode_hidden_dim = 25
    c.system_input_dim = 9
    c.learning_rate = 3e-4
    c.num_particles = 1
    c.optimizer = "shared"  # Pyro-parity single per-param Adam; "split" = round-1
    c.prior_lr_mult = 1.0  # >1: conditional-prior nets track faster (anti-collapse)
    c.data_parallel = 0  # >1: shard the batch over an N-device mesh
    c.time_parallel = 0  # >1: shard the ODE horizon over the mesh's time axis
    c.num_samples = 200
    c.adjoint_solver = False
    c.ode_backend = "semilinear"
    c.ode_rtol = 1e-6  # adaptive backends only
    c.ode_atol = 1e-8
    c.solver = "midpoint"
    c.constant_std = 1e-2
    c.quantile_diff = 0.475
    c.model = "Mechanistic"
    c.data = proc_data_config()
    return c


def proc_data_config() -> Config:
    """Synbio plate-reader metadata: device groups, files, signals, and the
    derived cassette/relevance maps (reference ``Config.proc_data``,
    config_proc.py:68-131)."""
    data = Config(
        groups=Config(
            aR=[0, 1, 1, 2, 2, 2],  # LuxR RBS group per device
            aS=[0, 1, 2, 1, 2, 3],  # LasR RBS group per device
        ),
        devices=[
            "Pcat_Y81C76",
            "RS100S32_Y81C76",
            "RS100S34_Y81C76",
            "R33S32_Y81C76",
            "R33S34_Y81C76",
            "R33S175_Y81C76",
        ],
        normalize=None,
        subtract_background=True,
        conditions=["C6", "C12"],
        files=[
            "proc140916.csv",
            "proc140930.csv",
            "proc141006.csv",
            "proc141021.csv",
            "proc141023.csv",
            "proc141028.csv",
        ],
        signals=["OD", "mRFP1", "EYFP", "ECFP"],
        default_devices={},
        dtype="float32",
    )

    def depth(values):
        return len(set(v for v in values if v is not None))

    component_maps = OrderedDict()
    for key, group in data.groups.items():
        component_maps[key] = OrderedDict(zip(data.devices, group))
    data["component_maps"] = component_maps
    data["device_depth"] = int(sum(depth(cm.values()) for cm in component_maps.values()))

    relevance = OrderedDict()
    k1 = 0
    for key, group in data.groups.items():
        k2 = depth(group) + k1
        rv = np.zeros(data["device_depth"], dtype=np.float32)
        rv[k1:k2] = 1.0
        relevance[key] = rv
        k1 = k2
    data["relevance_vectors"] = relevance
    data["device_map"] = {name: float(i) for i, name in enumerate(data.devices)}
    data["device_idx_to_device_name"] = dict(enumerate(data.devices))
    data["device_lookup"] = {v: k for k, v in data["device_map"].items()}
    return data


LOADERS = {
    "cvs": load_cvs_config,
    "proc": load_proc_config,
    "challenge": load_challenge_config,
}
