"""Dataset configuration factories: ``load_cvs_config`` copied from the JAX
package's ``data/configs.py`` with the same keys and defaults.

Only CVS is ported in this slice; proc and challenge wait for ROADMAP A13 and
A12.
"""

from __future__ import annotations

import os

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


LOADERS = {
    "cvs": load_cvs_config,
}
