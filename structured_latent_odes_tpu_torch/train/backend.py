"""Training-backend selection (the JAX package's ``train/backend.py``), for
one device. Data parallelism and time parallelism over several devices are
not ported yet (ROADMAP A17)."""

from __future__ import annotations

import torch

from structured_latent_odes_tpu_torch.models.spec import ModelSpec
from structured_latent_odes_tpu_torch.train.driver import device_batch
from structured_latent_odes_tpu_torch.train.svi import make_train_step


def make_training_backend(spec: ModelSpec, ts: torch.Tensor, config, params):
    """Returns (init_state, train_epoch, put_batch) on the device of ``ts``;
    ``put_batch`` moves a host batch dict (a stacked epoch or split) there."""
    dp = int(config.get("data_parallel") or 0)
    tp = int(config.get("time_parallel") or 0)
    if dp > 1 or tp > 1:
        raise NotImplementedError(
            f"--data-parallel {dp} / --time-parallel {tp}: training on several devices "
            "is not ported yet (ROADMAP A17)"
        )
    init_state, _, train_epoch = make_train_step(
        spec, ts, config.learning_rate, params,
        num_particles=config.get("num_particles", 1),
        optimizer=config.get("optimizer", "shared"),
        prior_lr_mult=float(config.get("prior_lr_mult") or 1.0),
    )
    return init_state, train_epoch, lambda b: device_batch(b, ts.device)
