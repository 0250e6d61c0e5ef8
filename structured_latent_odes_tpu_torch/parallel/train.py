"""Data-parallel SVI training over the ranks of a grid (the JAX package's
``parallel/train.py``).

The JAX package re-jits its dual step with the batch sharded over the mesh's
``data`` axis and lets GSPMD insert the gradient all-reduce. Here each rank
runs the port's dual step (``train/svi.py::make_dual_step``) on its slice of
the batch (``parallel/mesh.py::shard_batch``), and the step's ``reduce`` hook
sums over the grid's data group: each loss's gradients before its update,
in one collective each, and the metrics' sums (losses, count, the L1's
parts) with the aux gradients. Both losses are sums over the batch
(``prob/elbo.py::Trace.loss``), so the summed gradient is the whole batch's,
every rank applies the same update to the same parameters, and the metrics
are the whole batch's ratios, never a mean of per-rank ratios.

A rank's draws need no change: a batch carries the loader's global
``sample_id``, so each rank draws for its rows exactly what one device draws
for them. On a grid with a time axis (``parallel/timepar.py``) every time
rank computes its data slice's whole loss and gradient, and the data group
sums them as above.
"""

from __future__ import annotations

from typing import Tuple

import torch

from structured_latent_odes_tpu_torch.models.spec import ModelSpec
from structured_latent_odes_tpu_torch.parallel.mesh import Grid, data_reduce
from structured_latent_odes_tpu_torch.train.svi import make_eval_fns, make_train_step


def make_dp_train_step(spec: ModelSpec, ts, lr: float, params_example, mesh: Grid, num_particles: int = 1,
                       optimizer: str = "shared", prior_lr_mult: float = 1.0):
    """Returns (init_state, train_step, train_epoch), as
    ``train/svi.py::make_train_step``, for a rank of ``mesh``: each takes
    this rank's slice of the batch (or of a stacked epoch) and steps with
    the gradients and metrics of the whole batch."""
    return make_train_step(spec, ts, lr, params_example, num_particles=num_particles, optimizer=optimizer,
                           prior_lr_mult=prior_lr_mult, reduce=data_reduce(mesh))


def make_dp_eval_step(spec: ModelSpec, ts, mesh: Grid):
    """``evaluate(params, seed, batch) -> (loss_main, loss_aux)``: the two
    losses of the whole batch (sums over its rows) from this rank's slice,
    at the eval seeds of ``train/svi.py::make_eval_fns``."""
    evaluate_losses = make_eval_fns(spec, ts)[0]
    reduce = data_reduce(mesh)

    @torch.no_grad()
    def evaluate(params, seed, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return tuple(reduce(list(evaluate_losses(params, seed, batch))))

    return evaluate
