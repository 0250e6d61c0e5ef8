"""Training-backend selection (the JAX package's ``train/backend.py``): one
device, or a grid of ranks with data parallelism (``--data-parallel N``: the
batch split over N ranks, the gradients summed over them) and time
parallelism (``--time-parallel M``: each solve's horizon split over M ranks,
the ``semilinear_timepar`` backend).

The JAX package runs one process over a device mesh; the port runs one
process per rank (``parallel/launch.py``). :func:`run_on_ranks` is where a
driver's run goes to its ranks: on a CUDA device each rank takes one card
and the group runs over NCCL, so the run needs ``N x M`` cards; on the CPU
it runs ``N x M`` processes over gloo. Inside the ranks,
:func:`make_training_backend` builds the ``(data, model)`` grid, installs
it as the time-sharding context when M > 1, and returns the data-parallel
step, a ``put_batch`` that keeps this rank's slice of each batch, and the
sum over the data ranks that the evaluation epoch takes.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from structured_latent_odes_tpu_torch.models.spec import ModelSpec
from structured_latent_odes_tpu_torch.parallel import launch
from structured_latent_odes_tpu_torch.parallel.mesh import data_reduce, make_mesh, shard_batch, shard_stacked
from structured_latent_odes_tpu_torch.train.driver import device_batch
from structured_latent_odes_tpu_torch.train.svi import make_train_step

def available_devices(device, asked: int) -> int:
    """The ranks a run may take: the process group's where one is up (its
    ranks exist already, as two ranks sharing one card over gloo do), else
    the cards on CUDA (one rank each) and the ranks asked for on the CPU."""
    if dist.is_initialized():
        return dist.get_world_size()
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else asked


def parallel_extent(config, device) -> Tuple[int, int]:
    """(data ranks, time ranks) of the run, checked before any work, with
    the JAX package's messages: the ranks must fit the devices (in a process
    group already up, its ranks; else on CUDA the cards, one rank each, and
    on the CPU the ranks asked for) and the minibatch must divide over the
    data ranks."""
    dp = max(int(config.get("data_parallel") or 0), 1)
    tp = max(int(config.get("time_parallel") or 0), 1)
    if dp * tp > 1:
        n_dev = available_devices(device, dp * tp)
        if dp * tp > n_dev:
            raise ValueError(f"--data-parallel {dp} x --time-parallel {tp} > {n_dev} available devices")
        if config.mini_batch_size % dp:
            raise ValueError(f"mini_batch_size {config.mini_batch_size} not divisible by --data-parallel {dp}")
    return dp, tp


def run_on_ranks(train, config, device):
    """``train(config, device)`` on the run's ranks: in this process where
    the run takes one, or where the ranks are up already (a rank itself);
    else on ``N x M`` ranks (spawned, or torchrun's), returning rank 0's
    result."""
    dp, tp = parallel_extent(config, device)
    if dp * tp == 1 or dist.is_initialized():
        return train(config, device)
    return launch.run_ranks(train, dp * tp, device=device, args=(config, device))


def make_training_backend(spec: ModelSpec, ts: torch.Tensor, config, params):
    """Returns (init_state, train_epoch, put_batch, reduce) on the device of
    ``ts``. ``put_batch`` moves a host batch dict (a stacked epoch or split)
    there: on a grid, this rank's slice of it. ``reduce`` is the sum over
    the grid's data ranks (``parallel/mesh.py::data_reduce``), the hook of
    the run's evaluation epoch (``train/svi.py::make_eval_epoch``), or None
    on one device. With time ranks the grid becomes the time-sharding
    context of the rank's process, which every later solve of the run
    reads."""
    dp, tp = parallel_extent(config, ts.device)
    kw = dict(num_particles=config.get("num_particles", 1), optimizer=config.get("optimizer", "shared"),
              prior_lr_mult=float(config.get("prior_lr_mult") or 1.0))
    if dp * tp == 1:
        init_state, _, train_epoch = make_train_step(spec, ts, config.learning_rate, params, **kw)
        return init_state, train_epoch, lambda b: device_batch(b, ts.device), None

    from structured_latent_odes_tpu_torch.parallel.train import make_dp_train_step

    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != dp * tp:
        raise ValueError(f"--data-parallel {dp} x --time-parallel {tp} needs {dp * tp} ranks, this group has "
                         f"{world}: run the driver's main, or torchrun with one process per rank")
    grid = make_mesh(n_data=dp, n_model=tp)
    if tp > 1:
        # the model spec carries backend='semilinear_timepar' (models/zoo.py)
        from structured_latent_odes_tpu_torch.parallel import timepar

        timepar.set_time_sharding(grid, time_axis="model")
    init_state, _, train_epoch = make_dp_train_step(spec, ts, config.learning_rate, params, grid, **kw)

    def put_batch(b):
        b = shard_stacked(grid, b) if b["mask"].ndim == 2 else shard_batch(grid, b)
        return device_batch(b, ts.device)

    return init_state, train_epoch, put_batch, data_reduce(grid)
