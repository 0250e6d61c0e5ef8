"""Data, time and member parallelism over several ranks (the JAX package's
``parallel/``): one process per rank under ``torch.distributed``
(``launch.py``), grids of ranks (``mesh.py``), the data-parallel dual step
(``train.py``) and the time-sharded solve (``timepar.py``). The member axis
of the sweeps is ``train/ensemble.py::member_mesh``.

The JAX package's names, but ``replicated`` and ``batch_sharded``, which
name placements of a global array on a device mesh and have no counterpart
when each rank holds its own tensors (``mesh.py``).
"""

from structured_latent_odes_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    pad_batch_to_multiple,
    shard_batch,
    shard_stacked,
)
from structured_latent_odes_tpu_torch.parallel.timepar import (  # noqa: F401
    solve_affine_recurrence_timepar,
    solve_semilinear_timepar,
    time_sharding,
)
from structured_latent_odes_tpu_torch.parallel.train import (  # noqa: F401
    make_dp_eval_step,
    make_dp_train_step,
)
