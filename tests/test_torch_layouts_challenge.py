"""The port's rank layouts at the challenge workload (its config and
``datasets/challenge/``), on the CPU over gloo ranks, each held against the
port's one-device run (tests/_torch_layouts.py states the bounds):

- ``training_challenge`` with ``--data-parallel 4`` on semilinear_fused
  (K2/K3's path, two passes of its 141 steps) and on semilinear (K1's),
  ``--time-parallel 4`` and ``--data-parallel 2 --time-parallel 2``
  (semilinear_timepar), the CLI spawning its ranks; against the one-device
  run on the same backend (semilinear for the time layouts). The 28 train
  rows are padded to 32, so over four ranks rank 3 holds 4 padding rows of
  every batch;
- the eval epoch over four data ranks on the val fold: 7 rows in one batch
  of 32, all on rank 0, so ranks 1-3 hold only padding;
- the time-parallel recurrence and solve over 2 and 4 time ranks at
  challenge's 141 steps (neither divides it), against JAX;
- a sweep of four seeds over ``--ensemble-parallel 2
  --ensemble-data-parallel 2`` against the unsharded sweep in member groups
  of two.
"""

import pytest

import _torch_layouts as layouts
from _torch_layouts import one_thread_for_module  # noqa: F401 (a fixture)
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

WL = "challenge"


@pytest.fixture(scope="module")
def data(one_thread_for_module):
    return layouts.load_workload(WL)


@pytest.fixture(scope="module")
def pool(one_thread_for_module):
    with layouts.rank_pool() as p:
        yield p


@pytest.fixture(scope="module")
def one_device(one_thread_for_module, tmp_path_factory):
    return layouts.one_device_runs(WL, tmp_path_factory)


@pytest.mark.parametrize("flags,backend,bound", layouts.CLI_CASES, ids=layouts.CLI_IDS)
def test_cli_on_four_ranks_matches_one_device(one_device, tmp_path, flags, backend, bound):
    out = layouts.run_cli(WL, tmp_path, ["--ode-backend", backend] + flags)
    layouts.assert_cli_matches(WL, out, one_device(backend), bound)


@pytest.mark.parametrize("is_post", [True, False], ids=["posterior", "prior"])
def test_eval_epoch_with_padding_only_ranks(pool, data, is_post):
    assert layouts.padding_rows_by_rank(WL, data) == [[7, 0, 0, 0]]
    layouts.assert_eval_matches(pool, WL, data, is_post)


@pytest.mark.parametrize("world", [2, 4])
def test_recurrence_timepar_at_the_horizon(pool, data, world):
    assert (len(data[2]) - 1, data[0].ode_state_dim) == (141, 5)
    layouts.assert_recurrence_timepar_matches_jax(pool, WL, data, world)


@pytest.mark.parametrize("world", [2, 4])
def test_semilinear_timepar_at_the_horizon(pool, data, world):
    layouts.assert_semilinear_timepar_matches_jax(pool, WL, data, world)


def test_sweep_over_member_and_data_ranks(one_thread_for_module, tmp_path):
    grouped = layouts.run_sweep(WL, tmp_path / "grouped", ["--member-group", "2"])
    got = layouts.run_sweep(WL, tmp_path / "ranks", ["--ensemble-parallel", "2", "--ensemble-data-parallel", "2"])
    layouts.assert_sweep_close(got, grouped)
