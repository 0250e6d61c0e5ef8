"""The port's rank layouts at the proc workload (its config and
``datasets/proc/``), on the CPU over gloo ranks, each held against the
port's one-device run (tests/_torch_layouts.py states the bounds):

- ``training_proc`` with ``--data-parallel 4`` on semilinear_fused (K2/K3's
  path) and on semilinear (K1's), ``--time-parallel 4`` and
  ``--data-parallel 2 --time-parallel 2`` (semilinear_timepar), the CLI
  spawning its ranks; against the one-device run on the same backend
  (semilinear for the time layouts);
- the eval epoch over four data ranks on the val fold: 78 rows in batches of
  36, so the last batch holds 6 real rows, all on rank 0, and ranks 1-3 hold
  only padding in it;
- the time-parallel recurrence and solve over 2 and 4 time ranks at proc's
  99 steps and ODE state 8 (4 divides neither), against JAX;
- a sweep of four seeds over ``--ensemble-parallel 2`` (bit for bit the
  unsharded sweep in member groups of two) and over ``--ensemble-parallel 2
  --ensemble-data-parallel 2``.
"""

import pytest

import _torch_layouts as layouts
from _torch_layouts import one_thread_for_module  # noqa: F401 (a fixture)
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

WL = "proc"


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
    assert layouts.padding_rows_by_rank(WL, data) == [[9, 9, 9, 9], [9, 9, 9, 9], [6, 0, 0, 0]]
    layouts.assert_eval_matches(pool, WL, data, is_post)


@pytest.mark.parametrize("world", [2, 4])
def test_recurrence_timepar_at_the_horizon(pool, data, world):
    assert (len(data[2]) - 1, data[0].ode_state_dim) == (99, 8)
    layouts.assert_recurrence_timepar_matches_jax(pool, WL, data, world)


@pytest.mark.parametrize("world", [2, 4])
def test_semilinear_timepar_at_the_horizon(pool, data, world):
    layouts.assert_semilinear_timepar_matches_jax(pool, WL, data, world)


@pytest.fixture(scope="module")
def grouped_sweep(one_thread_for_module, tmp_path_factory):
    return layouts.run_sweep(WL, tmp_path_factory.mktemp("sweep-g2"), ["--member-group", "2"])


def test_sweep_over_member_ranks_is_the_grouped_sweep(grouped_sweep, tmp_path):
    layouts.assert_sweep_bit_equal(layouts.run_sweep(WL, tmp_path, ["--ensemble-parallel", "2"]), grouped_sweep)


def test_sweep_over_member_and_data_ranks(grouped_sweep, tmp_path):
    got = layouts.run_sweep(WL, tmp_path, ["--ensemble-parallel", "2", "--ensemble-data-parallel", "2"])
    layouts.assert_sweep_close(got, grouped_sweep)
