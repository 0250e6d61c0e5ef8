"""Which card each rank takes, and how far the layouts may spread, on a
machine of four cards, with no card present (``torch.cuda``'s count and
availability and the process group's calls are patched): a spawned rank r
and a torchrun rank with ``LOCAL_RANK=r`` resolve ``"cuda"`` to ``cuda:r``
and set that card before the group comes up; ``"cuda:0"`` pins every rank
to card 0; ``--data-parallel 5`` and a sweep's mesh past the four cards
raise before any launch, naming four available devices; the world barrier
names the rank's card on NCCL."""

import argparse
import os
import queue

import pytest
import torch
import torch.distributed as dist

from structured_latent_odes_tpu_torch.parallel import launch
from structured_latent_odes_tpu_torch.sweep import member_extent
from structured_latent_odes_tpu_torch.train import backend
from structured_latent_odes_tpu_torch.utils.config import Config
from structured_latent_odes_tpu_torch.utils.device import resolve_device
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

CARDS = 4


@pytest.fixture
def four_cards(monkeypatch):
    """Four cards and a fake process group: records the cards set, the
    group's backend and the barriers' device ids."""
    seen = {"cards": [], "up": False, "backend": None, "barriers": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: CARDS)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: seen["cards"].append(int(i)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: seen["cards"][-1])

    def init(backend=None, **kw):
        seen.update(up=True, backend=backend)

    monkeypatch.setattr(dist, "is_initialized", lambda: seen["up"])
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a: seen.update(up=False))
    monkeypatch.setattr(dist, "get_backend", lambda *a: seen["backend"])
    monkeypatch.setattr(dist, "get_rank", lambda *a: int(os.environ["LOCAL_RANK"]))
    monkeypatch.setattr(dist, "barrier", lambda device_ids=None, **kw: seen["barriers"].append(device_ids))
    return seen


def _where_am_i():
    return str(resolve_device("cuda")), str(resolve_device("cuda:0"))


def _spawned_rank(rank: int, device: str):
    """``parallel/launch.py``'s rank loop, in this process, running one task."""
    tasks, results = queue.Queue(), queue.Queue()
    tasks.put((_where_am_i, ()))
    tasks.put(None)
    launch._rank_loop(rank, CARDS, "tcp://127.0.0.1:1", launch.backend_for(device), device, 60, 1, False, tasks,
                      results)
    r, ok, payload = results.get_nowait()
    assert ok, payload
    return launch._loads(payload)


@pytest.mark.parametrize("rank", range(CARDS))
def test_spawned_rank_takes_its_own_card(four_cards, monkeypatch, rank):
    monkeypatch.setenv("LOCAL_RANK", "x")  # the rank loop sets its own; restored after the test
    assert _spawned_rank(rank, "cuda") == (f"cuda:{rank}", "cuda:0")
    assert four_cards["cards"] == [rank] and four_cards["backend"] == "nccl"


@pytest.mark.parametrize("rank", range(CARDS))
def test_torchrun_rank_takes_its_local_card(four_cards, monkeypatch, rank):
    for k, v in dict(RANK=rank, WORLD_SIZE=CARDS, LOCAL_RANK=rank, MASTER_ADDR="127.0.0.1", MASTER_PORT=1).items():
        monkeypatch.setenv(k, str(v))
    assert launch.under_torchrun()
    assert launch.run_ranks(_where_am_i, CARDS, device="cuda") == (f"cuda:{rank}", "cuda:0")
    assert four_cards["cards"] == [rank] and four_cards["backend"] == "nccl"
    assert not four_cards["up"]


@pytest.mark.parametrize("rank", range(CARDS))
def test_an_indexed_device_pins_every_rank_to_its_card(four_cards, monkeypatch, rank):
    monkeypatch.setenv("LOCAL_RANK", "x")
    assert _spawned_rank(rank, "cuda:0")[1] == "cuda:0"
    assert four_cards["cards"] == [0]
    assert launch.card_index("cuda:0", rank) == 0 and launch.card_index("cuda", rank) == rank
    assert launch.card_index("cpu", rank) is None


@pytest.mark.parametrize("rank", [0, 3])
def test_rank0_first_barrier_names_the_rank_card_on_nccl(four_cards, monkeypatch, rank):
    monkeypatch.setenv("LOCAL_RANK", str(rank))
    launch._set_card(torch.device("cuda"), rank)
    four_cards.update(up=True, backend="nccl")
    order = []
    assert launch.rank0_first(lambda: order.append(rank) or "done") == "done"
    assert four_cards["barriers"] == [[rank]] and order == [rank]
    four_cards.update(backend="gloo")
    launch.rank0_first(lambda: None)
    assert four_cards["barriers"][-1] is None


def test_data_parallel_past_four_cards_raises_before_any_launch(four_cards, monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("launched ranks past the cards")

    monkeypatch.setattr(launch, "run_ranks", no_launch)
    config = Config(data_parallel=5, time_parallel=1, mini_batch_size=128)
    with pytest.raises(ValueError, match=r"--data-parallel 5 x --time-parallel 1 > 4 available devices"):
        backend.run_on_ranks(lambda c, d: None, config, "cuda")
    assert backend.parallel_extent(Config(data_parallel=4, time_parallel=1, mini_batch_size=128), "cuda") == (4, 1)
    assert backend.parallel_extent(Config(data_parallel=2, time_parallel=2, mini_batch_size=128), "cuda") == (2, 2)
    args = argparse.Namespace(ensemble_parallel=5, ensemble_data_parallel=1)
    with pytest.raises(ValueError, match=r"ensemble mesh 5x1 > 4 available devices"):
        member_extent(args, 10, "cuda")
    assert member_extent(argparse.Namespace(ensemble_parallel=0, ensemble_data_parallel=2), 8, "cuda") == (2, 2)
    assert four_cards["cards"] == [] and not four_cards["up"]
