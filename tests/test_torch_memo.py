"""The PyTorch port's ``utils/memo.py::BoundedMemo`` (its own copy, which
holds the captured graphs of ``train/svi.py``) against the JAX package's
``utils/memo.py::BoundedMemo``: the same sequences of get, set, contains,
len and clear give the same answers and leave the same keys in the same
order, so eviction drops the same entries (least recently used first).
Leaving a process group first empties every memo."""

import pytest

from structured_latent_odes_tpu.utils.memo import BoundedMemo as JaxBoundedMemo
from structured_latent_odes_tpu_torch.utils.memo import BoundedMemo

# (maxsize, operations): ("set", key, value), ("get", key), ("get", key,
# default), ("contains", key), ("len",), ("clear",)
SEQUENCES = {
    "fill_past_capacity": (8, [("set", k, k * 10) for k in range(11)]
                           + [("contains", k) for k in range(11)] + [("len",)]),
    "get_refreshes": (2, [("set", "a", 1), ("set", "b", 2), ("get", "a"), ("set", "c", 3),
                          ("contains", "a"), ("contains", "b"), ("get", "b"), ("get", "c")]),
    "overwrite_refreshes": (2, [("set", "a", 1), ("set", "b", 2), ("set", "a", 9), ("set", "c", 3),
                                ("get", "a"), ("contains", "b"), ("len",)]),
    "miss_leaves_order": (3, [("set", 1, "x"), ("set", 2, "y"), ("get", 7), ("get", 7, "dflt"),
                              ("set", 3, "z"), ("set", 4, "w"), ("contains", 1), ("get", 2)]),
    "clear_then_reuse": (2, [("set", "a", 1), ("set", "b", 2), ("clear",), ("len",), ("get", "a"),
                             ("contains", "b"), ("set", "c", 3), ("set", "a", 4), ("set", "d", 5),
                             ("contains", "c"), ("len",)]),
    "capacity_one": (1, [("set", (1, "k"), 1), ("set", (2, "k"), 2), ("contains", (1, "k")),
                         ("get", (2, "k")), ("get", (1, "k"), -1)]),
}


def _apply(memo, op):
    kind, *args = op
    if kind == "set":
        memo[args[0]] = args[1]
        return None
    if kind == "get":
        return memo.get(*args)
    if kind == "contains":
        return args[0] in memo
    if kind == "len":
        return len(memo)
    if kind == "clear":
        return memo.clear()
    raise ValueError(kind)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_bounded_memo_matches_jax(name):
    maxsize, ops = SEQUENCES[name]
    port, ref = BoundedMemo(maxsize), JaxBoundedMemo(maxsize)
    for i, op in enumerate(ops):
        assert _apply(port, op) == _apply(ref, op), (name, i, op)
        assert list(port._d.items()) == list(ref._d.items()), (name, i, op)  # eviction order
    assert len(port) == len(ref) <= maxsize


def test_leaving_a_group_first_drops_every_memo(monkeypatch):
    """``parallel/launch.py::_leave_group`` empties every BoundedMemo (each
    graph they hold, whose collectives may use the group) before it
    destroys the process group."""
    from structured_latent_odes_tpu_torch.parallel import launch
    from structured_latent_odes_tpu_torch.utils.graphs import GRAPHS

    mine = BoundedMemo()
    mine["step"] = object()
    GRAPHS["fn"] = object()
    seen = []
    monkeypatch.setattr(launch.dist, "destroy_process_group", lambda: seen.append((len(mine), len(GRAPHS))))
    launch._leave_group()
    assert seen == [(0, 0)]
