"""A seed's initial weights do not depend on torch's intra-op thread count
(nn/init.py::orthogonal runs its QR at one thread; LAPACK blocks the QR by
the thread count, so at 2 or 4 threads the CVS encoder's 730-square QR
rounds away from its one-thread result).

``init_params`` of the CVS, proc and challenge specs at 1, 2 and 4 threads
is held bit for bit to its one-thread result, and the caller's thread count
is restored; the orthogonal init keeps its contract: Q^T Q = I to 1e-5 and
R's diagonal positive (torch.nn.init.orthogonal_'s sign convention), bit
for bit the QR run directly at one thread."""

import math

import pytest
import torch

from structured_latent_odes_tpu_torch.data.configs import LOADERS
from structured_latent_odes_tpu_torch.models import challenge_spec, cvs_spec, init_params, proc_spec
from structured_latent_odes_tpu_torch.nn import init as port_init
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

SEED = 7
SPECS = {
    "cvs": lambda: cvs_spec(LOADERS["cvs"]()),
    "proc": lambda: proc_spec(LOADERS["proc"](), n_time=100),
    "challenge": lambda: challenge_spec(LOADERS["challenge"](), n_time=142),
}
_ONE_THREAD = {}


def _at_threads(threads: int, fn):
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return fn()
    finally:
        torch.set_num_threads(before)


def _one_thread_params(name: str):
    if name not in _ONE_THREAD:
        _ONE_THREAD[name] = _at_threads(1, lambda: init_params(SPECS[name](), SEED, device="cpu"))
    return _ONE_THREAD[name]


@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_init_params_bit_equal_at_any_thread_count(name, threads):
    ref = _one_thread_params(name)
    spec = SPECS[name]()

    def draw():
        got = init_params(spec, SEED, device="cpu")
        assert torch.get_num_threads() == threads, "init_params must restore the caller's thread count"
        return got

    got = _at_threads(threads, draw)
    for g, r in zip(tree_leaves(got), tree_leaves(ref), strict=True):
        assert torch.equal(g, r), f"{name}: a weight at {threads} threads differs from its one-thread draw"


def test_orthogonal_keeps_its_contract_and_restores_threads_on_error(monkeypatch):
    rows, cols = 50, 730  # the CVS encoder's lin, (hidden, flat_dim)
    q = _at_threads(4, lambda: port_init.orthogonal(torch.Generator().manual_seed(3), (rows, cols)))
    assert q.shape == (rows, cols)
    assert float((q @ q.T - torch.eye(rows)).abs().max()) < 1e-5

    a = torch.randn((cols, cols), generator=torch.Generator().manual_seed(3))
    ref_q, ref_r = _at_threads(1, lambda: torch.linalg.qr(a))
    ref = ref_q * torch.sign(torch.diagonal(ref_r))
    assert torch.equal(q, ref[:rows])
    assert bool((torch.diagonal(ref.T @ a) > 0).all()), "R's diagonal must come out positive"

    conv = port_init.orthogonal(torch.Generator().manual_seed(4), (10, 3, 10))  # rows < cols, trailing dims flat
    flat = conv.reshape(10, math.prod((3, 10)))
    assert float((flat @ flat.T - torch.eye(10)).abs().max()) < 1e-5

    def broken(_a):
        raise RuntimeError("qr failed")

    monkeypatch.setattr(torch.linalg, "qr", broken)

    def raising():
        with pytest.raises(RuntimeError, match="qr failed"):
            port_init.orthogonal(torch.Generator().manual_seed(3), (4, 4))
        return torch.get_num_threads()

    assert _at_threads(3, raising) == 3, "orthogonal must restore the caller's thread count when the QR raises"
