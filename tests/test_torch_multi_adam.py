"""The shared Adam's multi-tensor wrapper (``ops/multi_adam.py``) on the CPU,
where it takes its plain version, ``train/svi.py::adam_plain``:
``shared_adam_update`` through it is bit for bit the per-leaf loop it
replaced (written out below as it stood), across the dual step's masks, a
host lr and a 0-d tensor lr, ``lr_scales`` (``prior_lr_mult`` 2.0), the
``split`` optimizer and member-stacked leaves; masked-out leaves keep their
tensors. The leaf table's planner (block prefixes, a launch's capacity),
the wrapper's refusals off the CPU (the ``meta`` device) and the CUDA
source's constants are checked here too. The kernel itself runs on the card
(``tests/test_torch_gpu.py``, ``-k multi_adam``)."""

import os
import re

import pytest
import torch

from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params, param_masks
from structured_latent_odes_tpu_torch.ops import multi_adam as ma
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

LR = 1e-3


def _loop_update(grads, slots, params, mask, lr, b1=0.9, b2=0.999, eps=1e-8, lr_scales=None, corrections=None):
    """``shared_adam_update`` as it stood before the wrapper: a leaf at a
    time."""
    if corrections is None:
        corrections = torch.as_tensor(svi.bias_corrections(slots.count, mask, b1, b2))
    c1, c2 = corrections
    scales = tree_leaves(lr_scales) if lr_scales is not None else [1.0] * len(tree_leaves(params))
    new_p, new_m, new_n = [], [], []
    for i, (p, g, m, n, mk, sc) in enumerate(zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(slots.mu), tree_leaves(slots.nu),
        tree_leaves(mask), scales,
    )):
        if not mk:
            new_p.append(p), new_m.append(m), new_n.append(n)
            continue
        m2 = b1 * m + (1.0 - b1) * g
        n2 = b2 * n + (1.0 - b2) * g * g
        m_hat = m2 / c1[i]
        n_hat = n2 / c2[i]
        new_p.append(p - (lr * sc) * m_hat / (torch.sqrt(n_hat) + eps))
        new_m.append(m2), new_n.append(n2)
    return tree_unflatten(params, new_p), svi.AdamSlots(
        tree_unflatten(params, new_m), tree_unflatten(params, new_n), svi.advance_counts(slots.count, mask))


def _spec_and_params(members=None):
    spec = cvs_spec(load_cvs_config(), n_time=16)
    params = init_params(spec, 3, device="cpu")
    if members:
        params = tree_map(lambda p: torch.stack([p * (1.0 + 0.25 * s) for s in range(members)]), params)
    return spec, params


def _grads(params, seed):
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda p: torch.randn(p.shape, generator=gen) * 0.1, params)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


# (optimizer, prior_lr_mult, lr_scale of the batch: a host float or a 0-d tensor, members)
CASES = {
    "shared": ("shared", 1.0, 1.0, None),
    "shared, 0-d lr": ("shared", 1.0, torch.tensor(0.75), None),
    "prior_lr_mult 2": ("shared", 2.0, 1.0, None),
    "prior_lr_mult 2, 0-d lr": ("shared", 2.0, torch.tensor(1.5), None),
    "split": ("split", 1.0, 1.0, None),
    "members": ("shared", 1.0, 1.0, 3),
    "members, 0-d lr, prior_lr_mult 2": ("shared", 2.0, torch.tensor(0.5), 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_updates_are_the_per_leaf_loop(case):
    """Three dual steps' updates (main, then aux) of make_dual_optimizer's
    rules, each fed its bias corrections as the step is, bit for bit the
    per-leaf loop's; a leaf an update leaves keeps its tensors."""
    optimizer, mult, sc, members = CASES[case]
    spec, params = _spec_and_params(members)
    optim = svi.make_dual_optimizer(spec, params, LR, optimizer, prior_lr_mult=mult)
    main_mask, aux_mask = param_masks(spec, params)
    scales = None
    if mult != 1.0:
        scales = {g: tree_map(lambda _: mult if g == "priors" else 1.0, sub) for g, sub in params.items()}
    opt = ref_opt = optim.init(params)
    p = ref_p = params
    before = svi.shared_adam_update.leaves
    stepped = 0
    for step in range(3):
        corrections, _ = svi.step_corrections(optim, opt, 1, "cpu")
        for k, (rule, mask) in enumerate(((optim.update_main, main_mask), (optim.update_aux, aux_mask))):
            g = _grads(params, 10 * step + k)
            p, opt = rule(g, opt, p, sc, corrections[0, k])
            slot = ref_opt if optimizer == "shared" else ref_opt[k]
            new_p, new_slot = _loop_update(g, slot, ref_p, mask, LR * sc, lr_scales=scales,
                                           corrections=corrections[0, k])
            for leaf, old, stepped_leaf in zip(tree_leaves(new_p), tree_leaves(ref_p), tree_leaves(mask)):
                assert (leaf is old) == (not stepped_leaf)
            ref_p = new_p
            ref_opt = new_slot if optimizer == "shared" else tuple(
                new_slot if i == k else s for i, s in enumerate(ref_opt))
            stepped += sum(tree_leaves(mask))
            assert _same(p, ref_p), f"{case}: params after step {step} update {k}"
            for mine, ref in zip(svi._slots(opt), svi._slots(ref_opt)):
                assert _same(mine.mu, ref.mu) and _same(mine.nu, ref.nu) and mine.count == ref.count
    assert svi.shared_adam_update.leaves - before == stepped


def test_prior_refit_update_is_the_per_leaf_loop():
    """The refit's Adam (the priors alone, stacked members, no corrections
    given) through the wrapper, bit for bit the loop."""
    spec, params = _spec_and_params(2)
    mask = {g: tree_map(lambda _: g == "priors", params[g]) for g in params}
    slots = svi.shared_adam_init(params)
    g = _grads(params, 4)
    got = svi.shared_adam_update(g, slots, params, mask, LR)
    ref = _loop_update(g, slots, params, mask, LR)
    assert _same(got[0], ref[0]) and _same(got[1].mu, ref[1].mu) and _same(got[1].nu, ref[1].nu)


def test_wrapper_on_cpu_counts_no_launch():
    spec, params = _spec_and_params()
    leaves = tree_leaves(params)
    before = (ma.multi_adam.launches, ma.multi_adam.leaves)
    args = (leaves, [p * 0.5 for p in leaves], [p * 0.1 for p in leaves], [p * p for p in leaves], LR,
            torch.full((2, len(leaves)), 0.5), range(len(leaves)), [1.0] * len(leaves))
    got, ref = ma.multi_adam(*args), svi.adam_plain(*args)
    assert all(torch.equal(a, b) for x, y in zip(got, ref) for a, b in zip(x, y))
    assert ma.multi_adam([], [], [], [], LR, args[5], [], []) == ([], [], [])
    assert (ma.multi_adam.launches, ma.multi_adam.leaves) == before


def _counts(n_leaves):
    """Leaf sizes of every kind: empty, under a block, a block, just past
    one, many blocks."""
    sizes = [0, 5, ma.CHUNK, ma.CHUNK + 1, 37 * ma.CHUNK - 3, 1, 250]
    return [sizes[i % len(sizes)] * (1 + i // len(sizes)) for i in range(n_leaves)]


@pytest.mark.parametrize("n_leaves", [1, 38, 48, 300])
def test_plan_covers_the_leaves_in_launches(n_leaves):
    counts = _counts(n_leaves)
    launches = ma.plan(counts)
    assert len(launches) == -(-n_leaves // ma.MAX_LEAVES)
    at = 0
    for first, stop, starts in launches:
        assert first == at and 0 < stop - first <= ma.MAX_LEAVES and len(starts) == stop - first + 1
        assert starts[0] == 0
        for i in range(first, stop):
            assert starts[i - first + 1] - starts[i - first] == -(-counts[i] // ma.CHUNK)
        at = stop
    assert at == n_leaves


def test_plan_splits_past_a_launchs_blocks():
    half = (1 << 30) * ma.CHUNK
    launches = ma.plan([half, half, 5])
    assert [(a, b) for a, b, _ in launches] == [(0, 1), (1, 3)]
    assert launches[1][2] == [0, 1 << 30, (1 << 30) + 1]
    with pytest.raises(ValueError, match="blocks"):
        ma.plan([(1 << 31) * ma.CHUNK])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype)


# each case: (params, grads, mu, nu, lr, corrections), one leaf, and the message
REFUSED = {
    "mixed devices": (lambda: ([torch.zeros(4)], [_meta(4)], [_meta(4)], [_meta(4)], LR, _meta(2, 1)), "one device"),
    "mixed dtypes": (lambda: ([_meta(4)], [_meta(4, dtype=torch.float64)], [_meta(4)], [_meta(4)], LR, _meta(2, 1)),
                     "float32"),
    "float64": (lambda: tuple([_meta(4, dtype=torch.float64)] for _ in range(4))
                + (LR, _meta(2, 1, dtype=torch.float64)), "float32"),
    "non-contiguous": (lambda: ([_meta(3, 4).t()], [_meta(4, 3)], [_meta(4, 3)], [_meta(4, 3)], LR, _meta(2, 1)),
                       "contiguous"),
    "lr on another device": (lambda: ([_meta(4)], [_meta(4)], [_meta(4)], [_meta(4)], torch.tensor(1e-3),
                                      _meta(2, 1)), "one device"),
    "lr not 0-d": (lambda: ([_meta(4)], [_meta(4)], [_meta(4)], [_meta(4)], _meta(1), _meta(2, 1)), "0-d"),
    "shapes differ": (lambda: ([_meta(4)], [_meta(5)], [_meta(4)], [_meta(4)], LR, _meta(2, 1)), "shape"),
    "meta device": (lambda: ([_meta(4)], [_meta(4)], [_meta(4)], [_meta(4)], LR, _meta(2, 1)), "cuda or cpu"),
    "column past the corrections": (lambda: ([_meta(4)], [_meta(4)], [_meta(4)], [_meta(4)], LR, _meta(2, 0)),
                                    "columns"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_off_the_cpu(case):
    """Off the CPU only the kernel runs: what it does not take raises
    before any launch, and no plain version runs in its place."""
    make, match = REFUSED[case]
    params, grads, mu, nu, lr, corr = make()
    before = ma.multi_adam.launches
    with pytest.raises(ValueError, match=match):
        ma.multi_adam(params, grads, mu, nu, lr, corr, [0], [1.0])
    assert ma.multi_adam.launches == before


def test_kernel_source_holds_the_wrappers_constants():
    src = open(os.path.join(ma._build.CSRC_DIR, "multi_adam.cu")).read()
    assert re.search(r"kMaxLeaves = (\d+);", src).group(1) == str(ma.MAX_LEAVES)
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    per = int(re.search(r"kPerThread = (\d+);", src).group(1))
    assert threads * per == ma.CHUNK
    for op in ("__fmul_rn", "__fadd_rn", "__fdiv_rn", "__fsqrt_rn", "__fsub_rn"):
        assert op in src
