"""The PyTorch port's ensemble trainer (train/ensemble.py), its stacked dual
step (train/svi.py), the member-batched kernel entries and K1's split (C1),
on the CPU.

Held against the JAX package, numbers equal: ``build_epoch_perms``,
``aux_mult_schedule`` and ``lr_scale_schedule`` (with anneal, warm-up and lr
decay); one prior-refit update at equal draws (JAX's draws handed to the port
through ``noise=``, as tests/test_torch_svi.py does) against JAX's
``elbo_main`` gradient restricted to the priors group and its shared Adam,
params within 3e-7 abs (tests/test_torch_svi.py's bound after a step).

Held against the port itself:
- a stacked dual step of S = 3 members equals three single dual steps on
  ``semilinear``, ``semilinear_fused``, ``semilinear_seq``, ``adjoint`` and
  with ``split``, and two members one on ``adaptive``, params within 1e-6
  relative to their leaf (batched and single products round differently);
- a two-member run equals the port's sequential driver at each seed for the
  four policies: params and best params within rtol 2e-4, atol 1e-6, best
  epoch equal and criterion within rtol 2e-4 (tests/test_ensemble.py's
  ``_assert_member_matches`` bounds);
- chunked equals one dispatch, and the shared-data layout the stacked one,
  bit for bit; the tail EMA is the decayed mean of the epochs' params; the
  refit moves only the priors and a member's refit equals the sequential
  driver's;
- the stacked step's operation count does not depend on S (every kernel
  launches once for all members), but for layout copies that a single member
  makes views;
- the member-batched plain K2/K3 equal the per-member plain calls, and
  ``torch.func.vmap`` of ``fused_semilinear_solve`` and ``affine_scan`` equals
  the loop (forward and gradients), the ensemble's draws those of
  ``fold_seed`` at each member's seed;
- C1: K1's and K1-bwd's split into runs (``scan_in_runs``,
  ``scan_bwd_in_runs``), with the plain versions as the launch and a forced
  cap of 7 steps at T = 50, is ``torch.equal`` to one unsplit plain call.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import elbo_main as jax_elbo_main
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.prob import sample_normal_ps as jax_sample
from structured_latent_odes_tpu.train import ensemble as jens
from structured_latent_odes_tpu.train import svi as jsvi
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.nn.ode_model import OdeModelSpec, ode_model_init, solve_ode
from structured_latent_odes_tpu_torch.ops import fused_step, recurrence
from structured_latent_odes_tpu_torch.prob import fold_seed, seed_tensor, standard_normal_ps
from structured_latent_odes_tpu_torch.train import ensemble as ens
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.train.backend import make_training_backend
from structured_latent_odes_tpu_torch.train.driver import device_batch, run_training_epochs
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_map
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

T = 16
N_TRAIN, N_VAL, BS = 10, 6, 4
LR = 1e-3


def _config(num_epochs, backend="semilinear", anneal=False, warmup=False, lrdecay=False, jax_side=False):
    c = (jax_cvs_config if jax_side else load_cvs_config)()
    c.seq_len, c.mini_batch_size, c.num_epochs, c.ode_backend = T, BS, num_epochs, backend
    c.aux_mult_final = c.aux_anneal_epochs = c.aux_mult_start = c.aux_warmup_epochs = None
    if anneal:
        c.aux_mult_final, c.aux_anneal_epochs = 4.6, max(1, num_epochs - 1)
    if warmup:
        c.aux_mult_start, c.aux_warmup_epochs = 4.6, 2
    if lrdecay:
        c.lr_final, c.lr_decay_start = c.learning_rate * 0.1, 1
    return c


def _splits():
    r = np.random.RandomState(99)

    def split(n):
        return {
            "observations": r.rand(n, 3, T).astype(np.float32),
            "iext": (r.rand(n, 1) > 0.5).astype(np.float32),
            "rtpr": (r.rand(n, 1) > 0.5).astype(np.float32),
        }

    return {"train": split(N_TRAIN), "val": split(N_VAL)}


# the sequential drivers' selection rules (training_{cvs,proc,challenge}.py)
def _select(policy):
    def select(epoch, val, train_s, best, params, epoch_losses):
        if policy == "cvs":
            crit = sum(val["post"].elbo) * len(val["post"].elbo)
            return {"params": params, "epoch": epoch, "criterion": crit} if best["criterion"] >= crit else best
        if policy in ("proc", "proc_heldout"):
            crit = float(np.sum(val["post"].elbo))
            if policy == "proc_heldout" or crit < best["criterion"]:
                return {"params": params, "epoch": epoch + 1, "criterion": crit}
            return best
        crit = float(np.mean(epoch_losses)) if epoch_losses else np.inf
        return {"params": params, "epoch": epoch, "criterion": crit} if crit < best["criterion"] else best
    return select


def _sequential(config, splits, seed, policy):
    """The port's sequential driver loop at this seed (its seed chain)."""
    spec = cvs_spec(config, n_time=T)
    ts = torch.arange(float(T))
    params = init_params(spec, fold_seed(seed, "init"), device="cpu")
    init_state, train_epoch, put, _ = make_training_backend(spec, ts, config, params)
    return run_training_epochs(
        spec=spec, state=init_state(params, fold_seed(seed, "train")), train_epoch=train_epoch,
        eval_epoch=svi.make_eval_epoch(spec, ts), splits=splits, config=config, rng=np.random.RandomState(seed),
        eval_seed=fold_seed(seed, "eval"), select_best=_select(policy), eval_train_stats=False, put_batch=put)


def _ensemble(config, splits, seeds, policy, shared_data=True, chunk=0, **kw):
    spec = cvs_spec(config, n_time=T)
    ts = torch.arange(float(T))
    params = [init_params(spec, fold_seed(s, "init"), device="cpu") for s in seeds]
    lr_sched = ens.lr_scale_schedule(config, config.num_epochs)
    runner = ens.make_ensemble_runner(spec, ts, config.learning_rate, params[0], policy=policy,
                                      use_lr_sched=lr_sched is not None, shared_data=shared_data,
                                      optimizer=config.get("optimizer", "shared"), **kw)
    states = ens.stack_states([runner.init_state(p, fold_seed(s, "train")) for p, s in zip(params, seeds)])
    rngs = [np.random.RandomState(s) for s in seeds]
    built = [ens.build_epoch_perms(N_TRAIN, BS, config.num_epochs, r) for r in rngs]
    perms, mask = np.stack([b[0] for b in built]), built[0][1]
    refit = kw.get("refit_epochs", 0)
    refit_perms = np.stack([ens.build_epoch_perms(N_TRAIN, BS, refit - 1, r)[0] for r in rngs]) if refit else None
    val = stacked_minibatches(splits["val"], BS, shuffle=False) if policy in ("cvs", "proc") else None
    train = splits["train"]
    if not shared_data:
        train = {k: np.stack([v] * len(seeds)) for k, v in train.items()}
        val = None if val is None else {k: np.stack([v] * len(seeds)) for k, v in val.items()}
    args = (states, [fold_seed(s, "eval") for s in seeds], train, val, perms, mask,
            np.stack([ens.aux_mult_schedule(config, config.num_epochs)] * len(seeds)))
    lrs = None if lr_sched is None else np.stack([lr_sched] * len(seeds))
    if chunk:
        return ens.run_chunked(runner, *args, chunk_epochs=chunk, lr_sched=lrs, refit_perms=refit_perms)
    return runner.run(*args, refit_perms=refit_perms, lr_sched=lrs)


def _assert_close(stacked, i, ref, rtol=2e-4, atol=1e-6):
    for a, b in zip(tree_leaves(stacked), tree_leaves(ref)):
        np.testing.assert_allclose(a[i].numpy(), b.numpy(), rtol=rtol, atol=atol)


def _assert_equal(x, y):
    for a, b in zip(tree_leaves(x), tree_leaves(y)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- vs JAX


def test_build_epoch_perms_matches_jax():
    for n, bs, epochs in ((10, 4, 3), (28, 32, 2), (7, 7, 0)):
        ours = ens.build_epoch_perms(n, bs, epochs, np.random.RandomState(5))
        ref = jens.build_epoch_perms(n, bs, epochs, np.random.RandomState(5))
        assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(ours, ref))


@pytest.mark.parametrize("sched", ["none", "anneal", "warmup", "warmup+anneal", "lrdecay"])
def test_schedules_match_jax(sched):
    kw = {"anneal": "anneal" in sched, "warmup": "warmup" in sched, "lrdecay": sched == "lrdecay"}
    ours, ref = _config(6, **kw), _config(6, jax_side=True, **kw)
    np.testing.assert_array_equal(ens.aux_mult_schedule(ours, 6), jens.aux_mult_schedule(ref, 6))
    lr_ours, lr_ref = ens.lr_scale_schedule(ours, 6), jens.lr_scale_schedule(ref, 6)
    assert (lr_ours is None) == (lr_ref is None) == (sched != "lrdecay")
    if lr_ref is not None:
        np.testing.assert_array_equal(lr_ours, lr_ref)


def _eps(key, sids, dim):
    zeros = jnp.zeros((sids.shape[0], dim))
    return torch.tensor(np.asarray(jax_sample(key, sids, zeros, jnp.ones_like(zeros))))


def test_prior_refit_step_matches_jax():
    """One refit update: JAX's main-ELBO gradient at key k, Adam on the
    priors group alone from fresh slots; the port's ``refit.update`` on a
    stacked member of one, with JAX's draws as ``noise=``, its Adam bias
    corrections made from the slots' counts and fed as a tensor row (as the
    refit's steps, eager and replayed, take them): each within 3e-7 of JAX,
    and the two bit for bit equal."""
    jspec, pspec = jax_cvs_spec(_config(1, jax_side=True), n_time=T), cvs_spec(_config(1), n_time=T)
    params = jax_init(jax.random.key(0), jspec)
    batch = {k: v[0] for k, v in stacked_minibatches(_splits()["train"], BS, shuffle=True,
                                                     rng=np.random.RandomState(1)).items()}
    batch["aux_mult"] = np.float32(jspec.aux_loss_multiplier)
    ts = np.arange(float(T), dtype=np.float32)
    key = jax.random.key(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.jit(jax.grad(lambda p: jax_elbo_main(jspec, p, key, jb, jnp.asarray(ts))[0]))(params)
    prior_only = {g: jax.tree.map(lambda _: g == "priors", params[g]) for g in params}
    ref, _ = jsvi.shared_adam_update(grads, jsvi.shared_adam_init(params), params, prior_only, LR)

    sids = jnp.asarray(batch["sample_id"])
    noise, k = {}, key
    for block in jspec.blocks:
        k, sub = jax.random.split(k)
        noise[block.name] = _eps(sub, sids, block.dim)[None]
    port = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    stacked = ens.stack_members([port])
    pb = {k: v[None] for k, v in device_batch(batch, "cpu").items() if k not in ("mask", "aux_mult")}
    pb.update(mask=torch.from_numpy(batch["mask"]), aux_mult=torch.tensor(batch["aux_mult"]))
    dims = {k: 0 for k in pb}
    dims.update(mask=None, aux_mult=None)
    refit = ens.make_prior_refit_fn(pspec, torch.from_numpy(ts), LR)
    slots = svi.shared_adam_init(stacked)
    out, _ = refit.update(stacked, slots, seed_tensor([0]), pb, dims, noise)
    row = torch.as_tensor(svi.bias_corrections(slots.count, {g: tree_map(lambda _: g == "priors", stacked[g])
                                                             for g in stacked}))
    fed, _ = refit.update(stacked, slots, seed_tensor([0]), pb, dims, noise, corrections=row)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out), tree_leaves(fed)))
    for group in port:
        for a, b, p0 in zip(tree_leaves(fed[group]), tree_leaves(params_from_jax(
                jax.tree.map(np.asarray, ref), device="cpu")[group]), tree_leaves(port[group])):
            np.testing.assert_allclose(a[0].numpy(), b.numpy(), rtol=0, atol=3e-7)
            if group != "priors":
                assert torch.equal(a[0], p0)


# ---------------------------------------------------------------- the port


def _members(spec, S):
    return [init_params(spec, fold_seed(s, "init"), device="cpu") for s in range(S)]


# The adaptive backend's stacked step takes its members one at a time
# (train/svi.py::over_members): two members and one step (each
# member's adjoint solves take seconds on the CPU), held as the others.
@pytest.mark.parametrize("case", ["semilinear", "semilinear_fused", "semilinear_seq", "split", "adjoint", "adaptive"])
def test_stacked_step_matches_single_steps(case):
    backend = "semilinear" if case == "split" else case
    config = _config(1, backend=backend)
    spec = cvs_spec(config, n_time=T)
    ts = torch.arange(float(T))
    S, n_steps = (2, 1) if case == "adaptive" else (3, 2)
    params = _members(spec, S)
    optimizer = "split" if case == "split" else "shared"
    init_state, step, _ = svi.make_train_step(spec, ts, LR, params[0], optimizer=optimizer)
    singles = [init_state(p, 10 + s) for s, p in enumerate(params)]
    stacked = ens.stack_states(singles)
    optim = svi.make_dual_optimizer(spec, params[0], LR, optimizer)
    sstep = svi.make_stacked_dual_step(spec, ts, optim)
    splits = _splits()
    perms = np.stack([ens.build_epoch_perms(N_TRAIN, BS, 0, np.random.RandomState(s))[0][0] for s in range(S)])
    mask = torch.from_numpy(ens.build_epoch_perms(N_TRAIN, BS, 0, np.random.RandomState(0))[1])
    seeds = svi.stacked_step_seeds(stacked.seed, range(n_steps))
    dims = {"observations": 0, "iext": 0, "rtpr": 0, "sample_id": 0, "mask": None}
    for i in range(n_steps):
        batch = {k: torch.from_numpy(v[perms[:, i]]) for k, v in splits["train"].items()}
        batch.update(sample_id=torch.from_numpy(perms[:, i]), mask=mask[i])
        stacked, mets = sstep(stacked, batch, dims, seeds[i])
        for s in range(S):
            singles[s], m = step(singles[s], {**{k: v[s] for k, v in batch.items() if dims[k] == 0}, "mask": mask[i]})
            np.testing.assert_allclose(float(mets["loss_main"][s]), float(m["loss_main"]), rtol=1e-6)
    for s in range(S):
        for a, b in zip(tree_leaves(stacked.params), tree_leaves(singles[s].params)):
            assert float((a[s] - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1.0)
    assert stacked.step == n_steps and stacked.seed == [10 + s for s in range(S)]


@pytest.mark.parametrize("policy", ["cvs", "cvs-schedules", "proc", "proc_heldout", "challenge"])
def test_members_match_sequential(policy):
    sched = policy == "cvs-schedules"
    policy = policy.split("-")[0]
    config = _config(1, anneal=sched, lrdecay=sched)
    splits = _splits()
    result = _ensemble(config, splits, [3, 4], policy)
    for i, seed in enumerate((3, 4)):
        state, best = _sequential(config, splits, seed, policy)
        _assert_close(result.state.params, i, state.params)
        _assert_close(result.best_params, i, best["params"])
        assert int(result.best_epoch[i]) == int(best["epoch"])
        if policy != "proc_heldout":  # there the ensemble records the mean train loss (train/ensemble.py)
            np.testing.assert_allclose(result.best_crit[i], best["criterion"], rtol=2e-4)
    if policy == "proc_heldout":
        assert list(result.best_epoch) == [2, 2]
        _assert_equal(result.best_params, result.state.params)
    assert result.history["loss_main"].shape == (2, 2, 3)


def test_chunked_matches_single_dispatch():
    config, splits = _config(2), _splits()
    single = _ensemble(config, splits, [3, 4], "cvs")
    chunked = _ensemble(config, splits, [3, 4], "cvs", chunk=2)
    _assert_equal(single.state.params, chunked.state.params)
    _assert_equal(single.best_params, chunked.best_params)
    assert np.array_equal(single.best_crit, chunked.best_crit)
    assert np.array_equal(single.best_epoch, chunked.best_epoch)
    assert all(np.array_equal(single.history[k], chunked.history[k]) for k in single.history)


def test_shared_data_matches_stacked():
    config, splits = _config(1), _splits()
    shared = _ensemble(config, splits, [3, 4], "cvs", shared_data=True)
    stacked = _ensemble(config, splits, [3, 4], "cvs", shared_data=False)
    _assert_equal(shared.state.params, stacked.state.params)
    _assert_equal(shared.best_params, stacked.best_params)
    assert np.array_equal(shared.best_crit, stacked.best_crit)


def test_tail_ema_tracking():
    """From tail_ema_start the EMA is decay*ema + (1-decay)*params after each
    epoch; before it, the params. Selection is unchanged."""
    config, splits = _config(1), _splits()
    base = _ensemble(config, splits, [3, 4], "challenge")
    ema = _ensemble(config, splits, [3, 4], "challenge", tail_ema_decay=0.75, tail_ema_start=1)
    assert base.ema_params is None
    _assert_equal(base.best_params, ema.best_params)
    # params after epoch 0: the same run one epoch long
    at0 = _ensemble(_config(0), splits, [3, 4], "challenge").state.params
    d, keep = float(np.float32(0.75)), float(np.float32(1) - np.float32(0.75))
    _assert_equal(ema.ema_params, tree_map(lambda e, p: d * e + keep * p, at0, ema.state.params))


def test_prior_refit_changes_only_priors_and_matches_the_driver():
    config, splits = _config(1), _splits()
    plain = _ensemble(config, splits, [3, 4], "challenge")
    refit = _ensemble(config, splits, [3, 4], "challenge", refit_epochs=2)
    assert np.array_equal(plain.best_epoch, refit.best_epoch)
    moved = []
    for group in plain.best_params:
        for a, b in zip(tree_leaves(plain.best_params[group]), tree_leaves(refit.best_params[group])):
            if group == "priors":
                moved.append(float((a - b).abs().max()))
            else:
                assert torch.equal(a, b)
    assert max(moved) > 0
    # the sequential driver's refit of member 0: its best params, the rest of
    # its shuffle stream and the refit seed fold_seed(eval seed, 'refit')
    state, best = _sequential(config, splits, 3, "challenge")
    rng = np.random.RandomState(3)
    ens.build_epoch_perms(N_TRAIN, BS, config.num_epochs, rng)
    spec = cvs_spec(config, n_time=T)
    seq = ens.prior_refit(spec, torch.arange(float(T)), LR, best["params"], fold_seed(fold_seed(3, "eval"), "refit"),
                          splits["train"], rng, 2, BS)
    _assert_close(refit.best_params, 0, seq)


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


# layout operations: vmap's batching rules of the encoder's conv and pool and
# of the heads' transpose copy a batched tensor into the layout they need
# where more than one member makes a view impossible
_LAYOUT = {"aten.clone.default", "aten.view.default", "aten._unsafe_view.default"}


@pytest.mark.parametrize("backend", ["semilinear", "semilinear_seq"])
def test_stacked_step_operation_count_does_not_grow_with_members(backend):
    """One stacked dual step runs the same operations at S = 2 and S = 3: one
    of each for all members (on the card, one launch of each kernel). At S =
    1 it runs the same operations but for layout copies that a single member
    makes views. semilinear_fused's plain member-batched versions loop over
    members on the CPU, so that backend is checked on the card by
    chip_smoke.py."""
    config = _config(1, backend=backend)
    spec = cvs_spec(config, n_time=T)
    ts = torch.arange(float(T))
    optim = svi.make_dual_optimizer(spec, _members(spec, 1)[0], LR)
    step = svi.make_stacked_dual_step(spec, ts, optim)
    splits = _splits()
    counts = {}
    for S in (1, 2, 3):
        params = _members(spec, S)
        state = ens.stack_states([svi.SVIState(p, optim.init(p), s, 0) for s, p in enumerate(params)])
        batch = {k: torch.from_numpy(np.stack([v[:BS]] * S)) for k, v in splits["train"].items()}
        batch.update(sample_id=torch.arange(BS).expand(S, BS), mask=torch.ones(BS))
        dims = {"observations": 0, "iext": 0, "rtpr": 0, "sample_id": 0, "mask": None}
        seeds = svi.stacked_step_seeds(state.seed, range(1))
        step(state, batch, dims, seeds[0])  # warm
        with _OpCount() as count:
            step(state, batch, dims, seeds[0])
        counts[S] = count.ops
    assert counts[2] == counts[3]
    assert {k: v for k, v in counts[1].items() if k not in _LAYOUT} == {
        k: v for k, v in counts[2].items() if k not in _LAYOUT}
    assert counts[1]["aten.clone.default"] <= counts[2]["aten.clone.default"]


def test_members_plain_fused_match_per_member_calls():
    r = np.random.RandomState(2)
    S, B, H, D, Tn = 3, 5, 7, 4, 9
    f = lambda *shape: torch.from_numpy(r.randn(*shape).astype(np.float32))  # noqa: E731
    u, wt, wa, ba, wd, bd, x0 = f(S, B, H), f(S, H), f(S, D, H), f(S, D), f(S, D, H), f(S, D), f(S, B, D)
    ts = torch.arange(float(Tn))
    xs = fused_step.fused_semilinear_fwd_members(u, wt, wa, ba, wd, bd, x0, ts, "midpoint")
    g = f(S, B, Tn, D)
    grads = fused_step.fused_semilinear_bwd_members(u, wt, wa, ba, wd, bd, xs, g, ts, "midpoint")
    for s in range(S):
        args = (u[s], wt[s], wa[s], ba[s], wd[s], bd[s])
        assert torch.equal(xs[s], fused_step.fused_semilinear_fwd_plain(*args, x0[s], ts, "midpoint"))
        for a, b in zip(grads, fused_step.fused_semilinear_bwd_plain(*args, xs[s], g[s], ts, "midpoint")):
            assert torch.equal(a[s], b)


@pytest.mark.parametrize("backend", ["semilinear_fused", "semilinear"])
def test_vmap_of_the_kernel_entries_matches_the_loop(backend):
    """torch.func.vmap over members of the ODE solve (fused_semilinear_solve
    or affine_scan) and of its gradient equals the loop over members, to the
    roundoff of batched against single products (the projections around the
    kernels; affine_scan itself bit for bit)."""
    spec = OdeModelSpec(latent_dim=4, ode_state_dim=3, ode_hidden_dim=6, backend=backend)
    S = 3
    ps = [ode_model_init(torch.Generator().manual_seed(i), spec) for i in range(S)]
    stacked = ens.stack_members(ps)
    z = torch.from_numpy(np.random.RandomState(4).randn(S, 5, 4).astype(np.float32))
    ts = torch.arange(0.0, 7.0)
    out = torch.func.vmap(lambda p, z: solve_ode(spec, p, z, ts))(stacked, z)
    loss = lambda p, z: (solve_ode(spec, p, z, ts) ** 2).sum()  # noqa: E731
    grads = torch.func.vmap(torch.func.grad(loss))(stacked, z)
    for i in range(S):
        np.testing.assert_allclose(out[i].numpy(), solve_ode(spec, ps[i], z[i], ts).numpy(), rtol=1e-6, atol=1e-6)
        for a, b in zip(tree_leaves(grads), tree_leaves(torch.func.grad(loss)(ps[i], z[i]))):
            assert float((a[i] - b).abs().max()) <= 1e-5 * max(float(b.abs().max()), 1.0)
    A, Bc = torch.rand(S, 4, 20, 5), torch.randn(S, 4, 20, 5)
    x0 = torch.randn(S, 4, 5)
    xs = torch.func.vmap(recurrence.affine_scan)(A, Bc, x0)
    assert all(torch.equal(xs[i], recurrence.affine_scan(A[i], Bc[i], x0[i])) for i in range(S))


def test_stacked_draws_match_fold_seed():
    seeds = [fold_seed(s, "train", 3, "main") for s in (1, 2, 3)]
    sids = torch.tensor([4, 0, 9, 2])
    stacked = standard_normal_ps(seed_tensor(seeds), "main/iext", sids, (5,))
    vmapped = torch.func.vmap(lambda s: standard_normal_ps(s, "main/iext", sids, (5,)))(seed_tensor(seeds))
    for i, s in enumerate(seeds):
        ref = standard_normal_ps(s, "main/iext", sids, (5,))
        assert torch.equal(stacked[i], ref) and torch.equal(vmapped[i], ref)
    rows = svi.stacked_step_seeds(seeds, range(3, 5), num_particles=2)
    for k, step in enumerate(range(3, 5)):
        for i, s in enumerate(seeds):
            for j, loss in enumerate(("main", "aux")):
                for p in range(2):
                    assert int(rows[k, i, j, p]) & (2 ** 64 - 1) == fold_seed(s, step, loss, p)


@pytest.mark.parametrize("D", [1, 5, 8])
@pytest.mark.parametrize("width", ["whole", "3"])
@pytest.mark.parametrize("Bt", [3, 1])
def test_scan_split_into_runs_is_bit_equal(D, width, Bt):
    r = np.random.RandomState(D)
    A = torch.from_numpy((r.rand(Bt, 50, D) * 1.2).astype(np.float32))
    B = torch.from_numpy(r.randn(Bt, 50, D).astype(np.float32))
    x0 = torch.from_numpy(r.randn(Bt, D).astype(np.float32))
    g = torch.from_numpy(r.randn(Bt, 51, D).astype(np.float32))
    g_before = g.clone()
    w = D if width == "whole" else 3
    xs = recurrence.affine_scan_batched_plain(A, B, x0)
    assert torch.equal(recurrence.scan_in_runs(recurrence.affine_scan_batched_plain, A, B, x0, 7, w), xs)
    split = recurrence.scan_bwd_in_runs(recurrence.affine_scan_bwd_batched_plain, A, xs, g, 7, w)
    for a, b in zip(split, recurrence.affine_scan_bwd_batched_plain(A, xs, g)):
        assert torch.equal(a, b)
    # the seams' rows are written into copies, never into the caller's g
    # (at Bt = 1 a run's slice of g is contiguous already)
    assert torch.equal(g, g_before)
