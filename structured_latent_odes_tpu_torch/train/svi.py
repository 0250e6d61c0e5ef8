"""SVI engine: the dual-loss training step with a shared per-parameter Adam
(the JAX package's ``train/svi.py``).

The reference steps two SVI losses per minibatch against one
``pyro.optim.Adam``, which keeps one ``torch.optim.Adam`` per parameter and
advances only the parameters that received gradients from that loss. A
parameter touched by both losses (the encoder) accumulates moments from both
gradient streams in the same slots, and its step count advances on every
touch. ``optimizer='shared'`` (the default) reproduces that with one
(mu, nu, count) set per parameter and the masks of
``models.slode.param_masks``; ``optimizer='split'`` keeps two independent
Adams, one per loss.

PyTorch runs eagerly: the step is a Python function and an epoch a Python
loop over the stacked minibatches on the device. Parameters are nested dicts
of tensors, replaced (not updated in place) by each step, so a stored
reference to them, such as the best model's, stays valid. The JAX package's
``BoundedMemo`` exists only to avoid re-tracing under ``jit`` and has no
counterpart here.

Randomness: the state carries an integer seed and a step counter. Each step's
main and aux draws are keyed by ``fold_seed(seed, step, 'main' | 'aux')``
(``prob/distributions.py``), and each particle's by its index, so a draw
depends only on (seed, step, site, sample_id).

``make_stacked_dual_step`` is the dual step of an ensemble's S members
(``train/ensemble.py``): stacked parameters, one ``torch.func.vmap`` over the
members for each loss's gradient, and the members' seeds as one tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from structured_latent_odes_tpu_torch.interop import params_from_jax, params_to_jax
from structured_latent_odes_tpu_torch.models import classifier, elbo_aux, elbo_main, param_masks, recon
from structured_latent_odes_tpu_torch.models.slode import masked_abs_parts
from structured_latent_odes_tpu_torch.models.spec import ModelSpec
from structured_latent_odes_tpu_torch.nn.ode_model import solve_is_per_member
from structured_latent_odes_tpu_torch.prob import fold_seed, l1_of_parts, seed_tensor
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass
class AdamSlots:
    """Per-parameter Adam moments and step counts (trees congruent with the
    params; counts are Python ints). One set serves both losses, as Pyro's
    per-parameter ``torch.optim.Adam`` instances do."""

    mu: Any
    nu: Any
    count: Any


_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class SVIState:
    params: Any
    opt: Any  # AdamSlots (shared) | (AdamSlots, AdamSlots) (split: main, aux)
    seed: int
    step: int

    def to_tree(self) -> Dict[str, Any]:
        """The state as a checkpoint tree (``train/checkpoint.py``) on the
        host: the params and the Adam moments in the JAX layout
        (``interop.params_to_jax``), so the params part reads like a
        ``best_model.npz``; the step counts, the seed (its 64 bits as a
        signed int) and the step as ints. A split optimizer's slots are the
        list [main, aux]."""

        def slots(s: AdamSlots):
            return {"mu": params_to_jax(s.mu), "nu": params_to_jax(s.nu), "count": s.count}

        opt = slots(self.opt) if isinstance(self.opt, AdamSlots) else [slots(s) for s in self.opt]
        seed = self.seed - (1 << 64) if self.seed >= 1 << 63 else self.seed
        return {"params": params_to_jax(self.params), "opt": opt, "seed": seed, "step": self.step}

    @classmethod
    def from_tree(cls, tree: Dict[str, Any], device) -> "SVIState":
        """The inverse of :meth:`to_tree`: every tensor float32 on ``device``."""

        def slots(t):
            return AdamSlots(params_from_jax(t["mu"], device), params_from_jax(t["nu"], device), t["count"])

        opt = slots(tree["opt"]) if isinstance(tree["opt"], dict) else tuple(slots(t) for t in tree["opt"])
        return cls(params_from_jax(tree["params"], device), opt, int(tree["seed"]) & _MASK64, int(tree["step"]))


class DualOptimizer(NamedTuple):
    """State init and the two per-loss update rules."""

    init: Callable[[Any], Any]
    update_main: Callable[..., Tuple[Any, Any]]  # (grads, opt, params, lr_scale)
    update_aux: Callable[..., Tuple[Any, Any]]


def shared_adam_init(params) -> AdamSlots:
    return AdamSlots(
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
        count=tree_map(lambda _: 0, params),
    )


def _bias_correction(b: float, count: int) -> float:
    """``1 - b**count`` in float32, as the JAX package computes it."""
    return float(np.float32(1.0) - np.power(np.float32(b), np.float32(count)))


def shared_adam_update(grads, slots: AdamSlots, params, mask, lr, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-8, lr_scales=None):
    """One ``torch.optim.Adam`` step on the parameters whose ``mask`` leaf is
    True. Masked-out leaves keep their params, moments and step count, as
    torch does for a parameter whose grad is None. ``lr`` may be a 0-d tensor
    (a per-batch scale); ``lr_scales`` is an optional congruent tree of
    per-leaf multipliers (the prior-lr knob)."""
    scales = tree_leaves(lr_scales) if lr_scales is not None else [1.0] * len(tree_leaves(params))
    new_p, new_m, new_n, new_c = [], [], [], []
    for p, g, m, n, c, mk, sc in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(slots.mu), tree_leaves(slots.nu),
        tree_leaves(slots.count), tree_leaves(mask), scales,
    ):
        if not mk:
            new_p.append(p), new_m.append(m), new_n.append(n), new_c.append(c)
            continue
        c2 = c + 1
        m2 = b1 * m + (1.0 - b1) * g
        n2 = b2 * n + (1.0 - b2) * g * g
        m_hat = m2 / _bias_correction(b1, c2)
        n_hat = n2 / _bias_correction(b2, c2)
        new_p.append(p - (lr * sc) * m_hat / (torch.sqrt(n_hat) + eps))
        new_m.append(m2), new_n.append(n2), new_c.append(c2)
    return tree_unflatten(params, new_p), AdamSlots(
        tree_unflatten(params, new_m), tree_unflatten(params, new_n), tree_unflatten(params, new_c)
    )


def make_dual_optimizer(spec: ModelSpec, params_example, lr: float, mode: str = "shared",
                        prior_lr_mult: float = 1.0) -> DualOptimizer:
    """``prior_lr_mult`` scales the conditional-prior nets' learning rate in
    the main update (the only loss that touches them); 1.0 is Pyro parity."""
    main_mask, aux_mask = param_masks(spec, params_example)
    if mode == "shared":
        lr_scales = None
        if prior_lr_mult != 1.0:
            lr_scales = {
                group: tree_map(lambda _: prior_lr_mult if group == "priors" else 1.0, sub)
                for group, sub in params_example.items()
            }

        def update(mask):
            def fn(grads, slots, params, sc=1.0):
                return shared_adam_update(grads, slots, params, mask, lr * sc, lr_scales=lr_scales)
            return fn

        return DualOptimizer(init=shared_adam_init, update_main=update(main_mask), update_aux=update(aux_mask))
    if mode == "split":
        if prior_lr_mult != 1.0:
            raise ValueError("prior_lr_mult requires optimizer='shared'")

        def update(mask, which: int):
            def fn(grads, opt, params, sc=1.0):
                if not isinstance(sc, float):
                    raise ValueError("lr schedules require optimizer='shared'")
                params, slots = shared_adam_update(grads, opt[which], params, mask, lr)
                return params, tuple(slots if i == which else s for i, s in enumerate(opt))
            return fn

        return DualOptimizer(
            init=lambda p: (shared_adam_init(p), shared_adam_init(p)),
            update_main=update(main_mask, 0),
            update_aux=update(aux_mask, 1),
        )
    raise ValueError(f"unknown optimizer mode: {mode!r}")


def value_and_grad(loss_fn, params, *args):
    """(loss, aux, grads) of ``loss_fn(params, *args)``, which returns a loss
    or (loss, aux). A leaf the loss does not reach gets a zero gradient, as
    under jax.grad."""
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    out = loss_fn(tree_unflatten(params, live), *args)
    loss, aux = out if isinstance(out, tuple) else (out, None)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(live, grads)]
    return loss.detach(), aux, tree_unflatten(params, grads)


def particle_seeds(seed, num_particles: int):
    """Each particle's seed, ``fold_seed(seed, p)``; a tensor of seeds is
    taken to hold them already (the stacked step derives them on the host)."""
    if isinstance(seed, Tensor):
        return [seed[p] for p in range(num_particles)]
    return [fold_seed(seed, p) for p in range(num_particles)]


def make_losses(spec: ModelSpec, ts: Tensor, num_particles: int = 1):
    """(main_loss, aux_loss) of (params, seed, batch, noise): the mean over
    ``num_particles`` reparameterized particles (Trace_ELBO(num_particles)).
    ``seed`` is an int, or a tensor of the particles' seeds
    (:func:`particle_seeds`); ``noise`` is None or one ``noise=`` dict per
    particle. The main loss's aux holds the L1 metric's parts per particle
    (``l1_parts``: numerators and denominators ``(P, K)``), sums over the
    batch (:func:`particle_l1` makes the metric of them)."""

    def main_loss(params, seed, batch, noise=None):
        losses, nums, dens = [], [], []
        for p, sp in enumerate(particle_seeds(seed, num_particles)):
            loss, mets = elbo_main(spec, params, sp, batch, ts, noise=None if noise is None else noise[p])
            losses.append(loss)
            nums.append(mets["l1_parts"][0])
            dens.append(mets["l1_parts"][1])
        return torch.stack(losses).mean(), {"l1_parts": [torch.stack(nums), torch.stack(dens)]}

    def aux_loss(params, seed, batch, noise=None):
        return torch.stack([
            elbo_aux(spec, params, sp, batch, noise=None if noise is None else noise[p])
            for p, sp in enumerate(particle_seeds(seed, num_particles))
        ]).mean()

    return main_loss, aux_loss


def particle_l1(parts) -> Tensor:
    """The L1 metric from the ``l1_parts`` of :func:`make_losses`: per
    particle the metric of its parts, then the mean over particles."""
    return torch.mean(l1_of_parts(*parts), dim=-1).detach()


def _same(tree):
    return tree


def make_dual_step(spec: ModelSpec, ts: Tensor, optim: DualOptimizer, num_particles: int = 1,
                   reduce: Optional[Callable] = None):
    """The sequential dual-loss SVI update: ``step(state, batch, noise=None)
    -> (state, metrics)``. ``noise`` is None or ``{"main": [...], "aux":
    [...]}`` with one ``noise=`` dict per particle (tests feed JAX's draws).
    The batch may override ``aux_mult`` and ``lr_scale``.

    ``reduce`` (data parallelism, ``parallel/train.py``; None on one device)
    sums a tree of tensors over the ranks that hold slices of one batch.
    Both losses are sums over the batch, so each loss's gradients are summed
    before its update, and every rank applies the same update; the metrics
    are the batch's: the summed losses over the summed count, the L1 of the
    summed parts."""
    main_loss, aux_loss = make_losses(spec, ts, num_particles)
    reduce = reduce or _same

    def step(state: SVIState, batch, noise: Optional[Dict] = None) -> Tuple[SVIState, Dict[str, Tensor]]:
        seed = fold_seed(state.seed, state.step)
        sc = batch.get("lr_scale", 1.0)
        loss_m, mets, grads = value_and_grad(
            main_loss, state.params, fold_seed(seed, "main"), batch, None if noise is None else noise["main"]
        )
        params, opt = optim.update_main(reduce(grads), state.opt, state.params, sc)
        loss_a, _, grads_a = value_and_grad(
            aux_loss, params, fold_seed(seed, "aux"), batch, None if noise is None else noise["aux"]
        )
        # the metrics' sums ride with the aux gradients
        grads_a, (sums, parts) = reduce([grads_a, [[loss_m, loss_a, torch.sum(batch["mask"])], mets["l1_parts"]]])
        params, opt = optim.update_aux(grads_a, opt, params, sc)
        n = torch.clamp(sums[2], min=1.0)
        metrics = {"loss_main": sums[0] / n, "loss_aux": sums[1] / n, "l1": particle_l1(parts)}
        return SVIState(params, opt, state.seed, state.step + 1), metrics

    return step


def make_train_step(spec: ModelSpec, ts: Tensor, lr: float, params_example, num_particles: int = 1,
                    optimizer: str = "shared", prior_lr_mult: float = 1.0, reduce: Optional[Callable] = None):
    """Returns (init_state, train_step, train_epoch).

    ``train_step(state, batch)`` is one dual step on a batch of tensors;
    ``train_epoch(state, batches)`` runs it over stacked minibatches (leading
    ``(n_batches, B, ...)`` axes, on the device) and returns the per-step
    metrics stacked. ``ts`` is the time grid as a tensor on the device.
    ``reduce``: as for :func:`make_dual_step`.
    """
    optim = make_dual_optimizer(spec, params_example, lr, optimizer, prior_lr_mult=prior_lr_mult)

    def init_state(params, seed: int) -> SVIState:
        params = tree_map(lambda p: p.detach().clone(), params)
        return SVIState(params, optim.init(params), int(seed), 0)

    train_step = make_dual_step(spec, ts, optim, num_particles, reduce)

    def train_epoch(state: SVIState, batches) -> Tuple[SVIState, Dict[str, Tensor]]:
        mets = []
        for i in range(batches["mask"].shape[0]):
            state, m = train_step(state, {k: v[i] for k, v in batches.items()})
            mets.append(m)
        return state, {k: torch.stack([m[k] for m in mets]) for k in mets[0]}

    return init_state, train_step, train_epoch


def stacked_step_seeds(seeds, steps, num_particles: int = 1, device=None) -> Tensor:
    """The draws' seeds of ``steps`` dual steps of S stacked members: an int64
    tensor ``(n_steps, S, 2, P)`` holding, for step k and member s, the main
    and the aux loss's particle seeds that :func:`make_dual_step` derives from
    ``seeds[s]`` at step k. Derived on the host, for a whole epoch at once, so
    the step's device operations do not depend on S."""
    rows = []
    for k in steps:
        for seed in seeds:
            step_seed = fold_seed(seed, k)
            for loss in ("main", "aux"):
                rows += particle_seeds(fold_seed(step_seed, loss), num_particles)
    return seed_tensor(rows, device).reshape(len(steps), len(seeds), 2, num_particles)


def over_members(spec: ModelSpec, fn, in_dims):
    """``fn`` mapped over S stacked members, ``in_dims`` as for
    ``torch.func.vmap`` (0 for a leading member axis, None for a shared
    value, a dict of them for a dict argument): one ``torch.func.vmap``, or,
    where the spec's ODE solve runs one member at a time
    (:func:`~structured_latent_odes_tpu_torch.nn.ode_model.solve_is_per_member`),
    ``fn`` on each member's slices with the results stacked, so that each
    member is the computation it would be on its own."""
    if not solve_is_per_member(spec.decoder.ode):
        return torch.func.vmap(fn, in_dims=in_dims)

    def member(arg, dim, m: int):
        if isinstance(dim, dict):
            return {k: member(v, dim[k], m) for k, v in arg.items()}
        return arg if dim is None else tree_map(lambda t: t.select(dim, m), arg)

    def looped(*args):
        S = next(tree_leaves(a)[0].shape[d] for a, d in zip(args, in_dims) if isinstance(d, int))
        outs = [fn(*(member(a, d, m) for a, d in zip(args, in_dims))) for m in range(S)]
        return tree_map(lambda *xs: torch.stack(xs), *outs)

    return looped


def make_stacked_dual_step(spec: ModelSpec, ts: Tensor, optim: DualOptimizer, num_particles: int = 1,
                           reduce: Optional[Callable] = None):
    """The dual step of S stacked members (the JAX ensemble's vmapped
    ``make_dual_step``): ``step(state, batch, batch_dims, seeds) -> (state,
    metrics)``. ``state`` holds stacked parameters and optimizer slots (a
    leading member axis on every tensor; the step counts are Python ints,
    shared, since members step in lockstep), the members' seeds as a list and
    one step counter. ``batch_dims`` names, per batch key, 0 for a leading
    member axis or None for a value all members share (the mask, ``aux_mult``,
    ``lr_scale``); ``seeds`` is this step's ``(S, 2, P)`` slice of
    :func:`stacked_step_seeds`.

    Both gradients are ``torch.func.vmap`` of ``torch.func.grad_and_value``
    over the members (:func:`over_members`), so every operation, the kernels
    K1-K3 included, runs once for all members: the step's count of device
    operations does not grow with S. Member s's result equals
    :func:`make_dual_step` on member s's slices to float32 roundoff (batched
    and single matrix products may round differently). On the adaptive ODE
    backends the members go one at a time, and each equals its sequential
    dual step.

    ``reduce`` sums the members' stacked gradients and metric sums over the
    ranks that hold slices of each member's batch, as in
    :func:`make_dual_step` (the ensemble's data axis)."""
    main_loss, aux_loss = make_losses(spec, ts, num_particles)
    grad_main = torch.func.grad_and_value(main_loss, has_aux=True)
    grad_aux = torch.func.grad_and_value(aux_loss)

    reduce = reduce or _same

    def step(state: SVIState, batch, batch_dims, seeds: Tensor):
        sc = batch.get("lr_scale", 1.0)
        grads, (loss_m, mets) = over_members(spec, grad_main, (0, 0, batch_dims))(state.params, seeds[:, 0], batch)
        params, opt = optim.update_main(reduce(grads), state.opt, state.params, sc)
        grads_a, loss_a = over_members(spec, grad_aux, (0, 0, batch_dims))(params, seeds[:, 1], batch)
        grads_a, (sums, parts) = reduce([grads_a, [[loss_m, loss_a, torch.sum(batch["mask"], dim=-1)],
                                                   mets["l1_parts"]]])
        params, opt = optim.update_aux(grads_a, opt, params, sc)
        n = torch.clamp(sums[2], min=1.0)
        metrics = {"loss_main": sums[0] / n, "loss_aux": sums[1] / n, "l1": particle_l1(parts)}
        return SVIState(params, opt, state.seed, state.step + 1), metrics

    return step


def eval_seeds(seed: int):
    """The eval draws' seeds: (losses, recon, classifier), as the JAX
    package's ``split(key, 3)``."""
    return fold_seed(seed, "losses"), fold_seed(seed, "recon"), fold_seed(seed, "classifier")


def make_eval_fns(spec: ModelSpec, ts: Tensor):
    """Eval-only functions: per-loss ELBO (SVI.evaluate_loss), classifier
    predictions, posterior/prior reconstruction."""

    @torch.no_grad()
    def evaluate_losses(params, seed, batch):
        loss_m, _ = elbo_main(spec, params, fold_seed(seed, "main"), batch, ts)
        return loss_m, elbo_aux(spec, params, fold_seed(seed, "aux"), batch)

    @torch.no_grad()
    def classify(params, seed, batch):
        return classifier(spec, params, seed, batch["observations"], batch.get("sample_id"))

    @torch.no_grad()
    def reconstruct(params, seed, batch, is_post: bool):
        return recon(spec, params, seed, batch, ts, is_post)

    return evaluate_losses, classify, reconstruct


def make_eval_epoch(spec: ModelSpec, ts: Tensor, reduce: Optional[Callable] = None):
    """Whole-split evaluation over stacked minibatches on the device: what
    the ``eval_split`` host loop computes (per-loss ELBO as a sum of
    per-batch loss/n, recon L1 sum, n, one summed statistic per label) with
    the same seeds, so the two agree to float32 summation order.

    Returns ``eval_epoch(params, seed, batches, is_post) -> stats``, a dict of
    0-d tensors (``labels`` a dict of them). With ``reduce`` (as for
    :func:`make_dual_step`) each rank holds a slice of every batch: the
    batches' sums (losses, count, the L1's parts, the label statistics) are
    summed over the ranks in one collective, and each batch's ratios are
    taken from the sums."""
    evaluate_losses, classify, reconstruct = make_eval_fns(spec, ts)
    reduce = reduce or _same

    @torch.no_grad()
    def eval_epoch(params, seed, batches, is_post: bool):
        s_loss, s_recon, s_cls = eval_seeds(seed)
        rows = []
        for i in range(batches["mask"].shape[0]):
            batch = {k: v[i] for k, v in batches.items()}
            m = batch["mask"]
            lm, la = evaluate_losses(params, s_loss, batch)
            r = reconstruct(params, s_recon, batch, is_post)
            p = classify(params, s_cls, batch)
            labels = {}
            for label in spec.labels:
                pred, target = p[label.name], batch[label.name]
                if label.kind == "bernoulli":
                    labels[label.name] = torch.sum(torch.all(pred == target, dim=-1) * m)
                elif label.kind == "onehot":
                    labels[label.name] = torch.sum((pred.argmax(-1) == target.argmax(-1)) * m)
                else:  # continuous: summed per-sample mean squared error
                    labels[label.name] = torch.sum(torch.mean((pred - target) ** 2, dim=-1) * m)
            rows.append([lm, la, torch.sum(m), masked_abs_parts(r["mu_50"] - batch["observations"], m), labels])
        sums = None
        for lm, la, n, parts, labels in reduce(rows):
            nn = torch.clamp(n, min=1.0)
            one = {"elbo_main": lm / nn, "elbo_aux": la / nn, "l1": l1_of_parts(*parts), "n": n, "labels": labels}
            sums = one if sums is None else tree_map(torch.add, sums, one)
        return sums

    return eval_epoch
