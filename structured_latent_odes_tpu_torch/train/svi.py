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

The step is a Python function and an epoch a loop over the stacked
minibatches on the device. Parameters are nested dicts of tensors, which the
eager step replaces (it updates none in place). On a CUDA device, where the
spec's solve can be captured and the ranks' sums, if any, too (NCCL's;
:func:`epoch_dispatch`), ``train_epoch`` replays the dual step as a CUDA
graph (``utils/graphs.py``), ``eval_epoch`` a whole split as one graph,
and each of :func:`make_eval_fns`' functions (which serving's predict
functions are) one call: the counterpart of the JAX package's jitted
``lax.scan`` epochs and eval functions. The graphs keep
the state in buffers that each replay overwrites in place, as JAX's
``donate_argnums=0`` donates the state; they are memoized in one memo
(``utils/graphs.py``), as the JAX package memoizes its jitted functions.
:class:`Dispatch` (each path's choice and its bodies' calls) and
:func:`stepped_epoch` are that machinery, which the ensemble runner
(``train/ensemble.py``) shares.

Randomness: the state carries an integer seed and a step counter. Each step's
main and aux draws are keyed by ``fold_seed(seed, step, 'main' | 'aux')``
(``prob/distributions.py``), and each particle's by its index, so a draw
depends only on (seed, step, site, sample_id). The host derives those seeds
for a whole epoch as one int64 tensor, and Adam's bias corrections as one
float32 tensor (:func:`epoch_scalars`): the step's device operations read
every number that changes from step to step from a tensor, in the eager
step and in its graph alike. The step counts stay host ints.

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
from structured_latent_odes_tpu_torch.nn.ode_model import NOT_CAPTURABLE, solve_is_capturable, solve_is_per_member
from structured_latent_odes_tpu_torch.ops.multi_adam import multi_adam
from structured_latent_odes_tpu_torch.prob import fold_seed, l1_of_parts, seed_tensor
from structured_latent_odes_tpu_torch.utils.graphs import copy_in, counted, replayed, signature
from structured_latent_odes_tpu_torch.utils.profiling import span
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
    """State init, the two per-loss update rules, and ``schedule(opt) ->
    (corrections, opt')``: on the host, a dual step's bias corrections, an
    array ``(2, 2, L)`` (the main then the aux update's
    :func:`bias_corrections`), and ``opt`` with the step counts that the
    step leaves."""

    init: Callable[[Any], Any]
    update_main: Callable[..., Tuple[Any, Any]]  # (grads, opt, params, lr_scale, corrections)
    update_aux: Callable[..., Tuple[Any, Any]]
    schedule: Callable[[Any], Tuple[np.ndarray, Any]]


def shared_adam_init(params) -> AdamSlots:
    return AdamSlots(
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
        count=tree_map(lambda _: 0, params),
    )


def _bias_correction(b: float, count: int) -> float:
    """``1 - b**count`` in float32, as the JAX package computes it."""
    return float(np.float32(1.0) - np.power(np.float32(b), np.float32(count)))


def advance_counts(count, mask):
    """The step counts after an update: one more on each leaf that ``mask``
    steps."""
    return tree_unflatten(count, _advanced(tree_leaves(count), tree_leaves(mask)))


def bias_corrections(count, mask, b1: float = 0.9, b2: float = 0.999) -> np.ndarray:
    """An update's bias corrections on the host, float32 ``(2, L)`` over
    the leaves in ``tree_leaves`` order: ``1 - b1**c`` and ``1 - b2**c`` at
    the count c that the update gives each leaf ``mask`` steps, 1 on the
    others (which the update leaves)."""
    return _corrections(tree_leaves(count), tree_leaves(mask), b1, b2)


def _corrections(counts, mask, b1: float = 0.9, b2: float = 0.999) -> np.ndarray:
    """:func:`bias_corrections` of the leaves' counts and mask flags as
    lists, each distinct count's powers computed once."""
    stepped = {c for c, mk in zip(counts, mask) if mk}
    at = {c: (_bias_correction(b1, c + 1), _bias_correction(b2, c + 1)) for c in stepped}
    return np.array([[at[c][k] if mk else 1.0 for c, mk in zip(counts, mask)] for k in (0, 1)], np.float32)


def _advanced(counts, mask):
    """:func:`advance_counts` on lists of the leaves' counts and mask
    flags."""
    return [c + 1 if mk else c for c, mk in zip(counts, mask)]


def shared_adam_update(grads, slots: AdamSlots, params, mask, lr, b1: float = 0.9,
                       b2: float = 0.999, eps: float = 1e-8, lr_scales=None, corrections=None):
    """One ``torch.optim.Adam`` step on the parameters whose ``mask`` leaf is
    True. Masked-out leaves keep their params, moments and step count, as
    torch does for a parameter whose grad is None. ``lr`` may be a 0-d tensor
    (a per-batch scale); ``lr_scales`` is an optional congruent tree of
    per-leaf multipliers (the prior-lr knob).

    ``corrections`` is the update's :func:`bias_corrections` as a float32
    tensor on the params' device (a dual step's comes from
    :func:`epoch_scalars`); None makes it from ``slots.count``. The moments
    are divided by its elements, device tensors, so an eager update and a
    graph's replay of it divide alike.

    The stepped leaves go to ``ops/multi_adam.py::multi_adam`` together: on
    the card one launch, on the CPU :func:`adam_plain`.
    ``shared_adam_update.leaves`` counts the leaf updates asked for, on any
    device (the kernel's ``leaves`` over it is its engagement share)."""
    if corrections is None:
        corrections = torch.as_tensor(bias_corrections(slots.count, mask, b1, b2),
                                      device=tree_leaves(params)[0].device)
    new_p, new_m, new_n = tree_leaves(params), tree_leaves(slots.mu), tree_leaves(slots.nu)
    grads = tree_leaves(grads)
    scales = tree_leaves(lr_scales) if lr_scales is not None else [1.0] * len(new_p)
    cols = [i for i, mk in enumerate(tree_leaves(mask)) if mk]
    shared_adam_update.leaves += len(cols)
    # a stacked step's gradients leave torch.func.vmap in whatever layout its
    # batching rules chose, on the card not always contiguous: the kernel
    # reads them contiguous (a copy only where one is not)
    stepped = multi_adam([new_p[i] for i in cols], [grads[i].contiguous() for i in cols], [new_m[i] for i in cols],
                         [new_n[i] for i in cols], lr, corrections, cols, [scales[i] for i in cols], b1, b2, eps)
    for out, new in zip((new_p, new_m, new_n), stepped):
        for i, t in zip(cols, new):
            out[i] = t
    return tree_unflatten(params, new_p), AdamSlots(
        tree_unflatten(params, new_m), tree_unflatten(params, new_n), advance_counts(slots.count, mask)
    )


counted(shared_adam_update, ints=("leaves",))


def adam_plain(params, grads, mu, nu, lr, corrections, cols, scales, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8):
    """The plain version of ``ops/multi_adam.py::multi_adam``: one
    ``torch.optim.Adam`` step of each leaf in float32 tensor arithmetic, a
    leaf at a time. Leaf i is divided by the bias corrections
    ``corrections[:, cols[i]]`` (device tensors, so an eager update and a
    graph's replay of it divide alike) and stepped by ``lr * scales[i]``.
    Returns the lists ``(params', mu', nu')``."""
    c1, c2 = corrections
    new_p, new_m, new_n = [], [], []
    for p, g, m, n, i, sc in zip(params, grads, mu, nu, cols, scales):
        m2 = b1 * m + (1.0 - b1) * g
        n2 = b2 * n + (1.0 - b2) * g * g
        m_hat = m2 / c1[i]
        n_hat = n2 / c2[i]
        new_p.append(p - (lr * sc) * m_hat / (torch.sqrt(n_hat) + eps))
        new_m.append(m2), new_n.append(n2)
    return new_p, new_m, new_n


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
            def fn(grads, slots, params, sc=1.0, corrections=None):
                return shared_adam_update(grads, slots, params, mask, lr * sc, lr_scales=lr_scales,
                                          corrections=corrections)
            return fn

        main_flags, aux_flags = tree_leaves(main_mask), tree_leaves(aux_mask)

        def schedule(slots: AdamSlots):
            # one walk of the counts' tree a step: the host's schedule of an
            # epoch's steps runs while the card waits for their first launch
            counts = tree_leaves(slots.count)
            main = _corrections(counts, main_flags)
            counts = _advanced(counts, main_flags)
            aux = _corrections(counts, aux_flags)
            count = tree_unflatten(slots.count, _advanced(counts, aux_flags))
            return np.stack([main, aux]), AdamSlots(slots.mu, slots.nu, count)

        return DualOptimizer(init=shared_adam_init, update_main=update(main_mask), update_aux=update(aux_mask),
                             schedule=schedule)
    if mode == "split":
        if prior_lr_mult != 1.0:
            raise ValueError("prior_lr_mult requires optimizer='shared'")

        def update(mask, which: int):
            def fn(grads, opt, params, sc=1.0, corrections=None):
                if not isinstance(sc, float):
                    raise ValueError("lr schedules require optimizer='shared'")
                params, slots = shared_adam_update(grads, opt[which], params, mask, lr, corrections=corrections)
                return params, tuple(slots if i == which else s for i, s in enumerate(opt))
            return fn

        def schedule(opt):
            masks = (main_mask, aux_mask)
            return (np.stack([bias_corrections(s.count, mk) for s, mk in zip(opt, masks)]),
                    tuple(AdamSlots(s.mu, s.nu, advance_counts(s.count, mk)) for s, mk in zip(opt, masks)))

        return DualOptimizer(
            init=lambda p: (shared_adam_init(p), shared_adam_init(p)),
            update_main=update(main_mask, 0),
            update_aux=update(aux_mask, 1),
            schedule=schedule,
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
    taken to hold them already (:func:`stacked_step_seeds` derives them on
    the host)."""
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
    """The sequential dual-loss SVI update: ``step(state, batch, noise=None,
    scalars=None) -> (state, metrics)``. ``noise`` is None or ``{"main":
    [...], "aux": [...]}`` with one ``noise=`` dict per particle (tests feed
    JAX's draws). The batch may override ``aux_mult`` and ``lr_scale``.
    ``scalars`` is this step's ``(seeds (2, P), corrections (2, 2, L))``, a
    row of :func:`epoch_scalars`; None derives it from the state.

    ``reduce`` (data parallelism, ``parallel/train.py``; None on one device)
    sums a tree of tensors over the ranks that hold slices of one batch.
    Both losses are sums over the batch, so each loss's gradients are summed
    before its update, and every rank applies the same update; the metrics
    are the batch's: the summed losses over the summed count, the L1 of the
    summed parts."""
    main_loss, aux_loss = make_losses(spec, ts, num_particles)
    reduce = reduce or _same

    def step(state: SVIState, batch, noise: Optional[Dict] = None,
             scalars: Optional[Tuple[Tensor, Tensor]] = None) -> Tuple[SVIState, Dict[str, Tensor]]:
        if scalars is None:
            seeds, corrections, _ = epoch_scalars(optim, state, 1, num_particles)
            scalars = seeds[0], corrections[0]
        seeds, corrections = scalars
        sc = batch.get("lr_scale", 1.0)
        loss_m, mets, grads = value_and_grad(
            main_loss, state.params, seeds[0], batch, None if noise is None else noise["main"]
        )
        params, opt = optim.update_main(reduce(grads), state.opt, state.params, sc, corrections[0])
        loss_a, _, grads_a = value_and_grad(
            aux_loss, params, seeds[1], batch, None if noise is None else noise["aux"]
        )
        # the metrics' sums ride with the aux gradients
        grads_a, (sums, parts) = reduce([grads_a, [[loss_m, loss_a, torch.sum(batch["mask"])], mets["l1_parts"]]])
        params, opt = optim.update_aux(grads_a, opt, params, sc, corrections[1])
        n = torch.clamp(sums[2], min=1.0)
        metrics = {"loss_main": sums[0] / n, "loss_aux": sums[1] / n, "l1": particle_l1(parts)}
        return SVIState(params, opt, state.seed, state.step + 1), metrics

    return step


def epoch_scalars(optim: DualOptimizer, state: SVIState, n_steps: int, num_particles: int = 1):
    """What changes from step to step, for the ``n_steps`` dual steps from
    ``state``, derived on the host and moved to the params' device at once:
    the draws' seeds, int64 ``(n_steps, 2, P)`` (the main and the aux loss's
    particle seeds, :func:`stacked_step_seeds`), Adam's bias corrections,
    float32 ``(n_steps, 2, 2, L)`` (``optim.schedule``), and the optimizer
    state with the step counts after the last of those steps."""
    device = tree_leaves(state.params)[0].device
    seeds = stacked_step_seeds([state.seed], range(state.step, state.step + n_steps), num_particles, device)
    corrections, opt = step_corrections(optim, state.opt, n_steps, device)
    return seeds.reshape(n_steps, 2, num_particles), corrections, opt


def step_corrections(optim: DualOptimizer, opt, n_steps: int, device):
    """Adam's bias corrections of ``n_steps`` dual steps from the optimizer
    state ``opt``, float32 ``(n_steps, 2, 2, L)`` on ``device``
    (``optim.schedule``), and ``opt`` with the counts after them."""
    corrections = []
    for _ in range(n_steps):
        c, opt = optim.schedule(opt)
        corrections.append(c)
    return torch.as_tensor(np.stack(corrections), device=device), opt


def _slots(opt):
    return [opt] if isinstance(opt, AdamSlots) else list(opt)


def _state_tree(state: SVIState):
    """The state's tensors as a tree: ``[params, [mu, nu] of each slot
    set]``."""
    return [state.params] + [[s.mu, s.nu] for s in _slots(state.opt)]


def _counts(opt):
    """Each slot set's step counts: the host part of the optimizer state."""
    return [s.count for s in _slots(opt)]


def _state_over(tree, counts, seed, step) -> SVIState:
    """The state over the tensors of ``tree`` (:func:`_state_tree`'s layout)
    with the step counts ``counts`` (:func:`_counts`; one slot set is the
    shared optimizer's, two the split one's)."""
    slots = [AdamSlots(mu, nu, c) for (mu, nu), c in zip(tree[1:], counts)]
    return SVIState(tree[0], slots[0] if len(slots) == 1 else tuple(slots), seed, step)


def _tensors(state: SVIState):
    """The state's tensors: the params, then each slot set's moments."""
    return tree_leaves(_state_tree(state))


def own_tree(tree):
    """A copy of a tree of tensors: what a caller keeps of a graph's
    buffers."""
    return tree_map(lambda t: t.detach().clone(), tree)


def own_state(state: SVIState) -> SVIState:
    """A copy of the state's tensors, with its counts, seed and step: what a
    caller keeps of a state over a graph's buffers."""
    return _state_over(own_tree(_state_tree(state)), _counts(state.opt), state.seed, state.step)


def _ts_key(ts: Tensor):
    a = ts.detach().cpu().numpy()
    return a.shape, str(a.dtype), a.tobytes()


def epoch_dispatch(spec: ModelSpec, device, reduce: Optional[Callable] = None) -> str:
    """How ``train_epoch``, ``eval_epoch`` and the eval functions run: 'cuda
    graph' on a CUDA device when the spec's solve can be captured
    (``nn/ode_model.py::solve_is_capturable``) and, where ranks reduce, the
    reduce can be captured too, else 'eager (<reason>)'. A reduce says so in
    its ``capturable`` attribute (``parallel/mesh.py::data_reduce``: an NCCL
    sum is a kernel on the card, which a graph records; a gloo sum runs on
    the host, which it cannot), and names its ``backend``."""
    device = torch.device(device)
    backend = spec.decoder.ode.backend
    if device.type != "cuda":
        return f"eager (on {device.type}: a CUDA graph needs a CUDA device)"
    if reduce is not None and not getattr(reduce, "capturable", False):
        over = getattr(reduce, "backend", None)
        if over is None:
            return "eager (ranks: the reduce is not marked capturable)"
        return f"eager (ranks over {over}: a {over} sum runs on the host, which a CUDA graph cannot capture)"
    if not solve_is_capturable(spec.decoder.ode):
        return f"eager ({backend}: {NOT_CAPTURABLE[backend]})"
    return "cuda graph"


class Dispatch:
    """How the bodies of one captured path run, decided once. ``dispatch`` None takes
    :func:`epoch_dispatch`'s choice for the spec, the device of ``ts`` and
    ``reduce``; 'eager' and 'plain' (a graph's plain version,
    ``utils/graphs.py``: the CPU tests) are taken as asked. ``name`` is the
    choice, which the CLIs print.

    :meth:`runner` gives the call of a body ``body(inputs)``: the body
    itself when eager, else its graph over buffers (``utils/graphs.py``'s
    :class:`~structured_latent_odes_tpu_torch.utils.graphs.Replayed`),
    memoized in the one memo under the path's name, its recipe (``spec``,
    ``ts``, the device, the choice, ``reduce`` and ``recipe``), the body's
    name and the signature of its data.
    :meth:`own` is what a caller keeps of a body's outputs: a copy where
    they are a graph's buffers, which its next call overwrites."""

    def __init__(self, dispatch: Optional[str], path: str, spec: ModelSpec, ts: Tensor,
                 reduce: Optional[Callable] = None, *recipe):
        if dispatch is None:
            dispatch = epoch_dispatch(spec, ts.device, reduce)
        elif dispatch not in ("eager", "plain"):
            raise ValueError(f"unknown epoch dispatch {dispatch!r}: None, 'eager' or 'plain'")
        self.name, self.device = dispatch, ts.device
        self.graphed = dispatch in ("cuda graph", "plain")
        if self.graphed:
            self.key = (path, spec, _ts_key(ts), str(ts.device), dispatch, reduce) + recipe

    def runner(self, part, body: Callable, example, data) -> Callable:
        """The call of ``body``, the path's body named ``part``, for
        inputs shaped as ``example``; ``data`` is the part of them whose
        shapes tell its graphs apart (the recipe pins the params')."""
        if not self.graphed:
            return body
        return replayed(self.key + (part, signature(data)), body, example, self.device, plain=self.name == "plain")

    def own(self, tree):
        return own_tree(tree) if self.graphed else tree


def stepped_epoch(dispatch: Dispatch, call, state: SVIState, rows, seeds: Tensor, corrections: Tensor, opt,
                  fills=None):
    """The steps ``call(state, batch, seeds, corrections) -> (state,
    metrics)`` from ``state`` over ``rows`` (a list of batches, one a step),
    step i fed row i of ``seeds`` and of ``corrections``; ``fills`` holds the
    batch entries that are one host number for all the steps (float32 0-d).
    Returns the state after the steps, with ``opt``'s step counts (the counts
    after them, derived on the host), and each metric stacked over them.

    As a graph (``dispatch``) the step is captured once for the batch's
    signature and replayed for each row: the captured step ends by writing
    the new params and moments into the state's buffers, in place, and the
    state it returns is over those buffers, which the graph's next call
    overwrites."""
    shared = {k: torch.full((), v, dtype=torch.float32, device=dispatch.device) for k, v in (fills or {}).items()}
    counts, seed, step = _counts(state.opt), state.seed, state.step  # the body holds no tensor of the caller's

    def body(x):
        new, metrics = call(_state_over(x["state"], counts, seed, step), x["batch"], x["seeds"], x["corrections"])
        new = _state_tree(new)
        if dispatch.graphed:  # the buffers take the new state
            copy_in(x["state"], new)
            new = x["state"]
        return new, metrics

    def inputs(tree, i: int):
        return {"state": tree, "batch": {**rows[i], **shared}, "seeds": seeds[i], "corrections": corrections[i]}

    first = inputs(_state_tree(state), 0)
    run = dispatch.runner("step", body, first, first["batch"])
    tree, mets = first["state"], None
    for i in range(len(rows)):
        tree, m = run(inputs(tree, i))
        if mets is None:
            mets = {k: v.new_empty((len(rows),) + v.shape) for k, v in m.items()}
        copy_in({k: v[i] for k, v in mets.items()}, m)
    return _state_over(tree, _counts(opt), state.seed, state.step + len(rows)), mets


def make_train_step(spec: ModelSpec, ts: Tensor, lr: float, params_example, num_particles: int = 1,
                    optimizer: str = "shared", prior_lr_mult: float = 1.0, reduce: Optional[Callable] = None,
                    dispatch: Optional[str] = None):
    """Returns (init_state, train_step, train_epoch).

    ``train_step(state, batch)`` is one dual step on a batch of tensors;
    ``train_epoch(state, batches)`` runs it over stacked minibatches (leading
    ``(n_batches, B, ...)`` axes, on the device) and returns the per-step
    metrics stacked. ``ts`` is the time grid as a tensor on the device.
    ``reduce``: as for :func:`make_dual_step`.

    ``dispatch`` picks how ``train_epoch`` runs (:class:`Dispatch`): None as
    :func:`epoch_dispatch` says; 'eager'; or 'plain', the captured path's
    buffers with the graph's plain version (``utils/graphs.py``; the CPU
    tests). ``train_epoch.dispatch`` names the choice. When it is the CUDA
    graph, the step is captured once for each recipe and batch shape and
    memoized; ``train_epoch`` returns a state over the graph's buffers, which
    the graph's next epoch overwrites, whoever calls it: keep a clone of what
    must outlive it (JAX's donated state).
    """
    optim = make_dual_optimizer(spec, params_example, lr, optimizer, prior_lr_mult=prior_lr_mult)
    dispatch = Dispatch(dispatch, "train", spec, ts, reduce, int(num_particles), optimizer, float(lr),
                        float(prior_lr_mult))

    def init_state(params, seed: int) -> SVIState:
        params = tree_map(lambda p: p.detach().clone(), params)
        return SVIState(params, optim.init(params), int(seed), 0)

    train_step = make_dual_step(spec, ts, optim, num_particles, reduce)

    def step(state, batch, seeds, corrections):
        return train_step(state, batch, None, (seeds, corrections))

    def train_epoch(state: SVIState, batches) -> Tuple[SVIState, Dict[str, Tensor]]:
        with span("dispatch.train"):
            n = batches["mask"].shape[0]
            seeds, corrections, opt = epoch_scalars(optim, state, n, num_particles)
            rows = [{k: v[i] for k, v in batches.items()} for i in range(n)]
            return stepped_epoch(dispatch, step, state, rows, seeds, corrections, opt)

    train_epoch.dispatch = dispatch.name
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
    ``make_dual_step``): ``step(state, batch, batch_dims, seeds,
    corrections=None) -> (state, metrics)``. ``state`` holds stacked parameters and optimizer slots (a
    leading member axis on every tensor; the step counts are Python ints,
    shared, since members step in lockstep), the members' seeds as a list and
    one step counter. ``batch_dims`` names, per batch key, 0 for a leading
    member axis or None for a value all members share (the mask, ``aux_mult``,
    ``lr_scale``); ``seeds`` is this step's ``(S, 2, P)`` slice of
    :func:`stacked_step_seeds`, ``corrections`` its ``(2, 2, L)`` row of
    :func:`step_corrections` (None: made from the state's counts).

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

    def step(state: SVIState, batch, batch_dims, seeds: Tensor, corrections: Optional[Tensor] = None):
        if corrections is None:
            corrections = step_corrections(optim, state.opt, 1, seeds.device)[0][0]
        sc = batch.get("lr_scale", 1.0)
        grads, (loss_m, mets) = over_members(spec, grad_main, (0, 0, batch_dims))(state.params, seeds[:, 0], batch)
        params, opt = optim.update_main(reduce(grads), state.opt, state.params, sc, corrections[0])
        grads_a, loss_a = over_members(spec, grad_aux, (0, 0, batch_dims))(params, seeds[:, 1], batch)
        grads_a, (sums, parts) = reduce([grads_a, [[loss_m, loss_a, torch.sum(batch["mask"], dim=-1)],
                                                   mets["l1_parts"]]])
        params, opt = optim.update_aux(grads_a, opt, params, sc, corrections[1])
        n = torch.clamp(sums[2], min=1.0)
        metrics = {"loss_main": sums[0] / n, "loss_aux": sums[1] / n, "l1": particle_l1(parts)}
        return SVIState(params, opt, state.seed, state.step + 1), metrics

    return step


def eval_seeds(seed: int):
    """The eval draws' seeds: (losses, recon, classifier), as the JAX
    package's ``split(key, 3)``."""
    return fold_seed(seed, "losses"), fold_seed(seed, "recon"), fold_seed(seed, "classifier")


_NOISE = "noise/"


def _with_noise(inputs, noise):
    """A function's tensor inputs and its draws (``noise=``, a dict of
    tensors or of dicts of them) as one flat dict: what a graph copies into
    its buffers, and whose signature keys it."""
    if noise is None:
        return inputs
    flat = {}
    for k, v in noise.items():
        if isinstance(v, dict):
            flat.update({f"{_NOISE}{k}/{name}": t for name, t in v.items()})
        else:
            flat[_NOISE + k] = v
    return {**inputs, **flat}


def _without_noise(inputs):
    """The inverse of :func:`_with_noise`: (inputs, noise or None)."""
    noise = {}
    for k, v in inputs.items():
        if k.startswith(_NOISE):
            *outer, name = k[len(_NOISE):].split("/")
            (noise.setdefault(outer[0], {}) if outer else noise)[name] = v
    return {k: v for k, v in inputs.items() if not k.startswith(_NOISE)}, noise or None


def make_eval_fns(spec: ModelSpec, ts: Tensor, dispatch: Optional[str] = None):
    """Eval-only functions: per-loss ELBO (SVI.evaluate_loss), classifier
    predictions, posterior/prior reconstruction. ``evaluate_losses(params,
    seed, batch, noise=None)``, ``classify(params, seed, batch, noise=None)``
    (it reads the batch's observations and sample ids) and
    ``reconstruct(params, seed, batch, is_post, noise=None)``; ``noise``
    holds the draws, as ``models.classifier`` and ``models.recon`` take
    them (``{"main": ..., "aux": ...}`` for the two ELBOs).

    ``dispatch`` as for :func:`make_train_step`; each function's
    ``dispatch`` names the choice. As a CUDA graph (the JAX package's jitted
    eval functions, memoized on (spec, ts)) each function is captured once
    for each ``is_post`` and signature of its inputs (the noise's included)
    and memoized: a call copies the params, the seed (a host int becomes a
    0-d int64 tensor, whose draws are the int's) and the inputs into the
    graph's buffers, replays it and returns copies of its outputs. The
    first call of each graph runs eagerly (``utils/graphs.py``)."""
    device = ts.device
    dispatch = Dispatch(dispatch, "eval_fns", spec, ts)

    def losses(x):
        batch, noise = _without_noise(x["inputs"])
        noise = noise or {}
        loss_m, _ = elbo_main(spec, x["params"], fold_seed(x["seed"], "main"), batch, ts, noise=noise.get("main"))
        return loss_m, elbo_aux(spec, x["params"], fold_seed(x["seed"], "aux"), batch, noise=noise.get("aux"))

    def labels(x):
        batch, noise = _without_noise(x["inputs"])
        return classifier(spec, x["params"], x["seed"], batch["observations"], batch.get("sample_id"), noise=noise)

    def recons(is_post: bool):
        def body(x):
            batch, noise = _without_noise(x["inputs"])
            return recon(spec, x["params"], x["seed"], batch, ts, is_post, noise=noise)
        return body

    bodies = {"losses": losses, "classify": labels, ("recon", True): recons(True), ("recon", False): recons(False)}

    def run(name, params, seed, inputs):
        if dispatch.graphed and not isinstance(seed, Tensor):  # a graph reads its seed from a buffer
            seed = seed_tensor([seed], device)[0]
        x = {"params": params, "seed": seed, "inputs": inputs}
        return dispatch.own(dispatch.runner(name, bodies[name], x, inputs)(x))

    @torch.no_grad()
    def evaluate_losses(params, seed, batch, noise=None):
        return tuple(run("losses", params, seed, _with_noise(batch, noise)))

    @torch.no_grad()
    def classify(params, seed, batch, noise=None):
        inputs = {k: batch[k] for k in ("observations", "sample_id") if k in batch}
        return run("classify", params, seed, _with_noise(inputs, noise))

    @torch.no_grad()
    def reconstruct(params, seed, batch, is_post: bool, noise=None):
        return run(("recon", bool(is_post)), params, seed, _with_noise(batch, noise))

    for fn in (evaluate_losses, classify, reconstruct):
        fn.dispatch = dispatch.name
    return evaluate_losses, classify, reconstruct


def make_eval_epoch(spec: ModelSpec, ts: Tensor, reduce: Optional[Callable] = None, dispatch: Optional[str] = None):
    """Whole-split evaluation over stacked minibatches on the device: what
    the ``eval_split`` host loop computes (per-loss ELBO as a sum of
    per-batch loss/n, recon L1 sum, n, one summed statistic per label) with
    the same seeds, so the two agree to float32 summation order.

    Returns ``eval_epoch(params, seed, batches, is_post) -> stats``, a dict of
    0-d tensors (``labels`` a dict of them). With ``reduce`` (as for
    :func:`make_dual_step`) each rank holds a slice of every batch: the
    batches' sums (losses, count, the L1's parts, the label statistics) are
    summed over the ranks in one collective, and each batch's ratios are
    taken from the sums.

    The three eval seeds reach the device as one int64 tensor, on a card
    from pinned memory without a stream sync: a call waits for none of the
    work queued before it. ``dispatch``
    as for :func:`make_train_step`: as a CUDA graph each (split shape,
    ``is_post``) is captured once and memoized, and a call copies the
    params, the split and the seeds into the graph's buffers and replays
    the whole split in one launch (the JAX package's one dispatch per split
    and mode)."""
    evaluate_losses, classify, reconstruct = make_eval_fns(spec, ts, dispatch="eager")  # inside this graph
    device = ts.device
    dispatch = Dispatch(dispatch, "eval_epoch", spec, ts, reduce)
    reduce = reduce or _same

    @torch.no_grad()
    def body(params, seeds: Tensor, batches, is_post: bool):
        s_loss, s_recon, s_cls = seeds
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

    def seeds_on_device(seed: int) -> Tensor:
        if device.type != "cuda":
            return seed_tensor(eval_seeds(seed), device)
        # a pageable copy would sync the stream; the pinned block is not
        # reused before the copy ends (the caching host allocator's event)
        return seed_tensor(eval_seeds(seed)).pin_memory().to(device, non_blocking=True)

    def eval_epoch(params, seed, batches, is_post: bool):
        with span("dispatch.eval"):
            x = {"params": params, "seeds": seeds_on_device(seed), "batches": batches}
            run = dispatch.runner(bool(is_post), lambda x: body(x["params"], x["seeds"], x["batches"], is_post), x,
                                  batches)
            return dispatch.own(run(x))

    eval_epoch.dispatch = dispatch.name
    return eval_epoch
