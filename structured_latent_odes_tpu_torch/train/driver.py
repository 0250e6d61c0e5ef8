"""The epoch loop shared by the dataset drivers (the JAX package's
``train/driver.py``): per-minibatch dual SVI steps, per-epoch evaluation of
the val and train splits under posterior and prior reconstruction (the
reference's ``input_pred_stats``), a dataset's best-model policy, and the
final test evaluation.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP item:
periodic checkpoints and resume (A10-rest), a profiler trace of an epoch
(A17), and the plotting ``on_epoch`` (A11-rest).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from structured_latent_odes_tpu_torch.data.loader import iter_minibatches, stacked_minibatches
from structured_latent_odes_tpu_torch.models.spec import ModelSpec
from structured_latent_odes_tpu_torch.prob import fold_seed
from structured_latent_odes_tpu_torch.train import metrics as M
from structured_latent_odes_tpu_torch.train.svi import eval_seeds
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

log = logging.getLogger("slode")


@dataclass
class EvalStats:
    elbo: List[float]  # per loss, the sum over batches of loss / batch size
    l1: float
    label_metrics: Dict[str, float]
    recon: Dict[str, np.ndarray]
    labels: Dict[str, np.ndarray]
    observations: np.ndarray


def device_batch(batch, device):
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


def eval_split(spec: ModelSpec, params, seed: int, split: Dict[str, np.ndarray], eval_fns,
               batch_size: int, is_post: bool, collect_recon: bool = True) -> EvalStats:
    """Per-loss ELBO, classifier metrics and recon outputs over a split.

    The site seeds are derived once for the whole split, and every draw is
    keyed by its sample's id, so recon outputs and label metrics do not
    depend on the eval batch size. The summed ELBO keeps the reference's
    sum-of-batch-means accounting.
    """
    evaluate_losses, classify, reconstruct = eval_fns
    device = tree_leaves(params)[0].device
    s_loss, s_recon, s_cls = eval_seeds(seed)
    elbo = [0.0, 0.0]
    total_l1, size = 0.0, 0
    recon_acc: Dict[str, List[np.ndarray]] = {}
    preds_acc: Dict[str, List[np.ndarray]] = {}
    labels_acc: Dict[str, List[np.ndarray]] = {}
    obs_acc: List[np.ndarray] = []

    for batch in iter_minibatches(split, batch_size, shuffle=False, pad=True):
        b = device_batch(batch, device)
        n = int(batch["mask"].sum())
        sel = batch["mask"] > 0
        lm, la = evaluate_losses(params, s_loss, b)
        elbo[0] += float(lm) / n
        elbo[1] += float(la) / n

        r = reconstruct(params, s_recon, b, is_post)
        total_l1 += float(r["l1"])
        size += n
        if collect_recon:
            for k in ("mu_50", "mu_75", "mu_25", "solution_xt", "z", "std"):
                recon_acc.setdefault(k, []).append(r[k].cpu().numpy()[sel])
            obs_acc.append(batch["observations"][sel])
        for label in spec.labels:
            labels_acc.setdefault(label.name, []).append(batch[label.name][sel])

        p = classify(params, s_cls, b)
        for label in spec.labels:
            preds_acc.setdefault(label.name, []).append(p[label.name].cpu().numpy()[sel])

    labels = {k: np.concatenate(v) for k, v in labels_acc.items()}
    label_metrics = {}
    for label in spec.labels:
        pred = np.concatenate(preds_acc[label.name])
        target = labels[label.name]
        if label.kind == "bernoulli":
            label_metrics[label.name] = M.accuracy(pred, target)
        elif label.kind == "onehot":
            label_metrics[label.name] = M.onehot_accuracy(pred, target)
        else:
            label_metrics[label.name] = M.mse(pred, target)

    return EvalStats(
        elbo=elbo,
        l1=total_l1 / max(size, 1),
        label_metrics=label_metrics,
        recon={k: np.concatenate(v) for k, v in recon_acc.items()},
        labels=labels,
        observations=np.concatenate(obs_acc) if obs_acc else np.zeros(0),
    )


def epoch_aux_mult(config, epoch: int):
    """Optional aux-site scale schedule: warm-up aux_mult_start ->
    aux_loss_multiplier over aux_warmup_epochs, then (when both are
    configured, from the end of the warm-up) linear anneal to aux_mult_final
    over aux_anneal_epochs. None: the spec constant (no schedule)."""
    base = float(config.aux_loss_multiplier)
    warmup = config.get("aux_warmup_epochs") or 0
    start = config.get("aux_mult_start")
    anneal = config.get("aux_anneal_epochs") or 0
    final = config.get("aux_mult_final")
    has_warmup = bool(warmup) and start is not None
    has_anneal = bool(anneal) and final is not None
    if not has_warmup and not has_anneal:
        return None
    if has_warmup and has_anneal:
        if epoch <= warmup:
            return float(start) + (base - float(start)) * (epoch / warmup)
        frac = min(1.0, (epoch - warmup) / anneal)
        return float(base * (1 - frac) + float(final) * frac)
    if has_warmup:
        return float(float(start) + (base - float(start)) * min(1.0, epoch / warmup))
    frac = min(1.0, epoch / anneal)
    return float(base * (1 - frac) + float(final) * frac)


def epoch_lr_scale(config, epoch: int):
    """Optional late linear lr decay: constant ``learning_rate`` until
    ``lr_decay_start``, then linear to ``lr_final`` at ``num_epochs``. Returns
    the lr multiplier, or None when unconfigured."""
    final = config.get("lr_final")
    start = config.get("lr_decay_start")
    if final is None or start is None:
        return None
    if epoch <= start:
        return 1.0
    frac = min(1.0, (epoch - start) / max(1, config.num_epochs - start))
    lr = float(config.learning_rate)
    return (lr * (1 - frac) + float(final) * frac) / lr


def _stats_from_fused(spec: ModelSpec, fused) -> EvalStats:
    """EvalStats (without recon payloads) from an ``eval_epoch`` result."""
    n = max(float(fused["n"]), 1.0)
    return EvalStats(
        elbo=[float(fused["elbo_main"]), float(fused["elbo_aux"])],
        l1=float(fused["l1"]) / n,
        label_metrics={k: float(v) / n for k, v in fused["labels"].items()},
        recon={},
        labels={},
        observations=np.zeros(0),
    )


def run_training_epochs(
    *,
    spec: ModelSpec,
    state,
    train_epoch: Callable,
    eval_epoch: Callable,
    splits: Dict[str, Dict[str, np.ndarray]],
    config,
    rng: np.random.RandomState,
    eval_seed: int,
    select_best: Callable,  # (epoch, val_stats, train_stats, best, params, losses) -> best'
    on_epoch: Optional[Callable] = None,
    eval_train_stats: bool = True,
    eval_every: int = 1,
    checkpoint_every: int = 0,
    resume: bool = False,
    put_batch: Optional[Callable] = None,
    profile_dir: Optional[str] = None,
):
    """The shared epoch loop, epochs 0 .. ``config.num_epochs``.
    ``select_best`` is the dataset's best-model policy; it receives and
    returns a dict with at least {'params', 'epoch', 'criterion'}.

    Each epoch's shuffled minibatches are stacked on the host, moved to the
    device at once and stepped through by ``train_epoch``
    (``svi.make_train_step``). The per-epoch statistics, the selection
    criterion included, come from ``eval_epoch`` (``svi.make_eval_epoch``)
    over each split's stacked batches, built once and kept on the device.
    The eval seeds of an epoch depend only on (``eval_seed``, epoch).
    """
    if checkpoint_every or resume:
        raise NotImplementedError("periodic checkpoints and resume are not ported yet (ROADMAP A10-rest)")
    if profile_dir:
        raise NotImplementedError("the profiler trace of an epoch is not ported yet (ROADMAP A17)")
    if on_epoch is not None and config.get("plot_epoch") and config.get("plot", True):
        raise NotImplementedError("plotting is not ported yet (ROADMAP A11-rest): pass --no-plot")
    device = tree_leaves(state.params)[0].device
    put = put_batch or (lambda b: device_batch(b, device))
    best = {"params": state.params, "epoch": 0, "criterion": np.inf}
    batch_size = config.mini_batch_size
    t_start = time.time()
    eval_stacks: Dict[str, Dict] = {}  # eval order is never shuffled: built once per split

    def split_stats(params, seed, name: str, is_post: bool) -> EvalStats:
        if name not in eval_stacks:
            eval_stacks[name] = put(stacked_minibatches(splits[name], batch_size, shuffle=False))
        return _stats_from_fused(spec, eval_epoch(params, seed, eval_stacks[name], is_post))

    for epoch in range(config.num_epochs + 1):
        aux_mult = epoch_aux_mult(config, epoch)
        batches = stacked_minibatches(splits["train"], batch_size, shuffle=True, rng=rng)
        n_batches = batches["mask"].shape[0]
        if aux_mult is not None:
            batches["aux_mult"] = np.full((n_batches,), aux_mult, np.float32)
        lr_sc = epoch_lr_scale(config, epoch)
        if lr_sc is not None:
            batches["lr_scale"] = np.full((n_batches,), lr_sc, np.float32)
        state, mets = train_epoch(state, put(batches))
        epoch_losses = torch.stack([mets["loss_main"], mets["loss_aux"]], dim=1).cpu().tolist()

        if eval_every > 1 and epoch % eval_every and epoch != config.num_epochs:
            epoch_mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
            line = "[Epoch %d/%d] loss= %.4f  [%.1fs]" % (
                epoch, config.num_epochs, epoch_mean_loss, time.time() - t_start
            )
            print(line)
            log.debug(line)
            continue

        k1, k2, k3, k4 = (fold_seed(eval_seed, epoch, name) for name in
                          ("val_post", "val_prior", "train_post", "train_prior"))
        val_post = split_stats(state.params, k1, "val", True)
        val_prior = split_stats(state.params, k2, "val", False)
        if eval_train_stats:
            train_post = split_stats(state.params, k3, "train", True)
            train_prior = split_stats(state.params, k4, "train", False)
        else:
            train_post = train_prior = val_post

        prev_best = best
        # state.params is replaced, never updated in place, by each step, so
        # the best model's reference needs no copy
        best = select_best(
            epoch,
            {"post": val_post, "prior": val_prior},
            {"post": train_post, "prior": train_prior},
            best,
            state.params,
            epoch_losses,
        )
        improved = "*" if best is not prev_best else ""

        epoch_mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
        metric_str = " ".join(
            "%s=(%.4f,%.4f)" % (name, train_post.label_metrics[name], val_post.label_metrics[name])
            for name in train_post.label_metrics
        )
        line = "[Epoch %d/%d] loss= %.4f  %s l1=(%.6f,%.6f) %s  [%.1fs]" % (
            epoch,
            config.num_epochs,
            epoch_mean_loss,
            metric_str,
            train_post.l1,
            val_post.l1,
            improved,
            time.time() - t_start,
        )
        print(line)
        log.debug(line)

        if on_epoch is not None:
            on_epoch(epoch, state, val_post, val_prior, train_post, train_prior)

    return state, best


def final_test_eval(spec: ModelSpec, best_params, seed: int, split, eval_fns, batch_size: int):
    post = eval_split(spec, best_params, fold_seed(seed, "post"), split, eval_fns, batch_size, is_post=True)
    prior = eval_split(spec, best_params, fold_seed(seed, "prior"), split, eval_fns, batch_size, is_post=False)
    return post, prior
