"""The epoch loop shared by the dataset drivers (the JAX package's
``train/driver.py``): per-minibatch dual SVI steps, per-epoch evaluation of
the val and train splits under posterior and prior reconstruction (the
reference's ``input_pred_stats``), a dataset's best-model policy, periodic
checkpoints and batch-exact resume, a profiler trace of one epoch, the
recon-collecting evaluation of the epochs that plot, and the final test
evaluation.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from structured_latent_odes_tpu_torch.data.loader import iter_minibatches, stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_from_jax, params_to_jax
from structured_latent_odes_tpu_torch.models.spec import ModelSpec
from structured_latent_odes_tpu_torch.parallel.launch import is_writer
from structured_latent_odes_tpu_torch.prob import fold_seed
from structured_latent_odes_tpu_torch.train import checkpoint as ckpt
from structured_latent_odes_tpu_torch.train import metrics as M
from structured_latent_odes_tpu_torch.train.svi import SVIState, eval_seeds, own_state
from structured_latent_odes_tpu_torch.utils.profiling import span, trace
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves, tree_map

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


def plots_due(config, epoch: int) -> bool:
    """Whether ``epoch``'s plots are drawn: plotting on (``config.plot``)
    and ``epoch`` a multiple of ``config.plot_epoch``."""
    return bool(config.get("plot", True) and config.get("plot_epoch") and epoch % config.plot_epoch == 0)


def read_epoch(mets, evals) -> Tuple[List[List[float]], List[EvalStats]]:
    """The epoch's one read, made once everything it reads is queued: the
    per-step losses of ``train_epoch``'s metrics ``mets`` and, of each
    ``eval_epoch`` result in ``evals``, n, the two ELBOs, the L1 sum and
    each label's sum, cast to float64 (exact for float32 and for counts)
    and copied to the host together. Returns the losses, ``[main, aux]`` a
    step, and an EvalStats (without recon payloads) a result, whose label
    metrics keep the result's order of labels."""
    with span("wait.epoch"):
        losses = torch.stack([mets["loss_main"], mets["loss_aux"]], dim=1)
        parts = [losses] + [t for fused in evals for t in (fused["n"], fused["elbo_main"], fused["elbo_aux"],
                                                           fused["l1"], *fused["labels"].values())]
        host = torch.cat([t.reshape(-1).to(torch.float64) for t in parts]).cpu().tolist()
    epoch_losses = [host[i:i + 2] for i in range(0, losses.numel(), 2)]
    stats, at = [], losses.numel()
    for fused in evals:
        n, elbo_main, elbo_aux, l1 = host[at:at + 4]
        sums = host[at + 4:at + 4 + len(fused["labels"])]
        at += 4 + len(sums)
        n = max(n, 1.0)
        stats.append(EvalStats(elbo=[elbo_main, elbo_aux], l1=l1 / n,
                               label_metrics={k: v / n for k, v in zip(fused["labels"], sums)},
                               recon={}, labels={}, observations=np.zeros(0)))
    return epoch_losses, stats


def run_training_epochs(
    *,
    spec: ModelSpec,
    state: SVIState,
    train_epoch: Callable,
    eval_epoch: Callable,
    splits: Dict[str, Dict[str, np.ndarray]],
    config,
    rng: np.random.RandomState,
    eval_seed: int,
    select_best: Callable,  # (epoch, val_stats, train_stats, best, params, losses) -> best'
    on_epoch: Optional[Callable] = None,
    eval_fns=None,
    eval_train_stats: bool = True,
    eval_every: int = 1,
    checkpoint_path: Optional[str] = None,
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

    On an epoch where ``on_epoch`` plots (:func:`plots_due`), the
    recon-collecting ``eval_split`` (with ``eval_fns``) runs over val with
    that epoch's seeds and its statistics go to ``on_epoch``; the selection
    criterion still comes from ``eval_epoch`` alone.

    Resume: with ``checkpoint_path`` and ``checkpoint_every``, the state
    (``SVIState.to_tree``: params, Adam slots and counts, seed, step), the
    best params and the host shuffle RNG are saved at every epoch that
    ``checkpoint_every`` divides, with the epoch, the best epoch and its
    criterion as metadata. With ``resume`` and the file present, they are
    restored and the loop continues at the saved epoch + 1; without the
    file it starts afresh. Every draw depends only on (seed, step, site,
    sample_id) and the eval seeds only on (eval seed, epoch), so a resumed
    run makes the uninterrupted run's shuffles, draws and updates, and
    leaves ``rng`` where that run would.

    With ``profile_dir``, epoch ``min(start + 1, config.num_epochs)`` (the
    second epoch run, or the only one) is traced (``utils/profiling.trace``),
    the whole of it, with its phases' spans.

    An epoch launches ``train_epoch`` and its eval epochs before the host
    reads anything of them, then reads the losses and the statistics in one
    copy (:func:`read_epoch`), so the card runs the epoch's work without
    draining between its phases.

    Each epoch is a span, ``entry.epoch`` (``utils/profiling.py``), and so
    is each of its phases: ``entry.batches`` (the shuffle and stacking),
    ``entry.put``, ``dispatch.train`` (``train_epoch``), per eval epoch
    ``dispatch.eval``, ``wait.epoch`` (the one read), ``entry.plot``,
    ``entry.select`` (the policy and the best params' copy),
    ``entry.checkpoint`` and ``entry.log`` (the epoch line and
    ``on_epoch``).

    On the ranks of a data- or time-parallel run (``train/backend.py``)
    every rank computes every step and statistic (``put_batch`` keeps its
    slice of each batch, and ``train_epoch`` and ``eval_epoch`` return the
    whole batches' numbers), every rank reads the checkpoint on resume, and
    rank 0 alone writes: the checkpoints, the epoch lines, the trace and
    what ``on_epoch`` draws.

    Where ``train_epoch`` replays a CUDA graph (its ``dispatch``, printed
    before the first epoch as ``epoch dispatch: ...``), the state it returns
    lives in the graph's buffers, which its next epoch overwrites: the best
    params are a copy, taken when they improve, and the state returned is
    the caller's own (``svi.own_state``).
    """
    writer = is_writer()
    device = tree_leaves(state.params)[0].device
    put = put_batch or (lambda b: device_batch(b, device))
    best = {"params": _copy(state.params), "epoch": 0, "criterion": np.inf}
    batch_size = config.mini_batch_size
    t_start = time.time()
    start_epoch = 0
    eval_stacks: Dict[str, Dict] = {}  # eval order is never shuffled: built once per split

    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        like = {"state": state.to_tree(), "best_params": params_to_jax(state.params),
                "host_rng": ckpt.host_rng_tree(rng)}
        restored = ckpt.restore(checkpoint_path, like)
        meta = ckpt.load_metadata(checkpoint_path)
        state = SVIState.from_tree(restored["state"], device)
        ckpt.apply_host_rng_tree(rng, restored["host_rng"])
        best = {"params": params_from_jax(restored["best_params"], device), "epoch": meta["best_epoch"],
                "criterion": meta["criterion"]}
        start_epoch = meta["epoch"] + 1
        print(f"resumed from {checkpoint_path} at epoch {start_epoch}")

    def split_eval(params, seed, name: str, is_post: bool):
        if name not in eval_stacks:
            eval_stacks[name] = put(stacked_minibatches(splits[name], batch_size, shuffle=False))
        return eval_epoch(params, seed, eval_stacks[name], is_post)

    def one_epoch(epoch: int, state: SVIState, best: Dict):
        with span("entry.batches"):
            aux_mult = epoch_aux_mult(config, epoch)
            batches = stacked_minibatches(splits["train"], batch_size, shuffle=True, rng=rng)
            n_batches = batches["mask"].shape[0]
            if aux_mult is not None:
                batches["aux_mult"] = np.full((n_batches,), aux_mult, np.float32)
            lr_sc = epoch_lr_scale(config, epoch)
            if lr_sc is not None:
                batches["lr_scale"] = np.full((n_batches,), lr_sc, np.float32)
        with span("entry.put"):
            batches = put(batches)
        state, mets = train_epoch(state, batches)

        if eval_every > 1 and epoch % eval_every and epoch != config.num_epochs:
            epoch_losses, _ = read_epoch(mets, [])
            with span("entry.log"):
                epoch_mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
                line = "[Epoch %d/%d] loss= %.4f  [%.1fs]" % (
                    epoch, config.num_epochs, epoch_mean_loss, time.time() - t_start
                )
                if writer:
                    print(line)
                    log.debug(line)
            return state, best

        k1, k2, k3, k4 = (fold_seed(eval_seed, epoch, name) for name in
                          ("val_post", "val_prior", "train_post", "train_prior"))
        evals = [split_eval(state.params, k1, "val", True), split_eval(state.params, k2, "val", False)]
        if eval_train_stats:
            evals += [split_eval(state.params, k3, "train", True), split_eval(state.params, k4, "train", False)]
        epoch_losses, stats = read_epoch(mets, evals)
        val_post, val_prior, *train_stats = stats
        train_post, train_prior = train_stats or (val_post, val_post)
        plot_post, plot_prior = val_post, val_prior
        if on_epoch is not None and plots_due(config, epoch):
            # the recon payloads the plots draw, with the seeds of the
            # statistics above; selection never reads them
            with span("entry.plot"):
                plot_post = eval_split(spec, state.params, k1, splits["val"], eval_fns, batch_size, is_post=True)
                plot_prior = eval_split(spec, state.params, k2, splits["val"], eval_fns, batch_size, is_post=False)

        with span("entry.select"):
            prev_best = best
            best = select_best(
                epoch,
                {"post": val_post, "prior": val_prior},
                {"post": train_post, "prior": train_prior},
                best,
                state.params,
                epoch_losses,
            )
            improved = "*" if best is not prev_best else ""
            if improved:
                # a graph's next epoch overwrites state.params in place
                best = dict(best, params=_copy(best["params"]))

        if writer and checkpoint_path and checkpoint_every and epoch % checkpoint_every == 0:
            with span("entry.checkpoint"):
                ckpt.save(
                    checkpoint_path,
                    {"state": state.to_tree(), "best_params": params_to_jax(best["params"]),
                     "host_rng": ckpt.host_rng_tree(rng)},
                    metadata={"epoch": epoch, "best_epoch": int(best["epoch"]),
                              "criterion": float(best["criterion"])},
                )

        with span("entry.log"):
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
            if writer:
                print(line)
                log.debug(line)
                if on_epoch is not None:
                    on_epoch(epoch, state, plot_post, plot_prior, train_post, train_prior)
        return state, best

    trace_epoch = min(start_epoch + 1, config.num_epochs) if profile_dir and writer else None
    if writer and getattr(train_epoch, "dispatch", None):
        print(f"epoch dispatch: {train_epoch.dispatch}")
    for epoch in range(start_epoch, config.num_epochs + 1):
        profiling = trace(profile_dir) if epoch == trace_epoch else contextlib.nullcontext()
        with profiling as traced, span("entry.epoch"):
            state, best = one_epoch(epoch, state, best)
        if epoch == trace_epoch:
            print(f"profiler trace of epoch {epoch}: {traced.path}")

    return own_state(state), best


def _copy(params):
    return tree_map(lambda t: t.detach().clone(), params)


def final_test_eval(spec: ModelSpec, best_params, seed: int, split, eval_fns, batch_size: int):
    post = eval_split(spec, best_params, fold_seed(seed, "post"), split, eval_fns, batch_size, is_post=True)
    prior = eval_split(spec, best_params, fold_seed(seed, "prior"), split, eval_fns, batch_size, is_post=False)
    return post, prior
