"""The reference's training: the dual-loss SVI step with one Adam shared by
both losses, as the reference repo steps ``svi.step`` and ``svi_aux.step``
against one ``pyro.optim.Adam`` (one ``torch.optim.Adam`` per parameter,
stepping only the parameters that received a gradient from that loss, with
its own step count), and the per-split evaluation statistics.

A step of member s at step k draws with the seeds that the program
documents: ``fold_seed(fold_seed(fold_seed(seed, k), loss), 0)`` for the
main and the aux loss's one particle.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
import torch

from port_bench.reference.model import Model
from port_bench.reference.sampler import fold_seed, normal

Tensor = torch.Tensor
B1, B2, EPS = 0.9, 0.999, 1e-8


def masks(model: Model, params: Dict[str, Tensor]):
    """The leaves each loss steps: the main loss the encoder, the decoder
    and the priors (and the label heads where the model scores them), the
    aux loss the encoder and the label heads."""
    def group(path):
        return path.split("/")[0]

    main = {k: group(k) in ("encoder", "decoder", "priors") or (model.aux_in_model and group(k) in ("aux", "aux_std"))
            for k in params}
    aux = {k: group(k) in ("encoder", "aux", "aux_std") for k in params}
    return main, aux


def _correction(b: float, count: int) -> float:
    return float(np.float32(1.0) - np.power(np.float32(b), np.float32(count)))


class Adam:
    """Per-leaf moments and step counts; an update steps the leaves of its
    mask."""

    def __init__(self, params: Dict[str, Tensor], lr: float):
        self.lr = lr
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = {k: 0 for k in params}

    def update(self, params, grads, mask):
        out = dict(params)
        for k, step in mask.items():
            if not step:
                continue
            self.count[k] += 1
            g = grads[k]
            self.m[k] = B1 * self.m[k] + (1.0 - B1) * g
            self.v[k] = B2 * self.v[k] + (1.0 - B2) * g * g
            m_hat = self.m[k] / _correction(B1, self.count[k])
            v_hat = self.v[k] / _correction(B2, self.count[k])
            out[k] = params[k] - self.lr * m_hat / (torch.sqrt(v_hat) + EPS)
        return out


def _grad(loss_fn, params):
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = loss_fn(live)
    grads = torch.autograd.grad(loss, list(live.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g for (k, v), g in zip(live.items(), grads)}


def dual_steps(model: Model, params: Dict[str, Tensor], seed: int, first_step: int, batches: List[Dict],
               ts: Tensor, flips=frozenset()):
    """The dual steps of one member from ``params`` over ``batches`` (one a
    step). Returns, per step, the two losses over the batch's count; the
    first moments after the first step; and the params after the last.
    ``flips``: the round-off decisions taken the other way, as (("step",
    i), band, element) for a quantile band and (("step", i), site, element)
    for a ReLU gate."""
    main_mask, aux_mask = masks(model, params)
    adam = Adam(params, model.lr)
    losses, first_moments = [], None
    for i, batch in enumerate(batches):
        step_seed = fold_seed(seed, first_step + i)
        s_main, s_aux = fold_seed(fold_seed(step_seed, "main"), 0), fold_seed(fold_seed(step_seed, "aux"), 0)
        n = torch.clamp(batch["mask"].sum(), min=1.0)
        mine = [(b, e) for tag, b, e in flips if tag == ("step", i)]
        lm, g = _grad(lambda p: model.elbo_main(p, s_main, batch, ts, ("step", i), mine), params)
        params = adam.update(params, g, main_mask)
        la, g = _grad(lambda p: model.elbo_aux(p, s_aux, batch), params)
        params = adam.update(params, g, aux_mask)
        losses.append([float(lm / n), float(la / n)])
        if i == 0:
            first_moments = {k: v.clone() for k, v in adam.m.items()}
    return {"losses": losses, "first_moments": first_moments, "params": {k: v.detach() for k, v in params.items()}}


def follow(model: Model, init: Dict[str, Tensor], seed: int, batches: List[Dict], ts: Tensor,
           eval_seed=None, eval_batches=None, flips=frozenset()):
    """:func:`dual_steps` from step 0, its losses as one list, and with
    ``eval_batches`` the statistics of an eval epoch of the params they
    leave (``elbo_main``, ``elbo_aux``, ``l1``); ``near``, the decisions
    within round-off's reach (``Model.elbo_main``: quantile bands and ReLU
    gates)."""
    model.near = []
    out = dual_steps(model, init, seed, 0, batches, ts, flips)
    out["losses"] = sum(out["losses"], [])
    if eval_batches is not None:
        stats = eval_stats(model, out["params"], eval_seed, eval_batches, ts, flips)
        out["stats"] = [stats[k] for k in ("elbo_main", "elbo_aux", "l1")]
    out["near"] = model.near
    return out


def undecided(near, cap: int = 4):
    """Every way to take the ``cap`` nearest of the decisions ``near`` the
    other way: the non-empty sets of (tag, band or site, element)."""
    nearest = [(tag, band, e) for tag, band, e, _ in sorted(near, key=lambda x: x[3])[:cap]]
    for r in range(1, len(nearest) + 1):
        yield from (frozenset(c) for c in itertools.combinations(nearest, r))


@torch.no_grad()
def eval_stats(model: Model, params, seed: int, batches: List[Dict], ts: Tensor, flips=frozenset()):
    """A split's statistics under the eval seeds of ``seed`` (losses, recon,
    classifier): the per-batch ELBOs over each batch's count, summed, and
    the posterior recon's mean absolute error, summed over the batches."""
    s_loss, s_recon = fold_seed(seed, "losses"), fold_seed(seed, "recon")
    out = {"elbo_main": 0.0, "elbo_aux": 0.0, "l1": 0.0}
    for j, batch in enumerate(batches):
        m = batch["mask"]
        n = torch.clamp(m.sum(), min=1.0)
        mine = [(b, e) for tag, b, e in flips if tag == ("eval", j)]
        out["elbo_main"] += float(model.elbo_main(params, fold_seed(s_loss, "main"), batch, ts, ("eval", j), mine) / n)
        out["elbo_aux"] += float(model.elbo_aux(params, fold_seed(s_loss, "aux"), batch) / n)
        loc, scale = model.encode(params, batch["observations"])
        z = normal(s_recon, "posterior", batch["sample_id"], loc, scale)
        mu_50 = model.decode(params, z, ts)[2]
        err = torch.abs(mu_50 - batch["observations"]) * m[:, None, None]
        den = torch.clamp(m.sum() * err.shape[1] * err.shape[2], min=1.0)
        out["l1"] += float(err.sum() / den)
    return out
