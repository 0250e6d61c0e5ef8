"""Traffic loop ``sweep``: a seed sweep of ``members`` models stacked on one
card, on shared data.

Set-up makes the splits, every member's weights (one call for all), train
and eval seeds and shuffles from the seed, and builds the stacked run as
the sweep does (``sweep.py::prepare_run``: the ensemble runner and its
inputs); the inputs go to the device once. A throwaway copy of the
stacked state takes the step graph's eager first call and its capture, so
that every step compared is a replay; then the stacked state is driven
through its first ``followed_steps`` dual steps with the runner's own
epoch, ``runner.train_epoch``, on minibatches whose rows all differ (the
first step on its own). A first chunk of two epochs captures every other
graph, and chunks run on until their rate has settled (``common.WarmUp``).
The window is ``runner.run_chunk`` over chunks of ``chunk_epochs`` epochs
(each epoch: the stacked dual steps, the members' val ELBO, the selection
with its one host sync), what ``run_chunked`` and ``sweep.py::_train_group``
do, until the first chunk end past ``--seconds``.

Afterwards the reference follows each member through the same steps.

Each member's per-epoch aux multiplier and lr scale are the schedules of
the configuration's ``config`` section, as ``sweep.py::prepare_member``
makes them (constant where it sets no schedule keys), over the first
``perm_epochs`` epochs and cycled with the shuffles; the followed steps take
epoch 0's values.

Mix keys: ``members``, ``policy`` (the runner's selection policy, one of
:data:`POLICIES`), ``chunk_epochs``, ``perm_epochs`` (the shuffles drawn in
set-up, cycled), ``followed_steps``, ``trace_epochs``, and the warm-up's
``warm_block_s``, ``warm_agree`` and ``warm_max_s``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import trace, weights
from port_bench.counts.model_flops import per_trajectory
from port_bench.loops import common
from port_bench.loops.train import _in_order
from port_bench.reference import compare, control
from port_bench.reference import train as reference
from port_bench.reference.model import Model

# the runner's selection policies (``train/ensemble.py``) that a mix may
# name, and whether each reads the members' val ELBO every epoch
POLICIES = {"cvs": True, "proc": True, "challenge": False}


def _perms(n: int, batch: int, epochs: int, rng: np.random.RandomState) -> np.ndarray:
    """(epochs, n_batches, batch) shuffles, each padded with row 0."""
    nb = -(-n // batch)
    out = np.zeros((epochs, nb * batch), np.int64)
    for e in range(epochs):
        out[e, :n] = rng.permutation(n)
    return out.reshape(epochs, nb, batch)


def members_of(run, config, spec, splits, times, device):
    """Every member's inputs, as ``sweep.py::prepare_member`` makes them, from
    the run's seed: the weights of all members (one flat dict, a leading
    member axis), the members' records for ``prepare_run`` (each with its
    ``first`` minibatches, which the reference follows), and the mask."""
    from structured_latent_odes_tpu_torch.train.ensemble import aux_mult_schedule, lr_scale_schedule

    mix, cfg = run.traffic, run.cfg
    S, E, k = int(mix["members"]), int(mix["perm_epochs"]), int(mix["followed_steps"])
    batch = int(config.mini_batch_size)
    flat = weights.make(cfg, len(times), run.seed_for("weights"), device, members=S)
    n_train = len(splits["train"]["observations"])
    nb = -(-n_train // batch)
    mask = (np.arange(nb * batch) < n_train).astype(np.float32).reshape(nb, batch)
    val_stack = _in_order(splits["val"], batch) if POLICIES[mix["policy"]] else None
    aux_mult, lr_sched = aux_mult_schedule(config, E - 1), lr_scale_schedule(config, E - 1)
    members = []
    for m in range(S):
        rng = np.random.RandomState(run.seed_for(f"shuffle{m}") & 0xFFFFFFFF)
        members.append({
            "config": config, "splits": {"train": splits["train"]}, "val_stack": val_stack, "spec": spec,
            "times": times, "params": weights.to_tree({p: v[m] for p, v in flat.items()}), "policy": mix["policy"],
            "train_seed": run.seed_for(f"train{m}"), "eval_seed": run.seed_for(f"eval{m}"),
            "first": rng.permutation(n_train)[:k * batch].reshape(k, batch),
            "perms": _perms(n_train, batch, E, rng), "mask": mask,
            "aux_mult": aux_mult, "lr_sched": lr_sched, "refit_perms": None,
        })
    return flat, members, mask


def follow_first(run, runner, state, first, train, fills):
    """The stacked state's first steps with the runner's own epoch, on the
    minibatches ``first`` ((S, k, B) row indices of ``train``), the first step
    on its own, once a throwaway copy of the state has taken the step graph's
    eager first call and its capture. Returns the state after them (over the graph's buffers), and
    the program's side of the comparison: the steps' losses (S, k, 2), the
    first moments after step 1 and the params after the last (own copies)."""
    from structured_latent_odes_tpu_torch.train.svi import own_state

    def rows(j: slice):
        p = first[:, j]
        return {**{n: v[p] for n, v in train.items()}, "sample_id": p}

    ones = torch.ones(first.shape[1:], device=first.device)
    runner.train_epoch(own_state(state), rows(slice(0, 2)), ones[:2], fills)
    run.mark("step graph captured")
    state, mets1 = runner.train_epoch(state, rows(slice(0, 1)), ones[:1], fills)
    moments = own_state(state).opt.mu
    run.mark("first step")
    state, mets = runner.train_epoch(state, rows(slice(1, None)), ones[1:], fills)
    losses = torch.cat([torch.stack([mets1["loss_main"][0], mets1["loss_aux"][0]], -1)[:, None],
                        torch.stack([mets["loss_main"], mets["loss_aux"]], -1).transpose(0, 1)], 1)
    return state, {"losses": losses.cpu(), "first_moments": compare.flatten(moments),
                   "params": compare.flatten(own_state(state).params)}


def member_checks(run, flat, members, first, train, times, prog, device):
    """The reference follows every member's first steps; each number is the
    worst member's. ``prog`` is :func:`follow_first`'s side (a member it lacks
    reads as a failed comparison). Fills ``run.checks`` and, where asked,
    ``run.readings``."""
    model = Model(run.cfg)
    ts = torch.as_tensor(times, device=device)
    readings = run.readings is not None
    sides = {"checks": {}, "control": {}, "half_batch": {}}
    if len(prog["losses"]) != len(members):
        run.checks = {n: float("inf") for n in ("loss_gap", "grad_gap", "change_gap", "change_gap_worst")}
        return
    for m, member in enumerate(members):
        init = {p: v[m] for p, v in flat.items()}
        idx = torch.as_tensor(first[m], device=device)
        batches = [{**{n: v[idx[i]] for n, v in train.items()}, "sample_id": idx[i],
                    "mask": torch.ones(idx.shape[1], device=device)} for i in range(idx.shape[0])]

        def follow(b, flips=frozenset()):
            return reference.follow(model, init, member["train_seed"], b, ts, flips=flips)

        def judged(side):
            return compare.nearest_training_gaps(side, lambda flips: follow(batches, flips), init)

        mine = {"losses": prog["losses"][m].reshape(-1).tolist(),
                "first_moments": {p: v[m] for p, v in prog["first_moments"].items()},
                "params": {p: v[m] for p, v in prog["params"].items()}}
        gaps, ref = judged(mine)
        one = {"checks": gaps}
        if readings:
            keep = compare.moving_leaves(ref["first_moments"])
            run.readings.setdefault("worst_change", []).append([m] + compare.worst_leaves(
                {p: mine["params"][p] - init[p] for p in keep}, {p: ref["params"][p] - init[p] for p in keep}))
            run.readings.setdefault("undecided", []).extend(d for *_, d in ref["near"])
            with control.tf32():
                ctl = follow(batches)
            one["control"] = judged(ctl)[0]
            one["half_batch"] = judged(follow(control.half_batch(batches)))[0]
        for side, g in one.items():  # the worst member
            for name, v in g.items():
                sides[side][name] = max(sides[side].get(name, 0.0), v)
    run.checks = sides.pop("checks")
    if readings:
        run.readings.update(sides)


def run(run) -> None:
    from structured_latent_odes_tpu_torch.sweep import prepare_run
    from structured_latent_odes_tpu_torch.utils.device import full_fp32

    mix, device, cfg = run.traffic, run.device, run.cfg
    if mix["policy"] not in POLICIES:
        raise ValueError(f"unknown policy {mix['policy']!r}; one of {sorted(POLICIES)}")
    run.mark("imports")
    full_fp32(deterministic=True)
    splits, times = common.splits(run, device)
    run.mark("data")
    config = common.port_config(cfg)
    n_time, batch = len(times), int(config.mini_batch_size)
    spec = common.port_spec(cfg, config, n_time)
    S, E = int(mix["members"]), int(mix["perm_epochs"])
    flat, members, mask = members_of(run, config, spec, splits, times, device)
    n_train, nb = len(splits["train"]["observations"]), mask.shape[0]
    run.mark("members' inputs")
    runner, inputs, shared = prepare_run(members, device=device)
    if not shared:
        raise ValueError("the sweep's members must share their data")
    run.mark("prepare_run")
    on = {k_: None if inputs[k_] is None else {n: torch.as_tensor(v, device=device) for n, v in inputs[k_].items()}
          for k_ in ("train_splits", "val_stacks")}
    perms = torch.as_tensor(inputs["perms"], device=device)
    mask_t = torch.as_tensor(mask, device=device)
    aux_mult, lr_sched = inputs["aux_mult"], inputs["lr_sched"]
    fills = {"aux_mult": float(aux_mult[0, 0])}  # epoch 0's, as run_chunk fills them
    if lr_sched is not None:
        fills["lr_scale"] = float(lr_sched[0, 0])
    first = np.stack([m["first"] for m in members])
    state, prog = follow_first(run, runner, inputs["states"], torch.as_tensor(first, device=device),
                               on["train_splits"], fills)
    run.mark("followed steps")

    def chunk(carry, start: int, n: int):
        idx = [(start + j) % E for j in range(n)]
        return runner.run_chunk(carry, on["train_splits"], on["val_stacks"], perms[:, idx], mask_t,
                                aux_mult[:, idx], None if lr_sched is None else lr_sched[:, idx],
                                range(start, start + n))

    carry, _ = chunk(runner.init_carry(state, inputs["eval_seeds"]), 0, 2)  # captures every graph
    run.mark("two epochs (captures)")
    C = int(mix["chunk_epochs"])
    epoch, warm = 2, common.WarmUp(mix)
    while True:  # until the chunks' rate has settled
        carry, _ = chunk(carry, epoch, C)
        epoch += C
        if warm.settled(C):
            break
    run.mark("warm-up (epochs/s " + " ".join(f"{r:.4g}" for r in warm.rates) + ")")
    start = epoch
    flops = per_trajectory(cfg, n_time)
    n_val = len(splits["val"]["observations"]) if POLICIES[mix["policy"]] else 0
    failed = 0
    t0 = time.perf_counter()
    run.setup_s = t0 - run.t0
    run.ticks = [t0]
    while time.perf_counter() - t0 < run.seconds:
        carry, hist = chunk(carry, epoch, C)
        run.ticks.append(time.perf_counter())
        failed += int(np.sum(~np.isfinite(hist["loss_main"]).all(axis=(0, 2))))
        epoch += C
    run.window_s = time.perf_counter() - t0
    e = epoch - start
    run.attempted, run.failed = e, failed
    run.work = {"epochs": e, "steps": e * nb, "trajectories": e * S * n_train,
                "model_flops": e * S * (n_train * flops["dual_step"] + n_val * (flops["main"] + flops["aux"])),
                "ode_shapes": common.ode_shapes(cfg, n_time, batch, S)}

    if run.trace:
        n = int(mix["trace_epochs"])
        with trace.profiled(device) as traced:
            carry, _ = chunk(carry, epoch, n)
        run.trace_summary = traced.summary
        run.traced_work = {"epochs": n, "steps": n * nb}

    del carry, state, runner, inputs
    run.memory_peak_bytes = common.peak_and_free(device)
    member_checks(run, flat, members, first, on["train_splits"], times, prog, device)
