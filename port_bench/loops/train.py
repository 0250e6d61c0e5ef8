"""Traffic loop ``train``: the training driver's epochs, one model.

Set-up makes the splits, the weights and the driver's shuffle stream from
the seed, builds the program's training step, eval epoch and state as the
CLI driver does (``train/backend.py::make_training_backend``,
``train/svi.py::make_eval_epoch``). A throwaway copy of the state takes
the step graph's eager first call and its capture, and the eval graph's
the same, so that every step and eval epoch compared is a replay. Then the
state is driven through its first ``followed_steps`` dual steps with the
window's own call, ``train_epoch``, on minibatches whose rows all differ
(the first step on its own, so its Adam moments can be read), and the eval
epoch of the state they leave is read. A first run of the driver
(``train/driver.py::run_training_epochs``) over two epochs captures every
other graph the window replays. The warm-up, the window and a traced run's
profiled epochs are then one call of the driver, with the mix's selection policy, ``eval_every`` and
``eval_train_stats``: the warm-up's epochs run until their rate has settled
(``common.WarmUp``), the window opens at that epoch's end and closes at the
first epoch end past ``--seconds``; its epoch lines go to a file.

Afterwards the reference follows the same steps from the same weights and
batches, and works out one eval epoch of the state they leave.

The followed steps take epoch 0's aux multiplier and lr scale where the
configuration sets a schedule, as the driver feeds its epoch 0.

Mix keys: ``selection`` (one of :data:`SELECTIONS`),
``eval_every``, ``eval_train_stats``, ``followed_steps``, ``trace_epochs``
(the epochs a traced run profiles after its window), and the warm-up's
``warm_block_s``, ``warm_agree`` and ``warm_max_s`` (``common.WarmUp``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from port_bench import trace, weights
from port_bench.counts.model_flops import per_trajectory
from port_bench.loops import common
from port_bench.reference import compare, control
from port_bench.reference import train as reference
from port_bench.reference.model import Model


class _WindowClosed(Exception):
    pass


# the training drivers' selection policies: an epoch's criterion from its
# val posterior statistics and its losses, and whether a tie improves
SELECTIONS = {
    "cvs": (lambda val, losses: sum(val["post"].elbo) * len(val["post"].elbo), True),  # training_cvs.py
    "proc": (lambda val, losses: sum(val["post"].elbo), False),  # training_proc.py
    "challenge": (lambda val, losses: float(np.mean(losses)) if losses else np.inf, False),  # training_challenge.py
}


def _selector(policy: str, failed: list):
    if policy not in SELECTIONS:
        raise ValueError(f"unknown selection {policy!r}; one of {sorted(SELECTIONS)}")
    criterion, ties = SELECTIONS[policy]

    def select(epoch, val, train_s, best, params_now, epoch_losses):
        if not np.all(np.isfinite(epoch_losses)):
            failed.append(epoch)
        crit = criterion(val, epoch_losses)
        better = best["criterion"] >= crit if ties else crit < best["criterion"]
        return {"params": params_now, "epoch": epoch, "criterion": crit} if better else best

    return select


def _rows(split, perm: np.ndarray, batch: int, steps: int, fills):
    """``steps`` full minibatches of ``split`` in the order ``perm``, stacked
    as the driver stacks an epoch: (steps, batch, ...) with mask and
    sample_id, and a step's entry for each of ``fills`` (name -> value)."""
    sel = perm[:steps * batch]
    out = {k: v[sel].reshape((steps, batch) + v.shape[1:]) for k, v in split.items()}
    out["mask"] = np.ones((steps, batch), np.float32)
    out["sample_id"] = sel.astype(np.int32).reshape(steps, batch)
    for name, value in fills.items():
        out[name] = np.full((steps,), value, np.float32)
    return out


def _in_order(split, batch: int):
    """The split in its order as whole minibatches, the last padded with
    row 0 and masked out (how the driver stacks an eval split)."""
    n = len(split["observations"])
    nb = -(-n // batch)
    sel = np.concatenate([np.arange(n), np.zeros(nb * batch - n, dtype=int)])
    out = {k: v[sel].reshape((nb, batch) + v.shape[1:]) for k, v in split.items()}
    out["mask"] = (np.arange(nb * batch) < n).astype(np.float32).reshape(nb, batch)
    out["sample_id"] = sel.astype(np.int32).reshape(nb, batch)
    return out


def run(run) -> None:
    from structured_latent_odes_tpu_torch.train.backend import make_training_backend
    from structured_latent_odes_tpu_torch.train.driver import epoch_aux_mult, epoch_lr_scale, run_training_epochs
    from structured_latent_odes_tpu_torch.train.svi import make_eval_epoch, own_state
    from structured_latent_odes_tpu_torch.utils.device import full_fp32

    mix, device = run.traffic, run.device
    failed: list = []
    select = _selector(mix["selection"], failed)
    log = open(run.log_path("epochs"), "w")
    with log, contextlib.redirect_stdout(log):
        run.mark("imports")
        full_fp32(deterministic=True)
        splits, times = common.splits(run, device)
        run.mark("data")
        config = common.port_config(run.cfg)
        config.plot = False  # as the CLI's --no-plot: the card's machine has no matplotlib
        n_time, batch = len(times), int(config.mini_batch_size)
        spec = common.port_spec(run.cfg, config, n_time)
        ts = torch.as_tensor(times, device=device)
        flat = weights.make(run.cfg, n_time, run.seed_for("weights"), device)
        init_state, train_epoch, put, reduce = make_training_backend(spec, ts, config, weights.to_tree(flat))
        eval_epoch = make_eval_epoch(spec, ts, reduce=reduce)
        train_seed, eval_seed, check_seed = (run.seed_for(t) for t in ("train", "eval", "eval_check"))
        state = init_state(weights.to_tree(flat), train_seed)
        rng = np.random.RandomState(run.seed_for("shuffle") & 0xFFFFFFFF)
        run.mark("weights and program")

        # the first steps, followed by the reference afterwards; a throwaway
        # state takes the graphs' eager first calls and captures first
        k = int(mix["followed_steps"])
        fills = {n: v for n, v in (("aux_mult", epoch_aux_mult(config, 0)), ("lr_scale", epoch_lr_scale(config, 0)))
                 if v is not None}
        rows = _rows(splits["train"], rng.permutation(len(splits["train"]["observations"])), batch, k, fills)
        val_rows = _in_order(splits["val"], batch)
        val_stack = put(val_rows)
        scratch = init_state(weights.to_tree(flat), train_seed)
        train_epoch(scratch, put({n: v[:2] for n, v in rows.items()}))
        for _ in range(2):
            eval_epoch(scratch.params, check_seed, val_stack, True)
        del scratch
        run.mark("step and eval graphs captured")
        state, mets1 = train_epoch(state, put({n: v[:1] for n, v in rows.items()}))
        first_moments = compare.flatten(own_state(state).opt.mu)
        state, mets = train_epoch(state, put({n: v[1:] for n, v in rows.items()}))
        followed = own_state(state)
        losses = [[float(mets1["loss_main"][0]), float(mets1["loss_aux"][0])]] + [
            [float(a), float(b)] for a, b in zip(mets["loss_main"], mets["loss_aux"])]
        stats = {k_: float(v) for k_, v in eval_epoch(followed.params, check_seed, val_stack, True).items()
                 if k_ != "labels"}
        run.mark("followed steps and eval check")

        driver = dict(spec=spec, train_epoch=train_epoch, eval_epoch=eval_epoch, splits=splits, rng=rng,
                      eval_seed=eval_seed, select_best=select, eval_train_stats=bool(mix["eval_train_stats"]),
                      eval_every=int(mix["eval_every"]), put_batch=put)
        # two epochs capture every graph of the window
        config.num_epochs = 1
        state, _ = run_training_epochs(state=state, config=config, **driver)
        run.mark("two epochs (captures)")

        config.num_epochs = int(run.cfg["config"]["num_epochs"])
        n_train = len(splits["train"]["observations"])
        steps_per_epoch = -(-n_train // batch)
        n_eval = len(splits["val"]["observations"]) + (n_train if mix["eval_train_stats"] else 0)
        flops = per_trajectory(run.cfg, n_time)

        # one call of the driver: its epochs warm up until their rate has
        # settled, then the window, then (traced) the profiled epochs
        warm, profiling = common.WarmUp(mix), contextlib.ExitStack()
        at = {"phase": "warm", "epochs": 0, "t0": 0.0, "traced": None}

        def on_epoch(*_):
            now = time.perf_counter()
            if at["phase"] == "warm":
                if warm.settled(1):
                    run.mark("warm-up (epochs/s " + " ".join(f"{r:.4g}" for r in warm.rates) + ")")
                    failed.clear()
                    at.update(phase="window", t0=now)
                    run.setup_s, run.ticks = now - run.t0, [now]
                return
            at["epochs"] += 1
            if at["phase"] == "window":
                run.ticks.append(now)
                if now - at["t0"] < run.seconds:
                    return
                run.window_s, run.attempted, run.failed = now - at["t0"], at["epochs"], len(failed)
                if not run.trace:
                    raise _WindowClosed
                at.update(phase="trace", epochs=0, traced=profiling.enter_context(trace.profiled(device)))
            elif at["epochs"] >= int(mix["trace_epochs"]):
                raise _WindowClosed

        with contextlib.suppress(_WindowClosed):
            run_training_epochs(state=state, config=config, on_epoch=on_epoch, **driver)
        profiling.close()
        e = run.attempted
        run.work = {"epochs": e, "steps": e * steps_per_epoch, "trajectories": e * n_train,
                    "model_flops": e * (n_train * flops["dual_step"] + 2 * n_eval * flops["eval"]),
                    "ode_shapes": common.ode_shapes(run.cfg, n_time, batch)}
        if at["traced"] is not None:
            run.trace_summary = at["traced"].summary
            run.traced_work = {"epochs": at["epochs"], "steps": at["epochs"] * steps_per_epoch}

    del state, driver, train_epoch, eval_epoch, init_state, val_stack
    run.memory_peak_bytes = common.peak_and_free(device)

    model = Model(run.cfg)
    ref_batches = [{n: torch.as_tensor(v[i], device=device) for n, v in rows.items()} for i in range(k)]
    eval_batches = [{n: torch.as_tensor(v[i], device=device) for n, v in val_rows.items()}
                    for i in range(len(val_rows["mask"]))]

    def follow(batches, flips=frozenset()):
        return reference.follow(model, flat, train_seed, batches, ts, check_seed, eval_batches, flips)

    def judged(side):
        return compare.nearest_training_gaps(side, lambda flips: follow(ref_batches, flips), flat)

    prog = {"losses": sum(losses, []), "first_moments": first_moments, "params": compare.flatten(followed.params),
            "stats": [stats[s] for s in ("elbo_main", "elbo_aux", "l1")]}
    run.checks, ref = judged(prog)
    if run.readings is not None:
        run.readings["undecided"] = sorted(d for *_, d in ref["near"])
        with control.tf32():
            ctl = follow(ref_batches)
        run.readings["control"] = judged(ctl)[0]
        run.readings["half_batch"] = judged(follow(control.half_batch(ref_batches)))[0]
