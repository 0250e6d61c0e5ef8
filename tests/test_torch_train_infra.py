"""The PyTorch port's training infrastructure against the JAX package: the
metrics and the ``.npy`` artifact contract (byte for byte), the aux-multiplier
and lr schedules, checkpoint metadata, seeding, and the epoch loop and
``eval_every`` (the port's own dual step and ``eval_split`` as the
reference), and the epoch's one read against reads of each number alone.
JAX stays on the CPU.
"""

import os
import re

import jax  # noqa: F401
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.train import artifacts as jax_artifacts
from structured_latent_odes_tpu.train import driver as jax_driver
from structured_latent_odes_tpu.train import metrics as jax_metrics
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.models import cvs_spec
from structured_latent_odes_tpu_torch.prob import fold_seed
from structured_latent_odes_tpu_torch.train import artifacts, checkpoint, driver, metrics, svi
from structured_latent_odes_tpu_torch.utils.rng import set_seed
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)


def test_metrics_match_jax():
    rng = np.random.RandomState(0)
    pred, target = (rng.rand(20, 3) > 0.5).astype(np.float32), (rng.rand(20, 3) > 0.5).astype(np.float32)
    assert metrics.accuracy(pred, target) == jax_metrics.accuracy(pred, target)
    assert metrics.accuracy(pred[:, 0], target[:, 0]) == jax_metrics.accuracy(pred[:, 0], target[:, 0])
    assert metrics.onehot_accuracy(pred, target) == jax_metrics.onehot_accuracy(pred, target)
    other = rng.rand(20, 3)
    assert metrics.mse(pred, other) == jax_metrics.mse(pred, other)


def test_artifacts_are_byte_equal_to_jax(tmp_path):
    rng = np.random.RandomState(1)
    obs, times = rng.rand(5, 3, 9).astype(np.float32), np.arange(9.0, dtype=np.float32)
    labels = {"iext": rng.rand(5).astype(np.float32), "rtpr": rng.rand(5).astype(np.float32)}
    recon = {k: rng.rand(5, 3, 9).astype(np.float32) for k in ("mu_50", "mu_75", "mu_25")}
    recon.update(solution_xt=rng.rand(5, 9, 5).astype(np.float32), z=rng.rand(5, 15).astype(np.float32))
    bands = [rng.rand(5, 3, 9, 4).astype(np.float32) for _ in range(3)]
    for mod, name in ((artifacts, "port"), (jax_artifacts, "jax")):
        d = mod.results_dir("Mechanistic", str(tmp_path / name))
        mod.dump_common(d, obs, times, labels)
        for tag in ("post", "prior"):
            mod.dump_recon(d, tag, recon)
        mod.dump_sample_bands(d, "post", *bands)
    ours = tmp_path / "port" / "results_Mechanistic"
    ref = tmp_path / "jax" / "results_Mechanistic"
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) and len(os.listdir(ref)) == 17
    for f in os.listdir(ref):
        assert (ours / f).read_bytes() == (ref / f).read_bytes(), f


SCHEDULES = {
    "none": {},
    "warmup": dict(aux_mult_start=4.6, aux_warmup_epochs=5),
    "anneal": dict(aux_mult_final=460.0, aux_anneal_epochs=4),
    "warmup+anneal": dict(aux_mult_start=4.6, aux_warmup_epochs=3, aux_mult_final=4.6, aux_anneal_epochs=4),
    "lr-decay": dict(lr_final=1e-4, lr_decay_start=3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_epoch_schedules_match_jax(name):
    jc, pc = jax_cvs_config(), load_cvs_config()
    for c in (jc, pc):
        c.num_epochs = 10
        c.update(SCHEDULES[name])
    for epoch in range(11):
        assert driver.epoch_aux_mult(pc, epoch) == jax_driver.epoch_aux_mult(jc, epoch)
        assert driver.epoch_lr_scale(pc, epoch) == jax_driver.epoch_lr_scale(jc, epoch)


def test_checkpoint_metadata_round_trip(tmp_path):
    path = str(tmp_path / "best_model.npz")
    checkpoint.save(path, {"w": np.ones(3, np.float32)}, metadata={"epoch": 7, "criterion": 1.5})
    assert checkpoint.load_metadata(path) == {"epoch": 7, "criterion": 1.5}


def test_set_seed_seeds_every_host_generator():
    import random

    assert set_seed(5) == 5
    a = (np.random.rand(), random.random(), float(torch.rand(())))
    set_seed(5)
    assert (np.random.rand(), random.random(), float(torch.rand(()))) == a


T = 16


def _tiny(num_epochs=2):
    cfg = load_cvs_config()
    cfg.seq_len, cfg.mini_batch_size, cfg.num_epochs = T, 4, num_epochs

    def split(n, seed):
        r = np.random.RandomState(seed)
        return {"observations": r.rand(n, 3, T).astype(np.float32),
                "iext": (r.rand(n, 1) > 0.5).astype(np.float32),
                "rtpr": (r.rand(n, 1) > 0.5).astype(np.float32)}

    splits = {"train": split(10, 0), "val": split(6, 1), "test": split(6, 2)}
    spec = cvs_spec(cfg, n_time=T)
    jc = jax_cvs_config()
    jc.seq_len = T
    from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec

    params = params_from_jax(jax.tree.map(np.asarray, jax_init(jax.random.key(0), jax_cvs_spec(jc, n_time=T))),
                             device="cpu")
    return cfg, splits, spec, params


def _run(cfg, splits, spec, params, eval_every: int = 1):
    ts = torch.arange(float(T))
    init_state, _, epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params)
    seen = []

    def select_best(epoch_i, val, train_s, best, params_now, losses):
        seen.append((epoch_i, val["post"].elbo, losses, params_now))
        crit = sum(val["post"].elbo) * len(val["post"].elbo)
        return {"params": params_now, "epoch": epoch_i, "criterion": crit} if best["criterion"] >= crit else best

    state, best = driver.run_training_epochs(
        spec=spec, state=init_state(params, 1), train_epoch=epoch, eval_epoch=svi.make_eval_epoch(spec, ts),
        splits=splits, config=cfg, rng=np.random.RandomState(3), eval_seed=4, select_best=select_best,
        eval_every=eval_every,
    )
    return state, best, seen


def test_epoch_loop_matches_hand_stepped_dual_steps():
    """The epoch loop takes the dual steps of train_step over each epoch's
    shuffled stacked batches, and its per-epoch val ELBO is eval_split's at
    the same params and seed."""
    cfg, splits, spec, params = _tiny()
    state, best, seen = _run(cfg, splits, spec, params)
    ts = torch.arange(float(T))
    init_state, step, _ = svi.make_train_step(spec, ts, cfg.learning_rate, params)
    ref, rng = init_state(params, 1), np.random.RandomState(3)
    eval_fns = svi.make_eval_fns(spec, ts)
    for epoch_i, val_elbo, losses, params_now in seen:
        batches = stacked_minibatches(splits["train"], cfg.mini_batch_size, shuffle=True, rng=rng)
        ref_losses = []
        for i in range(batches["mask"].shape[0]):
            ref, m = step(ref, driver.device_batch({k: v[i] for k, v in batches.items()}, "cpu"))
            ref_losses.append([float(m["loss_main"]), float(m["loss_aux"])])
        assert losses == ref_losses  # the same steps, bit for bit
        for a, b in zip(tree_leaves(params_now), tree_leaves(ref.params)):
            assert torch.equal(a, b)
        loop = driver.eval_split(spec, ref.params, fold_seed(4, epoch_i, "val_post"), splits["val"], eval_fns,
                                 cfg.mini_batch_size, is_post=True)
        np.testing.assert_allclose(val_elbo, loop.elbo, rtol=2e-5)  # eval epoch vs host loop, as the JAX package's test
    assert [e for e, *_ in seen] == [0, 1, 2] and state.step == 3 * 3  # 3 epochs of ceil(10 / 4) steps
    # the best params are a copy of the selected epoch's (a graph's next
    # epoch would overwrite the params it hands select_best)
    chosen = seen[best["epoch"]][3]
    assert best["params"] is not chosen
    for a, b in zip(tree_leaves(best["params"]), tree_leaves(chosen)):
        assert a is not b and torch.equal(a, b)


def test_eval_every_skips_the_statistics(capsys):
    cfg, splits, spec, params = _tiny(num_epochs=3)
    _, _, seen = _run(cfg, splits, spec, params, eval_every=2)
    assert [e for e, *_ in seen] == [0, 2, 3]  # the last epoch is always evaluated
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[Epoch ")]
    assert len(lines) == 4 and "l1=" not in lines[1] and "l1=" in lines[2]


def test_the_epochs_one_read_is_the_reads_of_each_number(capsys):
    """Two driver epochs on the graph path's plain version and eagerly: the
    losses and the four statistics that select_best receives from the
    epoch's one read are, bit for bit, the losses read alone and a separate
    eval_epoch's at the epoch's params and seeds read number by number; both
    dispatches choose the same best params and print the same epoch lines
    but for their time."""
    cfg, splits, spec, params = _tiny(num_epochs=1)
    ts = torch.arange(float(T))
    runs = {}
    for dispatch in ("plain", "eager"):
        init_state, _, epoch = svi.make_train_step(spec, ts, cfg.learning_rate, params, dispatch=dispatch)
        eval_epoch = svi.make_eval_epoch(spec, ts, dispatch=dispatch)
        stacks = {k: driver.device_batch(stacked_minibatches(splits[k], cfg.mini_batch_size, shuffle=False), "cpu")
                  for k in ("val", "train")}
        losses_alone, checked = [], []

        def train_epoch(state, batches):
            state, mets = epoch(state, batches)
            losses_alone.append(torch.stack([mets["loss_main"], mets["loss_aux"]], dim=1).tolist())
            return state, mets

        def read_alone(params_now, seed, split, is_post):
            fused = eval_epoch(params_now, seed, stacks[split], is_post)
            n = max(float(fused["n"]), 1.0)
            return ([float(fused["elbo_main"]), float(fused["elbo_aux"])], float(fused["l1"]) / n,
                    [(k, float(v) / n) for k, v in fused["labels"].items()])

        def select_best(epoch_i, val, train_s, best, params_now, losses):
            assert losses == losses_alone[-1]
            for split, stats in (("val", val), ("train", train_s)):
                for mode, got in stats.items():
                    ref = read_alone(params_now, fold_seed(4, epoch_i, f"{split}_{mode}"), split, mode == "post")
                    assert (got.elbo, got.l1, list(got.label_metrics.items())) == ref
                    checked.append((epoch_i, split, mode))
            crit = sum(val["post"].elbo) * len(val["post"].elbo)
            return {"params": params_now, "epoch": epoch_i, "criterion": crit} if best["criterion"] >= crit else best

        capsys.readouterr()
        _, best = driver.run_training_epochs(
            spec=spec, state=init_state(params, 1), train_epoch=train_epoch, eval_epoch=eval_epoch, splits=splits,
            config=cfg, rng=np.random.RandomState(3), eval_seed=4, select_best=select_best,
        )
        assert len(checked) == 2 * 4 and len(losses_alone) == 2
        lines = [re.sub(r"\[[0-9.]+s\]$", "", ln) for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("[Epoch ")]
        runs[dispatch] = lines, best, losses_alone
    (lines_p, best_p, losses_p), (lines_e, best_e, losses_e) = runs["plain"], runs["eager"]
    assert len(lines_p) == 2 and lines_p == lines_e and losses_p == losses_e
    assert best_p["epoch"] == best_e["epoch"] and best_p["criterion"] == best_e["criterion"]
    for a, b in zip(tree_leaves(best_p["params"]), tree_leaves(best_e["params"])):
        assert torch.equal(a, b)
