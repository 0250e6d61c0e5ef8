"""Synthetic-biology (proc) training driver (the JAX package's
``training_proc.py``), on a CUDA card unless the caller asks for the CPU.

Run: ``python -m structured_latent_odes_tpu_torch.training_proc
[--model Mechanistic] [--num-epochs N] [--split 1..4 | --heldout DEVICE]
[--no-plot] [--device cuda] ...``. The JAX driver's flags and behaviour:
labels unpacked from the cassette multi-hot and the log inputs, accuracy and
MSE metrics, the best model by val ELBO (posterior) under cross-validation
and overwritten every epoch under a held-out device (zero-shot), recorded as
``epoch + 1``; then the test evaluation of the val split with the ``.npy``
artifact contract (``treatments``, ``devices``), the dump of ``num_samples``
reconstruction draws and ``best_model.npz``. Logs go to
``results_<Model>/model.log``.

Parameters come from the port's ``init_params(spec, seed)`` and every draw
from the port's counter hash, so a run is not the JAX run of the same seed,
draw for draw.

``--checkpoint-every``, ``--resume``, ``--profile-dir`` and the plots work as
in ``training_cvs.py``, and so do ``--data-parallel`` and ``--time-parallel``
(several ranks; rank 0 alone writes the results). ``--prior-refit-epochs``
refits the conditional priors after training, as the JAX driver does.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from structured_latent_odes_tpu_torch.data import proc as proc_data
from structured_latent_odes_tpu_torch.data.configs import load_proc_config
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import init_params, proc_spec
from structured_latent_odes_tpu_torch.prob import fold_seed
from structured_latent_odes_tpu_torch.train import artifacts, checkpoint
from structured_latent_odes_tpu_torch.parallel.launch import is_writer
from structured_latent_odes_tpu_torch.train.backend import make_training_backend, run_on_ranks
from structured_latent_odes_tpu_torch.train.driver import final_test_eval, plots_due, run_training_epochs
from structured_latent_odes_tpu_torch.train.svi import make_eval_epoch, make_eval_fns
from structured_latent_odes_tpu_torch.training_challenge import dump_sample_bands
from structured_latent_odes_tpu_torch.training_cvs import (
    add_common_args,
    check_plotting,
    configure,
    open_model_log,
    refit_priors,
)
from structured_latent_odes_tpu_torch.utils import plotting
from structured_latent_odes_tpu_torch.utils.device import full_fp32, resolve_device
from structured_latent_odes_tpu_torch.utils.rng import set_seed
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

log = logging.getLogger("slode")

CHANNELS = ("OD", "mRFP1", "EYFP", "ECFP")


def train(config, device="cuda"):
    check_plotting(config)
    open_model_log(config)
    device = resolve_device(device)
    writer = is_writer()
    full_fp32(deterministic=True)
    print(config.to_json())
    log.debug(config.to_json())
    seed = set_seed(config.seed)
    rng = np.random.RandomState(config.seed)

    splits, times = proc_data.build_splits(config)  # already (N, K, T) and scaled
    for name in ("train", "val"):
        print(name.upper(), "obs=", splits[name]["observations"].shape)

    ts = torch.as_tensor(times, device=device)
    spec = proc_spec(config, n_time=len(times))
    params = init_params(spec, fold_seed(seed, "init"), device=device)
    print(f"Model: {config.model} - with {sum(p.numel() for p in tree_leaves(params))} parameters.")

    init_state, train_epoch, put_batch, reduce = make_training_backend(spec, ts, config, params)
    eval_fns = make_eval_fns(spec, ts)
    state = init_state(params, fold_seed(seed, "train"))
    out_dir = artifacts.results_dir(config.model, config.get("results_root", "."))

    def select_best(epoch, val, train_s, best, params_now, epoch_losses):
        val_elbo = float(np.sum(val["post"].elbo))
        # zero-shot: overwrite every epoch; else the lowest val ELBO
        if config.get("heldout") or val_elbo < best["criterion"]:
            return {"params": params_now, "epoch": epoch + 1, "criterion": val_elbo}
        return best

    def on_epoch(epoch, state, val_post, val_prior, train_post, train_prior):
        if plots_due(config, epoch):
            plotting.plot_by_device(
                out_dir,
                f"val_{epoch}_post",
                val_post.observations,
                val_post.recon,
                times,
                np.concatenate([val_post.labels["aR"], val_post.labels["aS"]], axis=1),
                np.concatenate([val_post.labels["C12"], val_post.labels["C6"]], axis=1),
                CHANNELS,
            )
            plotting.visualize_latent(out_dir, val_post.recon["z"], val_prior.recon["z"], epoch, config.seed)

    state, best = run_training_epochs(
        spec=spec,
        state=state,
        train_epoch=train_epoch,
        eval_epoch=make_eval_epoch(spec, ts, reduce=reduce),
        splits=splits,
        config=config,
        rng=rng,
        eval_seed=fold_seed(seed, "eval"),
        select_best=select_best,
        on_epoch=on_epoch,
        eval_fns=eval_fns,
        eval_train_stats=config.get("eval_train_stats", True),
        put_batch=put_batch,
        eval_every=config.get("eval_every", 1),
        checkpoint_path=os.path.join(out_dir, "train_state.npz"),
        checkpoint_every=config.get("checkpoint_every", 0),
        resume=config.get("resume", False),
        profile_dir=config.get("profile_dir"),
    )
    best = refit_priors(config, spec, ts, best, seed, splits["train"], rng)

    test_post, test_prior = final_test_eval(spec, best["params"], fold_seed(seed, "test"), splits["val"],
                                            eval_fns, config.mini_batch_size)
    labels = test_post.labels
    dump_sample_bands(out_dir, eval_fns[2], best["params"], fold_seed(seed, "samples"), splits["val"],
                      config.num_samples, device, write=writer)
    if writer:
        artifacts.dump_common(
            out_dir,
            test_post.observations,
            times,
            {
                "treatments": np.concatenate([labels["C12"], labels["C6"]], axis=1),
                "devices": np.concatenate([labels["aR"], labels["aS"]], axis=1),
            },
        )
        artifacts.dump_recon(out_dir, "post", test_post.recon)
        artifacts.dump_recon(out_dir, "prior", test_prior.recon)
        checkpoint.save(
            os.path.join(out_dir, "best_model.npz"),
            params_to_jax(best["params"]),
            metadata={"epoch": int(best["epoch"]), "criterion": float(best["criterion"])},
        )

    final = (
        "FINAL TEST: aR_acc=(%.4f,%.4f)  aS_acc=(%.4f,%.4f) C12_mse=(%.4f,%.4f) "
        "C6_mse=(%.4f,%.4f) l1=(%.6f,%.6f)"
        % (
            test_post.label_metrics["aR"],
            test_prior.label_metrics["aR"],
            test_post.label_metrics["aS"],
            test_prior.label_metrics["aS"],
            test_post.label_metrics["C12"],
            test_prior.label_metrics["C12"],
            test_post.label_metrics["C6"],
            test_prior.label_metrics["C6"],
            test_post.l1,
            test_prior.l1,
        )
    )
    if writer:
        print(final)
        log.debug(final)
    return {"best": best, "state": state, "test_post": test_post, "test_prior": test_prior, "out_dir": out_dir}


def parse_args(argv=None):
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter))
    p.add_argument("--data-seed", type=int, default=None,
                   help="fold-split seed (defaults to --seed; set to pin the "
                        "fold while varying training randomness)")
    p.add_argument("--split", type=int, default=None, help="fold 1..4")
    p.add_argument("--heldout", default=None, help="device name for zero-shot split")
    p.add_argument("--num-samples", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = load_proc_config()
    configure(config, args)
    config.data_seed = args.data_seed
    return run_on_ranks(train, config, args.device)


if __name__ == "__main__":
    main()
