"""Human viral challenge training driver (the JAX package's
``training_challenge.py``), on a CUDA card unless the caller asks for the CPU.

Run: ``python -m structured_latent_odes_tpu_torch.training_challenge
[--model Mechanistic] [--num-epochs N] [--split 1..5] [--no-plot]
[--device cuda] ...``. The JAX driver's flags and behaviour: a 5-fold
subject split whose val fold doubles as the test set (evaluated as one full
batch), the minibatch clamped to the train fold (28 subjects: 32, four rows
padded and masked), best-model selection on the mean train loss of an epoch,
and the test-time dump of ``num_samples`` reconstruction draws
(``mu_{25,50,75}_{post,prior}_sample.npy``) beside the ``.npy`` artifact
contract and ``best_model.npz``. Logs go to ``results_<Model>/model.log``.

Parameters come from the port's ``init_params(spec, seed)`` and every draw
from the port's counter hash, so a run is not the JAX run of the same seed,
draw for draw. Each of the sample dump's draws has its own seed, derived from
the run's seed, the tag (post or prior) and the draw's index.

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

from structured_latent_odes_tpu_torch.data import challenge as challenge_data
from structured_latent_odes_tpu_torch.data.configs import load_challenge_config
from structured_latent_odes_tpu_torch.data.loader import full_batch, normalize_split, to_model_layout
from structured_latent_odes_tpu_torch.data.transforms import create_transforms
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import challenge_spec, init_params
from structured_latent_odes_tpu_torch.prob import fold_seed
from structured_latent_odes_tpu_torch.train import artifacts, checkpoint
from structured_latent_odes_tpu_torch.parallel.launch import is_writer
from structured_latent_odes_tpu_torch.train.backend import make_training_backend, run_on_ranks
from structured_latent_odes_tpu_torch.train.driver import device_batch, final_test_eval, plots_due, run_training_epochs
from structured_latent_odes_tpu_torch.train.svi import make_eval_epoch, make_eval_fns
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

CHANNELS = ("HR", "TEMP", "EDA", "ACC")


def build_splits(config):
    """The train and val folds, normalized with the train fold's parameters,
    in the model layout ``(N, K, T)``; and the time grid."""
    raw_splits, norm_params, times = challenge_data.build_datasets(config)
    transforms = create_transforms(config.norm, norm_params)
    splits = {name: to_model_layout(normalize_split(split, transforms)) for name, split in raw_splits.items()}
    return splits, times


def multiple_samples(reconstruct, params, seed: int, batch, num_samples: int, is_post: bool):
    """``num_samples`` reconstruction draws, draw ``i`` at seed
    ``fold_seed(seed, i)``, stacked on a trailing sample axis. Returns a dict
    of (N, K, T, S) arrays."""
    mus = {"mu_25": [], "mu_50": [], "mu_75": []}
    for i in range(num_samples):
        r = reconstruct(params, fold_seed(seed, i), batch, is_post)
        for k in mus:
            mus[k].append(r[k])
    return {k: torch.stack(v, dim=3).cpu().numpy() for k, v in mus.items()}


def dump_sample_bands(out_dir, reconstruct, params, seed: int, split, num_samples: int, device,
                      write: bool = True) -> None:
    """The sample dump over the whole split, posterior and prior. A rank
    that does not write (``write=False``) draws all the same: a
    time-parallel solve needs every rank of its time group."""
    batch = device_batch(full_batch(split), device)
    for tag, is_post in (("post", True), ("prior", False)):
        bands = multiple_samples(reconstruct, params, fold_seed(seed, tag), batch, num_samples, is_post)
        if write:
            artifacts.dump_sample_bands(out_dir, tag, bands["mu_25"], bands["mu_50"], bands["mu_75"])


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

    splits, times = build_splits(config)
    for name in ("train", "val"):
        print(name.upper(), "obs=", splits[name]["observations"].shape)

    # a static batch never padded beyond the (tiny) train fold
    n_train = splits["train"]["observations"].shape[0]
    config.mini_batch_size = min(config.mini_batch_size, ((n_train + 7) // 8) * 8)

    ts = torch.as_tensor(times, device=device)
    spec = challenge_spec(config, n_time=len(times))
    params = init_params(spec, fold_seed(seed, "init"), device=device)
    print(f"Model: {config.model} - with {sum(p.numel() for p in tree_leaves(params))} parameters.")

    init_state, train_epoch, put_batch, reduce = make_training_backend(spec, ts, config, params)
    eval_fns = make_eval_fns(spec, ts)
    state = init_state(params, fold_seed(seed, "train"))
    out_dir = artifacts.results_dir(config.model, config.get("results_root", "."))

    def select_best(epoch, val, train_s, best, params_now, epoch_losses):
        # the challenge policy: the best epoch by mean train loss
        crit = float(np.mean(epoch_losses)) if epoch_losses else np.inf
        if crit < best["criterion"]:
            return {"params": params_now, "epoch": epoch, "criterion": crit}
        return best

    def on_epoch(epoch, state, val_post, val_prior, train_post, train_prior):
        if plots_due(config, epoch):
            plotting.plot_label_grid(
                out_dir,
                f"val_{epoch}_post",
                val_post.observations,
                val_post.recon,
                times,
                {"symptoms": val_post.labels["symptoms"], "shedding": val_post.labels["shedding"]},
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

    # the val fold is the test set, evaluated as one full batch
    eval_bs = max(config.mini_batch_size, splits["val"]["observations"].shape[0])
    test_post, test_prior = final_test_eval(spec, best["params"], fold_seed(seed, "test"), splits["val"],
                                            eval_fns, eval_bs)
    dump_sample_bands(out_dir, eval_fns[2], best["params"], fold_seed(seed, "samples"), splits["val"],
                      config.num_samples, device, write=writer)
    if writer:
        artifacts.dump_common(
            out_dir,
            test_post.observations,
            times,
            {"symptoms": test_post.labels["symptoms"].squeeze(-1),
             "shedding": test_post.labels["shedding"].squeeze(-1)},
        )
        artifacts.dump_recon(out_dir, "post", test_post.recon)
        artifacts.dump_recon(out_dir, "prior", test_prior.recon)
        if config.get("plot", True):
            for tag, stats in (("post", test_post), ("prior", test_prior)):
                plotting.plot_label_grid(
                    out_dir,
                    f"test_{best['epoch']}_{tag}",
                    stats.observations,
                    stats.recon,
                    times,
                    {"symptoms": stats.labels["symptoms"], "shedding": stats.labels["shedding"]},
                    CHANNELS,
                )
        checkpoint.save(
            os.path.join(out_dir, "best_model.npz"),
            params_to_jax(best["params"]),
            metadata={"epoch": best["epoch"], "criterion": float(best["criterion"])},
        )

    final = "FINAL TEST: shedding_acc=(%.4f,%.4f)  symptoms_acc=(%.4f,%.4f) l1=(%.6f,%.6f)" % (
        test_post.label_metrics["shedding"],
        test_prior.label_metrics["shedding"],
        test_post.label_metrics["symptoms"],
        test_prior.label_metrics["symptoms"],
        test_post.l1,
        test_prior.l1,
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
    p.add_argument("--split", type=int, default=None, help="fold 1..5")
    p.add_argument("--num-samples", type=int, default=None)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = load_challenge_config()
    configure(config, args)
    config.data_seed = args.data_seed
    return run_on_ranks(train, config, args.device)


if __name__ == "__main__":
    main()
