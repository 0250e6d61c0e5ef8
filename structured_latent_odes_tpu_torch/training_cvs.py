"""CVS training driver (the JAX package's ``training_cvs.py``), on a CUDA card
unless the caller asks for the CPU.

Run: ``python -m structured_latent_odes_tpu_torch.training_cvs
[--model Mechanistic] [--num-epochs N] [--no-plot] [--device cuda] ...``.
The same flags as the JAX driver: dataset build, dual-loss SVI training,
per-epoch val/train posterior and prior statistics, val-ELBO model selection,
and the final test evaluation with the ``.npy`` artifact contract and
``best_model.npz`` (the JAX package's checkpoint format), which the JAX
package's eval CLI scores and both packages' ``serve.py`` serve. Logs go to
``results_<Model>/model.log``. On the card it runs in full float32: TF32 is
off for matrix products and cuDNN convolutions.

``--checkpoint-every N`` saves the whole training state to
``results_<Model>/train_state.npz`` every N epochs, and ``--resume``
continues from it batch-exactly: the resumed run ends where the
uninterrupted one would, bit for bit. ``--profile-dir DIR`` writes a
``torch.profiler`` trace of the second epoch into DIR, the program's phases
in it as named ranges (``utils/profiling.py::span``). Unless ``--no-plot``
is given, the validation grids and latent t-SNE of every ``plot_epoch``-th
epoch and the test-split grids are drawn into the results directory; that
needs matplotlib and scikit-learn, and the run fails before it starts when
either is missing. ``--reference-data-dir`` reads the reference's torch
pickles instead of ``cvs.npz``.

Parameters come from the port's own ``init_params(spec, seed)``, and every
draw from the port's counter hash: JAX's threefry bits are not reproduced, so
a run is not the JAX run of the same seed, draw for draw.

``--data-parallel N`` splits each minibatch over N ranks and sums their
gradients; ``--time-parallel M`` splits each solve's horizon over M ranks
(the ``semilinear_timepar`` backend). The run then takes ``N x M`` ranks,
one process each (``train/backend.py::run_on_ranks``): spawned here, or
torchrun's when it started the processes. On the card each rank takes one
card and the ranks talk over NCCL; with ``--device cpu`` they are processes
over gloo. Rank 0 alone writes the results. ``--prior-refit-epochs``
refits the conditional priors after training, as the JAX driver does.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from structured_latent_odes_tpu_torch.data import cvs as cvs_data
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.loader import normalize_split, to_model_layout
from structured_latent_odes_tpu_torch.data.transforms import create_transforms
from structured_latent_odes_tpu_torch.interop import params_to_jax
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params
from structured_latent_odes_tpu_torch.prob import fold_seed
from structured_latent_odes_tpu_torch.train import artifacts, checkpoint
from structured_latent_odes_tpu_torch.parallel.launch import is_writer, rank0_first
from structured_latent_odes_tpu_torch.train.backend import make_training_backend, run_on_ranks
from structured_latent_odes_tpu_torch.train.driver import final_test_eval, plots_due, run_training_epochs
from structured_latent_odes_tpu_torch.train.svi import make_eval_epoch, make_eval_fns
from structured_latent_odes_tpu_torch.utils import plotting
from structured_latent_odes_tpu_torch.utils.device import full_fp32, resolve_device
from structured_latent_odes_tpu_torch.utils.rng import set_seed
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves

log = logging.getLogger("slode")

CHANNELS = ("Pa", "Pv", "fHR")


def build_splits(config, device="cuda"):
    """Normalized splits in the model layout ``(N, K, T)``, and the norm
    params: from the reference's pickles in ``config.reference_data_dir``
    when it is set, else from ``cvs.npz``. ``device`` is where a missing
    ``cvs.npz`` is generated."""
    splits, norm_params = cvs_data.load_splits(config, reference_dir=config.get("reference_data_dir"), device=device)
    transforms = create_transforms(config.norm, norm_params)
    out = {name: to_model_layout(normalize_split(split, transforms)) for name, split in splits.items()}
    return out, norm_params


def check_plotting(config) -> None:
    """With plotting on, raise before any work when matplotlib, or
    scikit-learn for the plot epochs' latent t-SNE, cannot be imported."""
    if config.get("plot", True):
        plotting.require(latent=bool(config.get("plot_epoch")))


def refit_priors(config, spec, ts, best, seed: int, train_split, rng):
    """``--prior-refit-epochs R``: after training, R epochs of main-ELBO
    updates of the conditional priors alone on the selected params
    (``train.ensemble.prior_refit``; the posterior is untouched), with the
    run's host shuffle stream and the refit seed ``fold_seed(eval seed,
    'refit')`` that an ensemble member uses too. Returns ``best`` with the
    refit params."""
    epochs = int(config.get("prior_refit_epochs") or 0)
    if not epochs:
        return best
    from structured_latent_odes_tpu_torch.train.ensemble import prior_refit

    params = prior_refit(spec, ts, config.learning_rate, best["params"], fold_seed(fold_seed(seed, "eval"), "refit"),
                         train_split, rng, epochs, config.mini_batch_size)
    return dict(best, params=params)


def open_model_log(config) -> None:
    """On the writing rank, file logging to ``results_<Model>/model.log``
    when the driver's flags asked for it (:func:`configure`)."""
    if config.get("model_log") and is_writer():
        setup_logging(artifacts.results_dir(config.model, config.results_root))


def train(config, device="cuda"):
    check_plotting(config)
    open_model_log(config)
    device = resolve_device(device)
    writer = is_writer()
    full_fp32()
    print(config.to_json())
    log.debug(config.to_json())
    seed = set_seed(config.seed)
    rng = np.random.RandomState(config.seed)

    # a missing cvs.npz is generated once, by rank 0, before the others read it
    splits, _ = rank0_first(lambda: build_splits(config, device=device))
    for name in ("train", "val", "test"):
        print(name.upper(), "obs=", splits[name]["observations"].shape)

    times = np.arange(0.0, config.seq_len * config.delta_t, config.delta_t, dtype=np.float32)
    ts = torch.as_tensor(times, device=device)
    spec = cvs_spec(config)
    params = init_params(spec, fold_seed(seed, "init"), device=device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"Model: {config.model} - with {n_params} parameters.")

    init_state, train_epoch, put_batch, reduce = make_training_backend(spec, ts, config, params)
    eval_fns = make_eval_fns(spec, ts)
    state = init_state(params, fold_seed(seed, "train"))
    out_dir = artifacts.results_dir(config.model, config.get("results_root", "."))

    def select_best(epoch, val, train_s, best, params_now, epoch_losses):
        val_elbo = sum(val["post"].elbo) * len(val["post"].elbo)
        if best["criterion"] >= val_elbo:
            return {"params": params_now, "epoch": epoch, "criterion": val_elbo}
        return best

    def on_epoch(epoch, state, val_post, val_prior, train_post, train_prior):
        if plots_due(config, epoch):
            plotting.plot_label_grid(
                out_dir,
                f"val_{epoch}_post",
                val_post.observations,
                val_post.recon,
                times,
                {"iext": val_post.labels["iext"], "rtpr": val_post.labels["rtpr"]},
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

    # final test on the best params (posterior and prior), with the artifacts
    test_post, test_prior = final_test_eval(
        spec, best["params"], fold_seed(seed, "test"), splits["test"], eval_fns, config.mini_batch_size
    )
    if writer:
        artifacts.dump_common(
            out_dir,
            test_post.observations,
            times,
            {"iext": test_post.labels["iext"].squeeze(-1), "rtpr": test_post.labels["rtpr"].squeeze(-1)},
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
                    {"iext": stats.labels["iext"], "rtpr": stats.labels["rtpr"]},
                    CHANNELS,
                )
        checkpoint.save(
            os.path.join(out_dir, "best_model.npz"),
            params_to_jax(best["params"]),
            metadata={"epoch": best["epoch"], "criterion": float(best["criterion"])},
        )

    final = "FINAL TEST: iext_acc=(%.4f,%.4f)  rtpr_acc=(%.4f,%.4f) l1=(%.6f,%.6f)" % (
        test_post.label_metrics["iext"],
        test_prior.label_metrics["iext"],
        test_post.label_metrics["rtpr"],
        test_prior.label_metrics["rtpr"],
        test_post.l1,
        test_prior.l1,
    )
    elbo_line = "ELBO: best_epoch: {} post: {} prior: {}".format(
        best["epoch"], test_post.elbo, test_prior.elbo
    )
    if writer:
        print(final)
        log.debug(final)
        print(elbo_line)
        log.debug(elbo_line)
    return {"best": best, "state": state, "test_post": test_post, "test_prior": test_prior, "out_dir": out_dir}


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags the three drivers share (the JAX drivers' common set), and
    ``--device``."""
    p.add_argument("--model", choices=["Mechanistic", "MechanisticGauss"], default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--aux-mult-final", type=float, default=None,
                   help="anneal the aux multiplier to this value")
    p.add_argument("--aux-anneal-epochs", type=int, default=None,
                   help="epochs over which to anneal the aux multiplier")
    p.add_argument("--aux-mult-start", type=float, default=None,
                   help="warm the aux multiplier up from this value")
    p.add_argument("--aux-warmup-epochs", type=int, default=None,
                   help="epochs over which to warm the aux multiplier up")
    p.add_argument("--prior-lr-mult", type=float, default=None,
                   help="conditional-prior net learning-rate multiplier "
                        "(>1 keeps p(z_u|u) tracking the posterior)")
    p.add_argument("--lr-final", type=float, default=None,
                   help="linear lr decay target (with --lr-decay-start)")
    p.add_argument("--lr-decay-start", type=int, default=None,
                   help="epoch at which linear lr decay begins")
    p.add_argument("--prior-refit-epochs", type=int, default=None,
                   help="after training, refit only the conditional-prior nets "
                        "on the main ELBO for R epochs (fresh Adam; posterior untouched)")
    p.add_argument("--aux-loss-multiplier", type=float, default=None,
                   help="aux classifier site scale (reference: 46)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--mini-batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--optimizer", choices=["shared", "split"], default=None,
                   help="shared per-param Adam (Pyro parity) or two split Adams")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="split each minibatch over N ranks (one card each on cuda, processes over gloo on cpu)")
    p.add_argument("--time-parallel", type=int, default=None,
                   help="split each ODE solve's horizon over K ranks (the semilinear_timepar backend)")
    p.add_argument("--num-particles", type=int, default=None,
                   help="ELBO particles averaged per step (Trace_ELBO(num_particles))")
    p.add_argument("--ode-backend", default=None)
    p.add_argument("--ode-rtol", type=float, default=None)
    p.add_argument("--ode-atol", type=float, default=None)
    p.add_argument("--data-path", default=None)
    p.add_argument("--results-root", default=".")
    p.add_argument("--no-plot", action="store_true",
                   help="draw no plots (then the run needs neither matplotlib nor scikit-learn)")
    p.add_argument("--eval-every", type=int, default=1,
                   help="evaluate val/train stats every N epochs (faster)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="persist full training state every N epochs")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of one epoch into this directory, with the program's "
                        "phases (the driver's, the epoch dispatch's, the graphs' and the waits on the device) "
                        "as named ranges")
    p.add_argument("--resume", action="store_true",
                   help="resume from results_<Model>/train_state.npz")
    p.add_argument("--no-eval-train", action="store_true",
                   help="skip per-epoch train-split statistics (faster)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; no CPU fallback)")
    return p


def parse_args(argv=None):
    p = add_common_args(argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter))
    p.add_argument("--quantile-diff", type=float, default=None)
    p.add_argument("--solver", default=None)
    p.add_argument("--reference-data-dir", default=None,
                   help="load the upstream torch pickles instead of generating")
    return p.parse_args(argv)


def configure(config, args):
    """Apply the parsed flags to ``config`` as the JAX drivers' ``main`` does
    (every flag named like a config key overrides it, then the run options),
    and ask for ``model.log`` in the results directory, which the run's
    writing rank opens (:func:`open_model_log`)."""
    for k, v in vars(args).items():
        if v is not None and k in config:
            config[k] = v
    config.results_root = args.results_root
    config.plot = not args.no_plot
    config.eval_train_stats = not args.no_eval_train
    config.eval_every = args.eval_every
    config.aux_mult_final = args.aux_mult_final
    config.aux_anneal_epochs = args.aux_anneal_epochs
    config.aux_mult_start = args.aux_mult_start
    config.aux_warmup_epochs = args.aux_warmup_epochs
    config.prior_refit_epochs = args.prior_refit_epochs
    config.lr_final = args.lr_final
    config.lr_decay_start = args.lr_decay_start
    config.checkpoint_every = args.checkpoint_every
    config.resume = args.resume
    config.profile_dir = args.profile_dir
    config.model_log = True


def main(argv=None):
    args = parse_args(argv)
    config = load_cvs_config()
    if args.reference_data_dir:
        config.reference_data_dir = args.reference_data_dir
    configure(config, args)
    return run_on_ranks(train, config, args.device)


def setup_logging(out_dir: str) -> None:
    """File logging to results_<Model>/model.log for the 'slode' logger only.
    A handler from an earlier run in the same process is replaced, not
    added to."""
    logger = logging.getLogger("slode")
    logger.setLevel(logging.DEBUG)
    for h in [h for h in logger.handlers if getattr(h, "slode_model_log", False)]:
        logger.removeHandler(h)
        h.close()
    handler = logging.FileHandler(os.path.join(out_dir, "model.log"), mode="w")
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    handler.slode_model_log = True
    logger.addHandler(handler)


if __name__ == "__main__":
    main()
