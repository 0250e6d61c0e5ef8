"""Inference / serving entry point (the JAX package's ``serve.py``), on a CUDA
card unless the caller asks for the CPU.

Library use::

    from structured_latent_odes_tpu_torch.serve import load_model, make_predict_fns
    spec, params, ts, splits = load_model("cvs", "results_Mechanistic/best_model.npz")
    recon_fn, classify_fn = make_predict_fns(spec, ts)
    out = recon_fn(params, seed, batch, True)

CLI (checkpoints in the JAX package's format, written by either package)::

    python -m structured_latent_odes_tpu_torch.serve --dataset cvs \\
        --checkpoint results_Mechanistic/best_model.npz \\
        --split test --output preds.npz [--prior] [--classify] [--device cuda]

Several checkpoints serve the ensemble-mean predictor: trajectory outputs are
averaged across members, ``l1`` is recomputed from the averaged ``mu_50``,
and ``--classify`` labels combine by majority vote. The ODE backend comes
from the config (``ode_backend``): pass a config to :func:`load_model` or
:func:`main` to choose it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from structured_latent_odes_tpu_torch.data.configs import LOADERS
from structured_latent_odes_tpu_torch.interop import params_from_jax, params_to_jax
from structured_latent_odes_tpu_torch.models import classifier, cvs_spec, init_params, recon
from structured_latent_odes_tpu_torch.train import checkpoint
from structured_latent_odes_tpu_torch.training_cvs import build_splits

_NOT_PORTED = {"proc": "ROADMAP A13", "challenge": "ROADMAP A12"}


def _resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card fails
    loudly instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; "
            "pass device='cpu' (CLI: --device cpu) to serve on the CPU"
        )
    return device


def _full_fp32() -> None:
    """Serve in full float32: cuDNN runs float32 convolutions in TF32 by
    default, which would change the encoder's result."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _build(dataset: str, config, device):
    """Returns (spec, splits_in_model_layout, times)."""
    if dataset != "cvs":
        raise ValueError(dataset)
    splits, _ = build_splits(config, device=device)
    times = np.arange(0.0, config.seq_len * config.delta_t, config.delta_t, dtype=np.float32)
    return cvs_spec(config), splits, times


def _like(spec):
    """A JAX-layout tree of this spec's parameter shapes, for restore."""
    return params_to_jax(init_params(spec, 0, device="cpu"))


def load_model(dataset: str, checkpoint_path: str, config=None, device="cuda"):
    """Restore a trained model. Returns (spec, params, times, splits)."""
    device = _resolve_device(device)
    if dataset in _NOT_PORTED:
        raise NotImplementedError(f"dataset {dataset!r} is not ported yet ({_NOT_PORTED[dataset]})")
    config = config or LOADERS[dataset]()
    spec, splits, times = _build(dataset, config, device)
    params = params_from_jax(checkpoint.restore(checkpoint_path, _like(spec)), device)
    return spec, params, times, splits


def make_predict_fns(spec, times, device="cuda"):
    """(recon_fn, classify_fn) for serving, on tensors on ``device``."""
    _full_fp32()
    ts = torch.as_tensor(np.asarray(times, dtype=np.float32), device=_resolve_device(device))

    @torch.inference_mode()
    def recon_fn(params, seed, batch, is_post):
        return recon(spec, params, seed, batch, ts, is_post)

    @torch.inference_mode()
    def classify_fn(params, seed, obs):
        return classifier(spec, params, seed, obs)

    return recon_fn, classify_fn


def _combine_labels(spec, preds_list):
    """Majority-vote / mean combination of per-member classifier outputs:
    bernoulli -> vote share re-thresholded with ``mean > 0.5``, so a tie
    (exactly half the members vote 1) goes to class 0; onehot -> argmax of
    the vote distribution re-onehotted; continuous -> mean."""
    kinds = {label.name: label.kind for label in spec.labels}
    out = {}
    for k in preds_list[0]:
        stack = np.stack([np.asarray(p[k]) for p in preds_list])
        mean = stack.mean(0)
        kind = kinds.get(k, "continuous")
        if kind == "bernoulli":
            out[k] = (mean > 0.5).astype(stack.dtype)
        elif kind == "onehot":
            idx = mean.argmax(-1)
            out[k] = np.eye(mean.shape[-1], dtype=stack.dtype)[idx]
        else:
            out[k] = mean
    return out


def _numpy(tree):
    return {k: v.cpu().numpy() for k, v in tree.items()}


def main(argv=None, config=None):
    """The CLI. ``config`` (not a flag) replaces the dataset's default config,
    e.g. to choose the ODE backend or the data path. Returns the written
    arrays."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", choices=["cvs", "proc", "challenge"], required=True)
    p.add_argument(
        "--checkpoint", required=True, nargs="+",
        help="one checkpoint, or several for the ensemble-mean predictor",
    )
    p.add_argument("--split", default="test", help="dataset split (or 'val')")
    p.add_argument("--output", default="preds.npz")
    p.add_argument("--prior", action="store_true", help="reconstruct from the conditional prior")
    p.add_argument("--classify", action="store_true", help="also emit label predictions")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; no CPU fallback)")
    args = p.parse_args(argv)

    device = _resolve_device(args.device)
    spec, params, times, splits = load_model(args.dataset, args.checkpoint[0], config, device)
    like = _like(spec)
    params_list = [params] + [
        params_from_jax(checkpoint.restore(c, like), device) for c in args.checkpoint[1:]
    ]
    split = splits.get(args.split) or splits["val"]
    batch = {k: torch.as_tensor(v, device=device) for k, v in split.items()}
    recon_fn, classify_fn = make_predict_fns(spec, times, device)

    rs = [_numpy(recon_fn(p, args.seed, batch, not args.prior)) for p in params_list]
    out = {k: np.mean([r[k] for r in rs], axis=0) for k in rs[0] if k != "l1"}
    # the averaged predictor's own masked L1, same bookkeeping as recon's
    # _masked_mean_abs (per-sample mask broadcast over channels x time)
    mask = split.get("mask")
    err = np.abs(out["mu_50"] - np.asarray(split["observations"]))
    if mask is not None:
        w = np.asarray(mask)[:, None, None]
        out["l1"] = np.sum(err * w) / max(float(w.sum()) * err.shape[1] * err.shape[2], 1.0)
    else:
        out["l1"] = err.mean()
    if args.classify:
        preds_list = [_numpy(classify_fn(p, args.seed, batch["observations"])) for p in params_list]
        combined = _combine_labels(spec, preds_list)
        out.update({f"pred_{k}": v for k, v in combined.items()})
    np.savez(args.output, **out)
    tag = "prior" if args.prior else "posterior"
    ens = f", ensemble-mean of {len(params_list)}" if len(params_list) > 1 else ""
    print(
        f"wrote {args.output}: l1={float(out['l1']):.6f} "
        f"mu_50 {out['mu_50'].shape} ({tag}{ens})"
    )
    return out


if __name__ == "__main__":
    main()
