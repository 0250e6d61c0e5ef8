"""The structured latent-ODE VAE (the JAX package's ``models/slode.py``),
serving half: parameters, the encoder, the conditional priors, ``classifier``
and ``recon``. The ELBOs and ``param_masks`` belong to the training slice.

Randomness: each function takes an integer ``seed``; every sampling site
draws with :func:`~structured_latent_odes_tpu_torch.prob.sample_normal_ps`,
so a sample's draw depends only on (seed, site, sample_id). ``noise=``
replaces the draws with given standard-normal tensors, one per site, keyed by
site name:

- ``recon`` posterior: ``{"z": (B, latent_dim)}``
- ``recon`` prior / ``sample_prior_z``: one entry per latent block name
  (for CVS ``iext``, ``rtpr``, ``epsilon``)
- ``classifier``: one entry per label name
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.models.spec import LabelSpec, ModelSpec
from structured_latent_odes_tpu_torch.nn.decoders import decoder_apply, decoder_init
from structured_latent_odes_tpu_torch.nn.layers import (
    conv_encoder_apply,
    conv_encoder_init,
    mlp_apply,
    mlp_init,
)
from structured_latent_odes_tpu_torch.prob import sample_normal_ps

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
Noise = Optional[Dict[str, Tensor]]


def init_params(spec: ModelSpec, seed: int, device="cuda"):
    """Random parameters from ``seed`` (drawn on the CPU, then moved)."""
    gen = torch.Generator().manual_seed(seed)
    params = {
        "encoder": conv_encoder_init(gen, spec.encoder),
        "decoder": decoder_init(gen, spec.decoder),
        "priors": {},
        "aux": {},
        "aux_std": {},
    }
    if spec.prior == "separate":
        for block in spec.labeled_blocks:
            params["priors"][block.name] = mlp_init(gen, spec.prior_spec(block.name))
    else:
        params["priors"]["z_u"] = mlp_init(gen, spec.prior_spec())
    for label in spec.labels:
        params["aux"][label.name] = mlp_init(gen, spec.aux_head_spec(label))
        if label.kind == "continuous":
            params["aux_std"][label.name] = torch.full((label.dim,), 1e-2)
    return _to_device(params, device)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def encode(spec: ModelSpec, params, obs: Tensor) -> Tuple[Tensor, Tensor]:
    return conv_encoder_apply(spec.encoder, params["encoder"], obs)


def _sample_ids(batch: Batch) -> Tensor:
    """Per-sample identity: the loader's ``sample_id`` if present, else the
    position in the batch (padding-stable, since padding appends)."""
    sid = batch.get("sample_id")
    if sid is None:
        obs = batch["observations"]
        return torch.arange(obs.shape[0], device=obs.device)
    return sid


def _draw(seed: int, site: str, sids: Tensor, loc: Tensor, scale: Tensor, noise: Noise,
          name: str) -> Tensor:
    eps = None if noise is None else noise[name]
    return sample_normal_ps(seed, site, sids, loc, scale, eps=eps)


def prior_params(spec: ModelSpec, params, batch: Batch):
    """Conditional-prior (loc, scale) per labeled block / joint z_u."""
    if spec.prior == "separate":
        out = {}
        for block in spec.labeled_blocks:
            label = next(l for l in spec.labels if l.block == block.name)
            out[block.name] = mlp_apply(
                spec.prior_spec(block.name), params["priors"][block.name], batch[label.name]
            )
        return out
    prior_input = torch.cat([batch[name] for name in spec.prior_input_order], dim=-1)
    return {"z_u": mlp_apply(spec.prior_spec(), params["priors"]["z_u"], prior_input)}


def sample_prior_z(spec: ModelSpec, params, seed: int, batch: Batch, noise: Noise = None) -> Tensor:
    """z ~ p(z|u): conditional priors for the labeled blocks + N(0, I)
    epsilon. For the joint prior the labeled draw is keyed ``z_u``."""
    pp = prior_params(spec, params, batch)
    sids = _sample_ids(batch)
    parts = []
    for name, (loc, scale) in pp.items():
        parts.append(_draw(seed, f"prior/{name}", sids, loc, scale, noise, name))
    eps_name = spec.epsilon_block.name
    zeros = torch.zeros(
        (batch["observations"].shape[0], spec.epsilon_block.dim),
        dtype=batch["observations"].dtype, device=batch["observations"].device,
    )
    parts.append(_draw(seed, f"prior/{eps_name}", sids, zeros, torch.ones_like(zeros), noise, eps_name))
    return torch.cat(parts, dim=-1)


def _aux_head(spec: ModelSpec, params, label: LabelSpec, z_block: Tensor):
    return mlp_apply(spec.aux_head_spec(label), params["aux"][label.name], z_block)


def _masked_mean_abs(err: Tensor, sample_mask: Optional[Tensor]) -> Tensor:
    if sample_mask is None:
        return torch.mean(torch.abs(err))
    w = sample_mask[:, None, None]
    return torch.sum(torch.abs(err) * w) / torch.clamp(
        torch.sum(w) * err.shape[1] * err.shape[2], min=1.0
    )


def classifier(spec: ModelSpec, params, seed: int, obs: Tensor,
               sample_ids: Optional[Tensor] = None, noise: Noise = None) -> Dict[str, Tensor]:
    """Label predictions from posterior samples: bernoulli -> thresholded at
    0.5, onehot -> argmax one-hot, continuous -> regressed loc."""
    loc, scale = encode(spec, params, obs)
    sids = torch.arange(obs.shape[0], device=obs.device) if sample_ids is None else sample_ids
    out = {}
    for label in spec.labels:
        s = spec.block_slice(label.block)
        z_b = _draw(seed, f"classifier/{label.name}", sids, loc[:, s], scale[:, s], noise, label.name)
        if label.kind == "bernoulli":
            out[label.name] = (_aux_head(spec, params, label, z_b) > 0.5).to(obs.dtype)
        elif label.kind == "onehot":
            alpha = _aux_head(spec, params, label, z_b)
            out[label.name] = F.one_hot(alpha.argmax(-1), label.dim).to(obs.dtype)
        else:
            out[label.name] = _aux_head(spec, params, label, z_b)[0]
    return out


def recon(spec: ModelSpec, params, seed: int, batch: Batch, ts, is_post: bool,
          noise: Noise = None) -> Dict[str, Tensor]:
    """Reconstruction from posterior or conditional-prior latents.

    Returns l1, solution_xt, mu_75/50/25, std and z; for the Gauss likelihood
    the bands are mean +/- 2 std.
    """
    obs = batch["observations"]
    mask = batch.get("mask")
    if is_post:
        loc, scale = encode(spec, params, obs)
        z = _draw(seed, "posterior", _sample_ids(batch), loc, scale, noise, "z")
    else:
        z = sample_prior_z(spec, params, seed, batch, noise)
    decoded = decoder_apply(spec.decoder, params["decoder"], z, ts)
    if spec.likelihood == "quantile":
        sol, mu_75, mu_50, mu_25, std = decoded
    else:
        sol, mean, std = decoded
        mu_50, mu_75, mu_25 = mean, mean + 2.0 * std, mean - 2.0 * std
    return {
        "l1": _masked_mean_abs(mu_50 - obs, mask),
        "solution_xt": sol,
        "mu_75": mu_75,
        "mu_50": mu_50,
        "mu_25": mu_25,
        "std": std,
        "z": z,
    }
