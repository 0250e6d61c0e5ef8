"""The structured latent-ODE VAE (the JAX package's ``models/slode.py``):
parameters and ``param_masks``, the encoder, the conditional priors, the two
losses ``elbo_main`` and ``elbo_aux``, ``classifier`` and ``recon``.

Randomness: each function takes an integer ``seed``; every sampling site
draws with :func:`~structured_latent_odes_tpu_torch.prob.sample_normal_ps`,
so a sample's draw depends only on (seed, site, sample_id). ``noise=``
replaces the draws with given standard-normal tensors, one per site, keyed by
site name:

- ``recon`` posterior: ``{"z": (B, latent_dim)}``
- ``recon`` prior / ``sample_prior_z``: one entry per latent block name
  (for CVS ``iext``, ``rtpr``, ``epsilon``)
- ``classifier``: one entry per label name
- ``elbo_main``: one entry per labeled block name (``z_u`` for the joint
  prior) and one for the epsilon block
- ``elbo_aux``: one entry per labeled block name
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
from structured_latent_odes_tpu_torch.prob import (
    Trace,
    bernoulli_logpmf,
    laplace_logpdf,
    l1_of_parts,
    masked_l1_parts,
    normal_logpdf,
    onehot_categorical_logpmf,
    quantile_laplace_logprob,
    sample_normal_ps,
)
from structured_latent_odes_tpu_torch.utils.tree import tree_map

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
    return tree_map(lambda p: p.to(device), params)


def param_masks(spec: ModelSpec, params) -> Tuple[Dict, Dict]:
    """Bool trees of which parameter groups each loss updates: the main loss
    touches encoder, decoder and priors (and the aux heads when
    ``spec.aux_in_model``), the aux loss the encoder and the aux heads. The
    shared Adam steps only those, as Pyro's per-parameter Adam does."""
    def fill(group, value: bool):
        return tree_map(lambda _: value, params[group])

    main = {
        "encoder": fill("encoder", True),
        "decoder": fill("decoder", True),
        "priors": fill("priors", True),
        "aux": fill("aux", spec.aux_in_model),
        "aux_std": fill("aux_std", spec.aux_in_model),
    }
    aux = {
        "encoder": fill("encoder", True),
        "decoder": fill("decoder", False),
        "priors": fill("priors", False),
        "aux": fill("aux", True),
        "aux_std": fill("aux_std", True),
    }
    return main, aux


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


def _aux_mult(spec: ModelSpec, batch: Batch):
    """Aux site scale: the spec constant, overridable per batch with an
    ``aux_mult`` scalar (annealing schedules)."""
    return batch.get("aux_mult", spec.aux_loss_multiplier)


def _aux_site(spec: ModelSpec, params, tr: Trace, label: LabelSpec, z_block: Tensor,
              target: Tensor, mult) -> None:
    """Score one q(u|z) head as a scaled observed site."""
    if label.kind == "bernoulli":
        tr.obs(bernoulli_logpmf(target, _aux_head(spec, params, label, z_block)), scale=mult)
    elif label.kind == "onehot":
        tr.obs(onehot_categorical_logpmf(target, _aux_head(spec, params, label, z_block)), scale=mult)
    else:  # continuous
        loc, _ = _aux_head(spec, params, label, z_block)
        std = F.softplus(params["aux_std"][label.name]) + 1e-6
        tr.obs(laplace_logpdf(target, loc, std), scale=mult)


def _aux_obs_terms(spec: ModelSpec, params, tr: Trace, z: Tensor, batch: Batch) -> None:
    """The aux heads scored in the main loss (``spec.aux_in_model``); z is
    the full latent, split per block."""
    mult = _aux_mult(spec, batch)
    for label in spec.labels:
        _aux_site(spec, params, tr, label, z[:, spec.block_slice(label.block)], batch[label.name], mult)


def _observation_terms(spec: ModelSpec, tr: Trace, obs: Tensor, decoded,
                       sample_mask: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Likelihood sites, and the parts of the reference's side-channel L1
    metric (``prob.elbo.l1_of_parts`` of them is the metric): sums over the
    batch, which ranks holding slices of one batch add before the ratio."""
    if spec.likelihood == "quantile":
        _, mu_75, mu_50, mu_25, std = decoded
        taus = (0.5, 0.5 + spec.quantile_diff, 0.5 - spec.quantile_diff)
        for mu, tau in ((mu_50, taus[0]), (mu_75, taus[1]), (mu_25, taus[2])):
            tr.obs(quantile_laplace_logprob(obs, mu, std, tau), event_dims=2)
        return masked_l1_parts(obs, mu_50, sample_mask)
    _, mean, std = decoded
    tr.obs(normal_logpdf(obs, mean, std), event_dims=2)
    return masked_abs_parts(obs - mean, sample_mask)


def masked_abs_parts(err: Tensor, sample_mask: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """The mean absolute error over the samples of ``sample_mask`` (all
    where None) as its numerator and denominator, each ``(1,)``:
    ``l1_of_parts`` of them is the mean."""
    if sample_mask is None:
        # a fill on the device, not a copy from the host: a CUDA graph can capture it
        num, den = torch.sum(torch.abs(err)), err.new_full((), float(err.numel()))
    else:
        w = sample_mask[:, None, None]
        num, den = torch.sum(torch.abs(err) * w), torch.sum(w) * err.shape[1] * err.shape[2]
    return num.reshape(1), den.reshape(1)


def elbo_main(spec: ModelSpec, params, seed: int, batch: Batch, ts,
              noise: Noise = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """-ELBO of the generative model/guide pair (one Trace_ELBO particle),
    summed over the unmasked samples, and the in-model L1 metric as its
    parts (``l1_parts``; ``prob.l1_of_parts`` of them is the metric).

    Guide: q(z|x) from the conv encoder, drawn per labeled block; model: the
    conditional priors p(z_u|u), N(0, I) epsilon and the ODE-decoded
    likelihood (plus the aux sites when ``spec.aux_in_model``).
    """
    obs = batch["observations"]
    mask = batch.get("mask")
    sids = _sample_ids(batch)
    loc, scale = encode(spec, params, obs)
    tr = Trace()
    pp = prior_params(spec, params, batch)

    if spec.prior == "separate":
        parts = []
        for block in spec.labeled_blocks:
            s = spec.block_slice(block.name)
            z_b = _draw(seed, f"main/{block.name}", sids, loc[:, s], scale[:, s], noise, block.name)
            p_loc, p_scale = pp[block.name]
            tr.latent_normal(z_b, loc[:, s], scale[:, s], p_loc, p_scale)
            parts.append(z_b)
        z_u = torch.cat(parts, dim=-1) if parts else obs.new_zeros((obs.shape[0], 0))
    else:
        n = spec.z_u_dim
        z_u = _draw(seed, "main/z_u", sids, loc[:, :n], scale[:, :n], noise, "z_u")
        p_loc, p_scale = pp["z_u"]
        tr.latent_normal(z_u, loc[:, :n], scale[:, :n], p_loc, p_scale)

    eps_name, eps_dim = spec.epsilon_block.name, spec.epsilon_block.dim
    q_loc_e, q_scale_e = loc[:, -eps_dim:], scale[:, -eps_dim:]
    z_eps = _draw(seed, f"main/{eps_name}", sids, q_loc_e, q_scale_e, noise, eps_name)
    tr.latent_normal(z_eps, q_loc_e, q_scale_e, torch.zeros_like(q_loc_e), torch.ones_like(q_scale_e))
    z = torch.cat([z_u, z_eps], dim=-1)

    if spec.aux_in_model:
        _aux_obs_terms(spec, params, tr, z, batch)
    decoded = decoder_apply(spec.decoder, params["decoder"], z, ts)
    parts = _observation_terms(spec, tr, obs, decoded, mask)
    return tr.loss(mask), {"l1_parts": parts}


def elbo_aux(spec: ModelSpec, params, seed: int, batch: Batch, noise: Noise = None) -> Tensor:
    """-ELBO of the auxiliary loss (the reference's ``model_meta`` with its
    no-op guide): per labeled block, z_b drawn from the encoder posterior in
    the model trace (so its log-prob counts), then the scaled classifier or
    regressor sites."""
    obs = batch["observations"]
    sids = _sample_ids(batch)
    loc, scale = encode(spec, params, obs)
    tr = Trace()
    z_parts = {}
    for block in spec.labeled_blocks:
        s = spec.block_slice(block.name)
        z_b = _draw(seed, f"aux/{block.name}", sids, loc[:, s], scale[:, s], noise, block.name)
        tr.model_sampled_normal(z_b, loc[:, s], scale[:, s])
        z_parts[block.name] = z_b
    mult = _aux_mult(spec, batch)
    for label in spec.labels:
        _aux_site(spec, params, tr, label, z_parts[label.block], batch[label.name], mult)
    return tr.loss(batch.get("mask"))


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
        "l1": l1_of_parts(*masked_abs_parts(mu_50 - obs, mask)),
        "solution_xt": sol,
        "mu_75": mu_75,
        "mu_50": mu_50,
        "mu_25": mu_25,
        "std": std,
        "z": z,
    }
