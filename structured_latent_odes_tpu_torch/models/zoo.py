"""Concrete model specs (the JAX package's ``models/zoo.py``). This slice
ports CVS, quantile (``Mechanistic``) and Gauss (``MechanisticGauss``)
variants; proc and challenge wait for ROADMAP A13 and A12."""

from __future__ import annotations

from structured_latent_odes_tpu_torch.models.spec import LabelSpec, LatentBlock, ModelSpec
from structured_latent_odes_tpu_torch.nn.decoders import DecoderSpec
from structured_latent_odes_tpu_torch.nn.layers import ConvEncoderSpec
from structured_latent_odes_tpu_torch.nn.ode_model import OdeModelSpec


def _likelihood(config) -> str:
    model = config.get("model", "Mechanistic")
    if model == "Mechanistic":
        return "quantile"
    if model == "MechanisticGauss":
        return "gaussian"
    raise ValueError(f"selected model is not implemented: {model!r}")


def _common(config, latent_dim: int, n_time: int):
    encoder = ConvEncoderSpec(
        n_channels=config.obs_dim,
        n_time=n_time,
        n_filters=config.n_filters,
        filter_size=config.filter_size,
        pool_size=config.pool_size,
        hidden_dim=config.cnn_hidden_dim,
        latent_dim=latent_dim,
    )
    ode_backend = config.get("ode_backend", "semilinear")
    if int(config.get("time_parallel") or 0) > 1:
        # sharding the horizon over devices is the semilinear_timepar backend
        if ode_backend not in ("semilinear", "semilinear_timepar"):
            raise ValueError(
                f"--time-parallel requires the semilinear ode backend "
                f"(got --ode-backend {ode_backend!r})"
            )
        ode_backend = "semilinear_timepar"
    ode = OdeModelSpec(
        latent_dim=latent_dim,
        ode_state_dim=config.ode_state_dim,
        ode_hidden_dim=config.ode_hidden_dim,
        solver=config.solver,
        backend=ode_backend,
    )
    decoder = DecoderSpec(
        kind="quantile" if _likelihood(config) == "quantile" else "gaussian",
        ode=ode,
        obs_dim=config.obs_dim,
        n_time=n_time,
        constant_std=config.constant_std,
    )
    return encoder, decoder


def cvs_spec(config, n_time: int = None) -> ModelSpec:
    """Latent [z_iext, z_rtpr, z_eps]; separate conditional priors; Bernoulli
    aux classifiers."""
    n_time = n_time or config.seq_len
    blocks = (
        LatentBlock("iext", config.z_iext_dim),
        LatentBlock("rtpr", config.z_rtpr_dim),
        LatentBlock("epsilon", config.z_epsilon_dim),
    )
    encoder, decoder = _common(config, sum(b.dim for b in blocks), n_time)
    return ModelSpec(
        name="cvs",
        obs_dim=config.obs_dim,
        n_time=n_time,
        blocks=blocks,
        labels=(
            LabelSpec("iext", config.iext_dim, "bernoulli", "iext"),
            LabelSpec("rtpr", config.rtpr_dim, "bernoulli", "rtpr"),
        ),
        prior="separate",
        prior_input_order=("iext", "rtpr"),
        likelihood=_likelihood(config),
        quantile_diff=config.quantile_diff,
        aux_in_model=False,
        aux_loss_multiplier=float(config.aux_loss_multiplier),
        u_hidden_dim=config.u_hidden_dim,
        encoder=encoder,
        decoder=decoder,
    )
