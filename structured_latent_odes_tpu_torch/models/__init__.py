from structured_latent_odes_tpu_torch.models.slode import (
    classifier,
    elbo_aux,
    elbo_main,
    encode,
    init_params,
    param_masks,
    prior_params,
    recon,
    sample_prior_z,
)
from structured_latent_odes_tpu_torch.models.spec import LabelSpec, LatentBlock, ModelSpec
from structured_latent_odes_tpu_torch.models.zoo import challenge_spec, cvs_spec, proc_spec

__all__ = [
    "LabelSpec",
    "LatentBlock",
    "ModelSpec",
    "challenge_spec",
    "classifier",
    "cvs_spec",
    "elbo_aux",
    "elbo_main",
    "encode",
    "init_params",
    "param_masks",
    "prior_params",
    "proc_spec",
    "recon",
    "sample_prior_z",
]
