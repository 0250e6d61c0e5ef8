from structured_latent_odes_tpu_torch.models.slode import (
    classifier,
    encode,
    init_params,
    prior_params,
    recon,
    sample_prior_z,
)
from structured_latent_odes_tpu_torch.models.spec import LabelSpec, LatentBlock, ModelSpec
from structured_latent_odes_tpu_torch.models.zoo import cvs_spec

__all__ = [
    "LabelSpec",
    "LatentBlock",
    "ModelSpec",
    "classifier",
    "cvs_spec",
    "encode",
    "init_params",
    "prior_params",
    "recon",
    "sample_prior_z",
]
