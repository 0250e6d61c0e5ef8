from structured_latent_odes_tpu_torch.prob.distributions import (
    bernoulli_logpmf,
    fold_seed,
    kl_normal_normal,
    laplace_logpdf,
    normal_logpdf,
    onehot_categorical_logpmf,
    sample_normal_ps,
    seed_tensor,
    standard_normal_ps,
    sum_event,
)
from structured_latent_odes_tpu_torch.prob.elbo import Trace, masked_l1_per_channel, quantile_laplace_logprob

__all__ = [
    "Trace",
    "bernoulli_logpmf",
    "fold_seed",
    "kl_normal_normal",
    "laplace_logpdf",
    "masked_l1_per_channel",
    "normal_logpdf",
    "onehot_categorical_logpmf",
    "quantile_laplace_logprob",
    "sample_normal_ps",
    "seed_tensor",
    "standard_normal_ps",
    "sum_event",
]
