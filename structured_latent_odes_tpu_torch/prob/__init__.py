from structured_latent_odes_tpu_torch.prob.distributions import sample_normal_ps, standard_normal_ps

__all__ = ["sample_normal_ps", "standard_normal_ps"]
