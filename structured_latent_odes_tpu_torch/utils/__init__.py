from structured_latent_odes_tpu_torch.utils.config import Config
from structured_latent_odes_tpu_torch.utils.rng import set_seed

__all__ = ["Config", "set_seed"]
