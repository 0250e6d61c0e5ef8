from structured_latent_odes_tpu_torch.utils.config import Config

__all__ = ["Config"]
