"""CVS workload (the JAX package's ``training_cvs.py``). This slice holds
``build_splits``, which serving uses; the training loop is the next slice
(ROADMAP A9)."""

from __future__ import annotations

from structured_latent_odes_tpu_torch.data import cvs as cvs_data
from structured_latent_odes_tpu_torch.data.loader import normalize_split, to_model_layout
from structured_latent_odes_tpu_torch.data.transforms import create_transforms


def build_splits(config, device="cuda"):
    """Normalized splits in the model layout ``(N, K, T)``, and the norm
    params. ``device`` is where a missing dataset is generated."""
    if config.get("reference_data_dir"):
        raise NotImplementedError(
            "reading the reference's torch pickles (reference_data_dir) is not "
            "ported yet (ROADMAP A8)"
        )
    splits, norm_params = cvs_data.load_splits(config, device=device)
    transforms = create_transforms(config.norm, norm_params)
    out = {name: to_model_layout(normalize_split(split, transforms)) for name, split in splits.items()}
    return out, norm_params
