"""Aggregate metrics over the ``.npy`` artifacts (the JAX package's
``eval``, numpy only; figures are not ported yet, ROADMAP A11-rest)."""

from structured_latent_odes_tpu_torch.eval.metrics import (  # noqa: F401
    challenge_outcome_averaged_l1,
    cvs_class_averaged_l1,
    cvs_ground_truth_l1,
    load_artifacts,
    synbio_device_averaged_l1,
    synbio_heldout_l1,
    synbio_heldout_l1_per_condition,
)
