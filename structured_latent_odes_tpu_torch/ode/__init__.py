from structured_latent_odes_tpu_torch.ode.semilinear import (
    rk_affine_coeffs,
    solve_affine_sequential,
    solve_semilinear,
    stage_time_grid,
)
from structured_latent_odes_tpu_torch.ode.tableaus import TABLEAUS, ButcherTableau, get_tableau

__all__ = [
    "ButcherTableau",
    "TABLEAUS",
    "get_tableau",
    "rk_affine_coeffs",
    "solve_affine_sequential",
    "solve_semilinear",
    "stage_time_grid",
]
