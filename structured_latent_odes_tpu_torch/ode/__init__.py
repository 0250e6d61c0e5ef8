from structured_latent_odes_tpu_torch.ode.adjoint import odeint_adaptive_adjoint, odeint_adjoint
from structured_latent_odes_tpu_torch.ode.semilinear import (
    rk_affine_coeffs,
    solve_affine_sequential,
    solve_semilinear,
    stage_time_grid,
)
from structured_latent_odes_tpu_torch.ode.solvers import (
    odeint,
    odeint_adaptive,
    odeint_adaptive_per_sample,
    rk_step,
    solve,
)
from structured_latent_odes_tpu_torch.ode.tableaus import TABLEAUS, ButcherTableau, get_tableau

__all__ = [
    "ButcherTableau",
    "TABLEAUS",
    "get_tableau",
    "odeint",
    "odeint_adaptive",
    "odeint_adaptive_adjoint",
    "odeint_adaptive_per_sample",
    "odeint_adjoint",
    "rk_affine_coeffs",
    "rk_step",
    "solve",
    "solve_affine_sequential",
    "solve_semilinear",
    "stage_time_grid",
]
