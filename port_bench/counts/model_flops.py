"""The model's floating-point operations per trajectory, from the
configuration's shapes and the model's equations (``port_bench/reference/
model.py``), whichever path computes them: a multiply-add is two; the
elementwise work of the likelihood, the activations and the Runge-Kutta
updates is one per operation; nothing recomputed is counted. A backward pass
is counted as twice its forward (a product's two cotangents).

- ``main``: the main loss's forward (encoder, conditional priors, label heads
  where the model scores them, the ODE solve, the band heads, the quantile
  likelihood of three bands);
- ``aux``: the aux loss's forward (encoder, label heads);
- ``recon``: a reconstruction (encoder, solve, band heads);
- ``classify``: the classifier (encoder, label heads);
- ``dual_step``: both losses forward and backward;
- ``eval``: one evaluation pass (both losses, a recon, the classifier).
"""

from __future__ import annotations

from typing import Dict

from port_bench.reference.model import TABLEAUS


def per_trajectory(cfg: Dict, n_time: int) -> Dict[str, float]:
    c, m = cfg["config"], cfg["model"]
    K, Fn, W, P = int(c["obs_dim"]), int(c["n_filters"]), int(c["filter_size"]), int(c["pool_size"])
    Hc, D, H, U = int(c["cnn_hidden_dim"]), int(c["ode_state_dim"]), int(c["ode_hidden_dim"]), int(c["u_hidden_dim"])
    T = n_time
    blocks = dict((b, int(d)) for b, d in m["blocks"])
    L = sum(blocks.values())
    n_conv = T - W + 1
    n_pool = n_conv - P + 1
    encoder = 2 * Fn * K * W * n_conv + Fn * n_pool * P + 2 * n_pool * Fn * Hc + Hc + 2 * 2 * Hc * L + L
    S = len(TABLEAUS[c["solver"]][0])
    solve = (2 * L * H + 2 * H * D  # x0
             + 2 * L * H  # the latent's part of the hidden layer
             + (T - 1) * S * (2 * H + H + 4 * H * D + 2 * D)  # per stage: time term, relu, two heads, sigmoids
             + (T - 1) * (3 * S * D + 2 * D))  # the stages' and the step's updates
    bands = 3 * 2 * T * D * K
    likelihood = 3 * 8 * T * K
    labels = [(n, int(d), k, b) for n, d, k, b in m["labels"]]
    heads = sum(2 * blocks[b] * U + U + 2 * U * d * (2 if k == "continuous" else 1) + 4 * d for _, d, k, b in labels)
    if m["prior"] == "separate":
        priors = sum(2 * 2 * d * blocks[b] for _, d, _, b in labels)
    else:
        priors = 2 * 2 * sum(d for _, d, _, _ in labels) * (L - list(blocks.values())[-1])
    draws = 6 * L
    main = encoder + priors + draws + solve + bands + likelihood + (heads if m["aux_in_model"] else 0)
    aux = encoder + draws + heads
    recon = encoder + draws + solve + bands
    classify = encoder + draws + heads
    return {"main": main, "aux": aux, "recon": recon, "classify": classify,
            "dual_step": 3 * (main + aux), "eval": main + aux + recon + classify}
