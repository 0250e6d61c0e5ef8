"""Explicit Trace-ELBO (the JAX package's ``prob/elbo.py``).

Pyro's ``Trace_ELBO`` with fully reparameterized sites computes::

    elbo = sum_obs scale_site * log p(obs | ...)
         + sum_latent scale_site * (log p(z) - log q(z))     [at the sample]

the "MC KL" form, evaluated at the reparameterized sample and not
analytically, which matters for gradient parity. :class:`Trace` accumulates
the per-sample terms of a fixed DAG of sites; ``scale=`` is
``poutine.scale``; a batch axis is kept so padded samples can be masked out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from structured_latent_odes_tpu_torch.prob.distributions import laplace_logpdf, normal_logpdf, sum_event

Tensor = torch.Tensor


class Trace:
    """Accumulates per-sample log-prob terms of a model/guide pair.

    Every ``add*`` method takes tensors whose leading axis is the batch; the
    trailing event dims are summed. ``loss(mask)`` is minus the ELBO summed
    over the unmasked samples (a scalar).
    """

    def __init__(self) -> None:
        self._terms = []  # (B,) tensors

    def add(self, logp: Tensor, scale=1.0, event_dims: int = 1) -> None:
        self._terms.append(scale * sum_event(logp, event_dims))

    def latent_normal(self, z: Tensor, q_loc: Tensor, q_scale: Tensor, p_loc: Tensor,
                      p_scale: Tensor, scale=1.0) -> None:
        """Reparameterized latent site: contributes log p(z) - log q(z)."""
        logp = normal_logpdf(z, p_loc, p_scale)
        logq = normal_logpdf(z, q_loc, q_scale)
        self.add(logp - logq, scale=scale)

    def model_sampled_normal(self, z: Tensor, loc: Tensor, scale_: Tensor, scale=1.0) -> None:
        """Site sampled in the model with no guide counterpart (the
        reference's ``model_meta``): contributes ``+log p(z)`` at the
        reparameterized sample."""
        self.add(normal_logpdf(z, loc, scale_), scale=scale)

    def obs(self, logp: Tensor, scale=1.0, event_dims: int = 1) -> None:
        self.add(logp, scale=scale, event_dims=event_dims)

    def per_sample(self) -> Tensor:
        return sum(self._terms)

    def elbo(self, mask: Optional[Tensor] = None) -> Tensor:
        ps = self.per_sample()
        if mask is not None:
            ps = ps * mask
        return torch.sum(ps)

    def loss(self, mask: Optional[Tensor] = None) -> Tensor:
        return -self.elbo(mask)


def quantile_laplace_logprob(target: Tensor, mu: Tensor, std: Tensor, tau) -> Tensor:
    """Elementwise asymmetric-Laplace quantile log-likelihood: elements with
    ``target >= mu`` weigh ``tau``, the others ``1 - tau`` (the reference's
    ``masked_select`` + ``poutine.scale`` split as a static weighting)."""
    w = torch.where(target >= mu, tau, 1.0 - tau)
    return w * laplace_logpdf(target, mu, std)


def masked_l1_parts(target: Tensor, mu: Tensor, sample_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The side-channel L1's numerator and denominator per channel: the sum
    of the absolute errors over the elements where ``target >= mu``, and the
    count of those elements. Shapes ``(B, K, T)`` -> ``(K,)``, ``(K,)``. Sums
    over the batch, so ranks holding slices of one batch add theirs."""
    mask = (target >= mu).to(target.dtype)
    if sample_mask is not None:
        mask = mask * sample_mask[:, None, None]
    abs_err = torch.abs(target - mu) * mask
    return torch.sum(abs_err, dim=(0, 2)), torch.sum(mask, dim=(0, 2))


def l1_of_parts(num: Tensor, den: Tensor) -> Tensor:
    """The L1 metric from its parts (``(..., K)`` each): per channel the
    ratio, summed over channels."""
    return torch.sum(num / torch.clamp(den, min=1.0), dim=-1)


def masked_l1_per_channel(target: Tensor, mu: Tensor, sample_mask: Optional[Tensor] = None) -> Tensor:
    """The reference's side-channel L1: per channel, the mean absolute error
    over the elements where ``target >= mu``, summed over channels. Shapes
    ``(B, K, T)``."""
    return l1_of_parts(*masked_l1_parts(target, mu, sample_mask))
