"""Declarative model specs (a copy of the JAX package's ``models/spec.py``):
ordered latent blocks, system-input labels with their aux-head kinds, the
conditional-prior wiring and the likelihood family."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from structured_latent_odes_tpu_torch.nn.decoders import DecoderSpec
from structured_latent_odes_tpu_torch.nn.layers import ConvEncoderSpec, MLPSpec


@dataclasses.dataclass(frozen=True)
class LatentBlock:
    """A named slice of the latent vector (e.g. z_iext, z_rtpr, z_epsilon)."""

    name: str
    dim: int


@dataclasses.dataclass(frozen=True)
class LabelSpec:
    """A system input u tied to a latent block, with its aux head.

    kind: 'bernoulli' (sigmoid classifier head), 'onehot' (softmax head) or
    'continuous' (Laplace regressor with exp-activated loc and a learnable
    scalar std).
    """

    name: str
    dim: int
    kind: str
    block: str  # latent block this label's aux head reads from


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    obs_dim: int
    n_time: int
    blocks: Tuple[LatentBlock, ...]  # ordered; ends with the epsilon block
    labels: Tuple[LabelSpec, ...]
    # 'separate': one conditional-prior MLP per labeled block (CVS);
    # 'joint': one MLP from concat(labels) to the whole labeled z_u
    prior: str
    prior_input_order: Tuple[str, ...]
    likelihood: str  # 'quantile' | 'gaussian'
    quantile_diff: float = 0.475
    aux_in_model: bool = False
    aux_loss_multiplier: float = 46.0
    u_hidden_dim: int = 25
    encoder: Optional[ConvEncoderSpec] = None
    decoder: Optional[DecoderSpec] = None

    @property
    def epsilon_block(self) -> LatentBlock:
        return self.blocks[-1]

    @property
    def labeled_blocks(self) -> Tuple[LatentBlock, ...]:
        return self.blocks[:-1]

    @property
    def latent_dim(self) -> int:
        return sum(b.dim for b in self.blocks)

    @property
    def z_u_dim(self) -> int:
        return sum(b.dim for b in self.labeled_blocks)

    @property
    def label_input_dim(self) -> int:
        return sum(l.dim for l in self.labels)

    def block_slice(self, name: str) -> slice:
        start = 0
        for b in self.blocks:
            if b.name == name:
                return slice(start, start + b.dim)
            start += b.dim
        raise KeyError(name)

    def aux_head_spec(self, label: LabelSpec) -> MLPSpec:
        z_dim = dict((b.name, b.dim) for b in self.blocks)[label.block]
        if label.kind == "bernoulli":
            return MLPSpec(z_dim, (self.u_hidden_dim,), label.dim, "softplus", "sigmoid")
        if label.kind == "onehot":
            return MLPSpec(z_dim, (self.u_hidden_dim,), label.dim, "softplus", "softmax")
        if label.kind == "continuous":
            return MLPSpec(
                z_dim, (self.u_hidden_dim,), (label.dim, label.dim), "softplus", ("exp", "exp")
            )
        raise ValueError(label.kind)

    def prior_spec(self, block_name: Optional[str] = None) -> MLPSpec:
        """Conditional-prior MLPs: no hidden layer, (loc, exp-scale) heads."""
        if self.prior == "separate":
            label = next(l for l in self.labels if l.block == block_name)
            z_dim = dict((b.name, b.dim) for b in self.blocks)[block_name]
            return MLPSpec(label.dim, (), (z_dim, z_dim), "softplus", (None, "exp"))
        return MLPSpec(
            self.label_input_dim, (), (self.z_u_dim, self.z_u_dim), "softplus", (None, "exp")
        )
