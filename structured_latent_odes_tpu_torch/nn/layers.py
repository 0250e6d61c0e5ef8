"""Neural-net building blocks as ``init(gen, spec) -> params`` and
``apply(spec, params, x) -> y`` functions on tensors (the JAX package's
``nn/layers.py``): the activation registry, linear layers, the multi-head
MLP and the conv encoder. Parameters are nested dicts and lists of
tensors with the JAX package's key names and PyTorch's ``(out, in)`` linear
layout."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from structured_latent_odes_tpu_torch.nn.init import (
    orthogonal,
    small_normal,
    torch_linear_default,
    uniform,
)
from structured_latent_odes_tpu_torch.ops.conv_encoder import conv_pool

Tensor = torch.Tensor

_ACTIVATIONS = {
    None: lambda x: x,
    "identity": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    # clipped exp for scale heads: an unclipped exp overflows at unlucky
    # seeds and NaNs the whole run; e^15 ~ 3e6 is beyond any useful scale
    "exp": lambda x: torch.exp(torch.clamp(x, -30.0, 15.0)),
    "softmax": lambda x: torch.softmax(x, dim=-1),
}


def activation(name: Optional[str]):
    try:
        return _ACTIVATIONS[name]
    except KeyError as e:
        raise ValueError(f"unknown activation {name!r}") from e


def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, *, bias: bool = True,
                init: str = "torch"):
    if init == "torch":
        W, b = torch_linear_default(gen, in_dim, out_dim)
    elif init == "orthogonal":
        W = orthogonal(gen, (out_dim, in_dim))
        _, b = torch_linear_default(gen, in_dim, out_dim)
    else:
        raise ValueError(init)
    p = {"W": W}
    if bias:
        p["b"] = b
    return p


def linear_apply(params, x: Tensor) -> Tensor:
    return F.linear(x, params["W"], params.get("b"))


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """Declarative MLP: ``in_dim -> hidden... -> head(s)``.

    ``out`` is an int (single head) or a tuple of ints (multi-head);
    ``out_activation`` is one name or a per-head tuple. Hidden layers use the
    N(0, 0.001) init and ``activation`` after each.
    """

    in_dim: int
    hidden: Tuple[int, ...]
    out: Union[int, Tuple[int, ...]]
    activation: str = "softplus"
    out_activation: Union[None, str, Tuple[Optional[str], ...]] = None

    @property
    def heads(self) -> Tuple[int, ...]:
        return (self.out,) if isinstance(self.out, int) else tuple(self.out)

    @property
    def head_activations(self) -> Tuple[Optional[str], ...]:
        oa = self.out_activation
        if oa is None or isinstance(oa, str):
            return (oa,) * len(self.heads)
        return tuple(oa)


def mlp_init(gen: torch.Generator, spec: MLPSpec):
    params = {"hidden": [], "heads": []}
    sizes = (spec.in_dim,) + spec.hidden
    for i in range(len(spec.hidden)):
        W, b = small_normal(gen, sizes[i], sizes[i + 1])
        params["hidden"].append({"W": W, "b": b})
    for out_dim in spec.heads:
        W, b = torch_linear_default(gen, sizes[-1], out_dim)
        params["heads"].append({"W": W, "b": b})
    return params


def mlp_apply(spec: MLPSpec, params, *inputs: Tensor):
    """Concatenates the inputs on the last dim and runs hidden layers and
    heads. Returns one tensor for an int ``out``, else a tuple of heads."""
    x = inputs[0] if len(inputs) == 1 else torch.cat(inputs, dim=-1)
    act = activation(spec.activation)
    for layer in params["hidden"]:
        x = act(linear_apply(layer, x))
    outs = tuple(
        activation(a)(linear_apply(head, x))
        for head, a in zip(params["heads"], spec.head_activations)
    )
    return outs[0] if isinstance(spec.out, int) else outs


@dataclasses.dataclass(frozen=True)
class ConvEncoderSpec:
    n_channels: int
    n_time: int
    n_filters: int = 10
    filter_size: int = 10
    pool_size: int = 5
    hidden_dim: int = 50
    latent_dim: int = 15

    @property
    def n_conv(self) -> int:
        return self.n_time - (self.filter_size - 1)

    @property
    def n_pool(self) -> int:
        return self.n_conv - (self.pool_size - 1)

    @property
    def flat_dim(self) -> int:
        return self.n_pool * self.n_filters


def conv_encoder_init(gen: torch.Generator, spec: ConvEncoderSpec):
    conv_W = orthogonal(gen, (spec.n_filters, spec.n_channels, spec.filter_size))
    conv_b = uniform(gen, (spec.n_filters,), 1.0 / (spec.n_channels * spec.filter_size) ** 0.5)
    return {
        "conv_W": conv_W,
        "conv_b": conv_b,
        "lin": linear_init(gen, spec.flat_dim, spec.hidden_dim, init="orthogonal"),
        "z_loc": linear_init(gen, spec.hidden_dim, spec.latent_dim),
        "z_scale": linear_init(gen, spec.hidden_dim, spec.latent_dim),
    }


def conv_encoder_apply(spec: ConvEncoderSpec, params, x: Tensor) -> Tuple[Tensor, Tensor]:
    """x: (B, K, T) observations -> (z_loc, z_scale), each (B, latent_dim).

    conv1d (VALID) -> avgpool (stride 1) -> filter-major flatten -> linear ->
    tanh -> loc head and clipped-exp scale head. The first three are one op,
    ``ops/conv_encoder.py::conv_pool`` (its kernels on the card).
    """
    y = conv_pool(x, params["conv_W"], params["conv_b"], spec.pool_size)
    h = torch.tanh(linear_apply(params["lin"], y))
    z_loc = linear_apply(params["z_loc"], h)
    z_scale = torch.exp(torch.clamp(linear_apply(params["z_scale"], h), -30.0, 15.0))
    return z_loc, z_scale
