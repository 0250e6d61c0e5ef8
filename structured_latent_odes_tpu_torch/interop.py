"""Carry parameters between the JAX package's param pytree and the port.

Both packages hold the same nested dicts and lists under the same key names
(``models/slode.py::init_params`` in each). The JAX tree arrives here as
nested dicts and lists of numpy arrays (``jax.tree.map(np.asarray, params)``,
or ``train/checkpoint.py::restore``). The map from each JAX leaf path to its
port parameter is 1:1, at the same path:

=====================================  ===============  ===============  ==========
JAX leaf path                          JAX layout       port layout      transform
=====================================  ===============  ===============  ==========
``.../['W']`` (every linear layer)     ``(in, out)``    ``(out, in)``    transpose
``['encoder']/['conv_W']``             ``(F, C, K)``    ``(F, C, K)``    none
every other leaf (biases ``['b']``,    unchanged        unchanged        none
``['encoder']/['conv_b']``,
``['decoder']/['constant_std']``,
``['aux_std']/[label]``)
=====================================  ===============  ===============  ==========

The linear weights named ``W`` are those of ``['encoder']/['lin'|'z_loc'|
'z_scale']``, ``['decoder']/['ode'|'std_ode']/['latent_to_ode']/[i]``,
``.../['dyn_hidden']`` (JAX row 0, the time weight, becomes port column 0),
``.../['prod'|'degr']``, the decoder heads ``['decoder']/['q50'|'q75'|'q25'|
'mean'|'std']`` and the MLPs under ``['priors']`` and ``['aux']``
(``['hidden']/[i]`` and ``['heads']/[i]``). Every leaf is float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _map(tree, leaf_fn, key=None):
    if isinstance(tree, dict):
        return {k: _map(v, leaf_fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, leaf_fn) for v in tree]
    return leaf_fn(key, tree)


def params_from_jax(tree, device="cuda"):
    """JAX-layout numpy tree -> the port's tensors on ``device``."""

    def leaf(key, x):
        x = np.asarray(x, dtype=np.float32)
        if key == "W":
            x = x.T
        return torch.tensor(np.ascontiguousarray(x), device=device)

    return _map(tree, leaf)


def params_to_jax(params):
    """The port's tensors -> JAX-layout numpy tree (float32, host)."""

    def leaf(key, x):
        x = x.detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(x.T if key == "W" else x)

    return _map(params, leaf)
