"""The PyTorch port's building blocks (nn/layers.py, nn/decoders.py,
nn/init.py) against the JAX package at parameters carried across by
``interop.params_from_jax``: the activation registry, the multi-head MLP, the
conv encoder and the three decoders. Tolerance 1e-5 abs (1e-6 for the
elementwise activations). The inits are checked by their distribution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.nn import decoders as jax_dec
from structured_latent_odes_tpu.nn import layers as jax_layers
from structured_latent_odes_tpu.nn.ode_model import OdeModelSpec as JaxOdeSpec
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.nn import decoders as port_dec
from structured_latent_odes_tpu_torch.nn import init as port_init
from structured_latent_odes_tpu_torch.nn import layers as port_layers
from structured_latent_odes_tpu_torch.nn.ode_model import OdeModelSpec as PortOdeSpec

TOL = 1e-5


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize(
    "name", [None, "identity", "relu", "tanh", "sigmoid", "softplus", "exp", "softmax"]
)
def test_activations_match_jax(name):
    x = np.linspace(-40.0, 40.0, 64, dtype=np.float32).reshape(4, 16)
    ref = np.asarray(jax_layers.activation(name)(jnp.asarray(x)))
    out = port_layers.activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


MLP_SPECS = {
    "prior": dict(in_dim=1, hidden=(), out=(5, 5), activation="softplus", out_activation=(None, "exp")),
    "bernoulli_aux": dict(in_dim=5, hidden=(25,), out=1, activation="softplus", out_activation="sigmoid"),
    "onehot_aux": dict(in_dim=10, hidden=(25,), out=4, activation="softplus", out_activation="softmax"),
    "continuous_aux": dict(in_dim=10, hidden=(25, 7), out=(1, 1), activation="softplus",
                           out_activation=("exp", "exp")),
}


@pytest.mark.parametrize("kind", sorted(MLP_SPECS))
def test_mlp_apply_matches_jax(kind):
    jspec = jax_layers.MLPSpec(**MLP_SPECS[kind])
    pspec = port_layers.MLPSpec(**MLP_SPECS[kind])
    params = jax_layers.mlp_init(jax.random.key(0), jspec)
    x = np.random.RandomState(1).randn(8, jspec.in_dim).astype(np.float32)
    ref = jax_layers.mlp_apply(jspec, params, jnp.asarray(x))
    out = port_layers.mlp_apply(pspec, _port(params), torch.from_numpy(x))
    refs = (ref,) if isinstance(jspec.out, int) else ref
    outs = (out,) if isinstance(pspec.out, int) else out
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5, atol=TOL)


def test_conv_encoder_matches_jax():
    kw = dict(n_channels=3, n_time=86, n_filters=10, filter_size=10, pool_size=5,
              hidden_dim=50, latent_dim=15)
    jspec, pspec = jax_layers.ConvEncoderSpec(**kw), port_layers.ConvEncoderSpec(**kw)
    params = jax_layers.conv_encoder_init(jax.random.key(0), jspec)
    x = np.random.RandomState(2).rand(6, 3, 86).astype(np.float32)
    loc_ref, scale_ref = jax_layers.conv_encoder_apply(jspec, params, jnp.asarray(x))
    loc, scale = port_layers.conv_encoder_apply(pspec, _port(params), torch.from_numpy(x))
    assert loc.shape == scale.shape == (6, 15)
    np.testing.assert_allclose(loc.numpy(), loc_ref, rtol=0, atol=TOL)
    np.testing.assert_allclose(scale.numpy(), scale_ref, rtol=1e-5, atol=TOL)


@pytest.mark.parametrize("kind", ["quantile", "gaussian", "variance_gaussian"])
def test_decoders_match_jax(kind):
    ode_kw = dict(latent_dim=15, ode_state_dim=5, ode_hidden_dim=25)
    jspec = jax_dec.DecoderSpec(kind, JaxOdeSpec(**ode_kw), obs_dim=3, n_time=20)
    pspec = port_dec.DecoderSpec(kind, PortOdeSpec(**ode_kw), obs_dim=3, n_time=20)
    params = jax_dec.decoder_init(jax.random.key(1), jspec)
    z = np.random.RandomState(3).randn(7, 15).astype(np.float32)
    ts = np.arange(20, dtype=np.float32)
    ref = jax_dec.decoder_apply(jspec, params, jnp.asarray(z), ts)
    out = port_dec.decoder_apply(pspec, _port(params), torch.from_numpy(z), ts)
    assert len(out) == len(ref)
    assert out[0].shape == (7, 20, 5) and out[1].shape == (7, 3, 20)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=TOL)


def test_inits_by_distribution():
    gen = torch.Generator().manual_seed(0)
    W = port_init.orthogonal(gen, (10, 3, 10))  # conv (F, C, K): rows orthonormal
    flat = W.reshape(10, -1)
    np.testing.assert_allclose((flat @ flat.T).numpy(), np.eye(10), atol=1e-5)
    tall = port_init.orthogonal(gen, (50, 20))  # columns orthonormal
    np.testing.assert_allclose((tall.T @ tall).numpy(), np.eye(20), atol=1e-5)
    Wx = port_init.xavier_uniform(gen, 400, 600, gain=0.5)
    bound = 0.5 * np.sqrt(6.0 / 1000)
    assert Wx.shape == (600, 400) and float(Wx.abs().max()) <= bound
    assert abs(float(Wx.std()) - bound / np.sqrt(3)) < 0.01 * bound
    Wt, bt = port_init.torch_linear_default(gen, 100, 300)
    assert Wt.shape == (300, 100) and bt.shape == (300,)
    assert float(Wt.abs().max()) <= 0.1 and float(Wt.abs().max()) > 0.09
    Ws, bs = port_init.small_normal(gen, 300, 400)
    assert abs(float(Ws.std()) - 1e-3) < 2e-5 and abs(float(Ws.mean())) < 2e-5
    assert torch.equal(port_init.orthogonal(torch.Generator().manual_seed(5), (4, 6)),
                       port_init.orthogonal(torch.Generator().manual_seed(5), (4, 6)))
