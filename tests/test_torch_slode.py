"""The PyTorch port's model (models/slode.py) against the JAX package at the
JAX ``init_params(jax.random.key(0), cvs_spec(cfg))`` carried across and the
same standard-normal draws: ``recon`` (posterior and prior, with and without
a padding mask, quantile and Gauss likelihoods) and ``classifier``.

The draws come from JAX's own ``sample_normal_ps(sub, sids, 0, 1)`` under the
key splits that ``recon``, ``sample_prior_z`` and ``classifier`` make, and
reach the port through ``noise=``. Tolerance: 1e-5 abs plus 1e-6 relative
(8 float32 ulp) on every output. The relative part is needed: at this init
the trajectories reach |x| = 49, where float32 roundoff accumulated over 85
steps already moves the port 2.3e-5 (6 ulp) from both JAX scan backends.

The port's own sampler is checked for the property JAX's per-sample keys
have: a draw depends only on (seed, site, sample_id).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.data.loader import pad_to
from structured_latent_odes_tpu.models import classifier as jax_classifier
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.models import recon as jax_recon
from structured_latent_odes_tpu.prob import sample_normal_ps as jax_sample
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.models import classifier, cvs_spec, recon
from structured_latent_odes_tpu_torch.prob import sample_normal_ps, standard_normal_ps

TOL = 1e-5
RTOL = 1e-6
N, T = 6, 86


def _configs(model):
    jc, pc = jax_cvs_config(), load_cvs_config()
    jc.model = pc.model = model
    return jc, pc


def _batch(masked: bool):
    rng = np.random.RandomState(5)
    split = {
        "observations": rng.rand(N, 3, T).astype(np.float32),
        "iext": (rng.rand(N, 1) > 0.5).astype(np.float32),
        "rtpr": (rng.rand(N, 1) > 0.5).astype(np.float32),
    }
    if masked:  # two padded rows with a zero mask, and loader sample ids
        split["sample_id"] = np.arange(N, dtype=np.int32) + 40
        split = pad_to(split, N + 2)
    return split


def _eps(key, sids, dim):
    zeros = jnp.zeros((sids.shape[0], dim))
    return np.asarray(jax_sample(key, sids, zeros, jnp.ones_like(zeros)))


def _jax_noise(spec, key, batch, is_post):
    """The draws JAX's recon makes (slode.py recon, sample_prior_z)."""
    sids = jnp.asarray(batch.get("sample_id", np.arange(batch["observations"].shape[0])))
    key, sub = jax.random.split(key)
    if is_post:
        return {"z": _eps(sub, sids, spec.latent_dim)}
    noise = {}
    for block in spec.labeled_blocks:
        sub, s = jax.random.split(sub)
        noise[block.name] = _eps(s, sids, block.dim)
    sub, s = jax.random.split(sub)
    noise[spec.epsilon_block.name] = _eps(s, sids, spec.epsilon_block.dim)
    return noise


def _torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("is_post", [True, False], ids=["posterior", "prior"])
@pytest.mark.parametrize("model", ["Mechanistic", "MechanisticGauss"])
def test_recon_matches_jax(model, is_post, masked):
    jc, pc = _configs(model)
    jspec, pspec = jax_cvs_spec(jc), cvs_spec(pc)
    params = jax_init(jax.random.key(0), jspec)
    batch = _batch(masked)
    ts = np.arange(T, dtype=np.float32)
    key = jax.random.key(7)
    ref = jax_recon(jspec, params, key, {k: jnp.asarray(v) for k, v in batch.items()}, ts, is_post)
    noise = _torch(_jax_noise(jspec, key, batch, is_post))
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    out = recon(pspec, p, 0, _torch(batch), ts, is_post, noise=noise)
    assert set(out) == set(ref) == {"l1", "solution_xt", "mu_75", "mu_50", "mu_25", "std", "z"}
    assert out["mu_50"].shape == (batch["observations"].shape[0], 3, T)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=TOL, err_msg=k)


def test_classifier_matches_jax():
    jc, pc = _configs("Mechanistic")
    jspec, pspec = jax_cvs_spec(jc), cvs_spec(pc)
    params = jax_init(jax.random.key(0), jspec)
    obs = _batch(False)["observations"]
    key = jax.random.key(11)
    ref = jax_classifier(jspec, params, key, jnp.asarray(obs))
    dims = {b.name: b.dim for b in jspec.blocks}
    noise, k = {}, key
    for label in jspec.labels:  # the key splits of slode.py classifier
        k, sub = jax.random.split(k)
        noise[label.name] = torch.tensor(_eps(sub, jnp.arange(N), dims[label.block]))
    p = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    out = classifier(pspec, p, 0, torch.from_numpy(obs), noise=noise)
    assert set(out) == set(ref) == {"iext", "rtpr"}
    for name in ref:
        np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]))


def test_port_draws_depend_only_on_seed_site_and_sample_id():
    sids = torch.arange(10)
    full = standard_normal_ps(3, "posterior", sids, (15,))
    part = standard_normal_ps(3, "posterior", sids[4:7], (15,))
    assert torch.equal(full[4:7], part)  # batch size and position do not matter
    padded = standard_normal_ps(3, "posterior", torch.cat([sids, torch.zeros(6, dtype=torch.long)]), (15,))
    assert torch.equal(padded[:10], full)  # padding appended does not move a draw
    assert not torch.equal(standard_normal_ps(4, "posterior", sids, (15,)), full)
    assert not torch.equal(standard_normal_ps(3, "prior/iext", sids, (15,)), full)
    loc, scale = torch.full((10, 15), 2.0), torch.full((10, 15), 3.0)
    assert torch.equal(sample_normal_ps(3, "posterior", sids, loc, scale), loc + scale * full)


def test_port_draws_are_standard_normal():
    eps = standard_normal_ps(0, "posterior", torch.arange(20000), (10,)).numpy().ravel()
    assert abs(eps.mean()) < 0.01 and abs(eps.std() - 1.0) < 0.01
    # tails and symmetry of N(0, 1): P(|x| > 2) = 0.0455
    assert abs(np.mean(np.abs(eps) > 2.0) - 0.0455) < 0.003
    assert abs(np.mean(eps > 0) - 0.5) < 0.005
