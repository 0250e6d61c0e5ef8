"""The PyTorch port's proc and challenge models against the JAX package's:
``proc_spec`` and ``challenge_spec`` field by field, the parameter tree's
shapes, ``param_masks``, and at the JAX ``init_params(jax.random.key(0),
spec)`` carried across and the same standard-normal draws (``noise=``), on 4
rows of each dataset: ``elbo_main`` with its L1 metric and ``elbo_aux`` (with
and without padding rows masked out, quantile and Gauss likelihoods), their
gradients into every leaf on the ``semilinear`` (K1, K1-bwd) and
``semilinear_fused`` (K2, K3) backends, ``recon`` (posterior and prior),
``classifier``, and one shared-Adam dual step (losses, params and Adam
slots after the step).

These are the label kinds only these workloads use: the joint conditional
prior (one ``z_u`` draw over all labeled blocks, challenge's inputs in the
swapped order symptoms, shedding), the one-hot heads and
``onehot_categorical_logpmf``, the continuous heads scored by
``laplace_logpdf`` with ``softplus(aux_std) + 1e-6``, and proc's aux sites in
the main loss (``aux_in_model``), whose Adam steps the aux heads on both
losses.

The draws are JAX's ``sample_normal_ps(sub, sids, 0, 1)`` under the key
splits each JAX function makes. On the JAX side ``semilinear`` is the
associative scan and ``semilinear_fused`` the Pallas kernels in interpret
mode; on the port's side the kernels' plain versions run (CPU tensors).

Tolerances, those of ``tests/test_torch_slode_train.py``,
``tests/test_torch_slode.py`` and ``tests/test_torch_svi.py`` for the same
functions: losses 2e-6 relative, the L1 metric 1e-5 relative; gradients
max|port - JAX| / max(max|JAX|, 1) per leaf below 1e-5; recon outputs 1e-5
abs plus 1e-6 relative; classifier labels exactly; after the dual step,
Adam moments within 1e-4 of their leaf's largest value, counts exact, the
step's losses 2e-6 relative, and params within 3e-7 abs plus 0.5 % of the
learning rate. That last part is new beside ``tests/test_torch_svi.py``:
Adam divides each element's moment by that element's own root mean square,
so the gradients' float32 differences, held per leaf to 1e-5 of the leaf's
largest value, move an element whose gradient is small beside that largest
value by a visible part of its step. On challenge's encoder (largest main
gradient 1550) one element's main gradient is 0.014621 in JAX and 0.014563
in the port, and JAX's own ``semilinear_seq`` and ``semilinear_fused`` give
0.014589 and 0.014533; after the aux update, whose gradient there has the
other sign, the step differs by 2.2e-6 at lr 1e-3 (0.22 % of lr).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import LOADERS as JAX_LOADERS
from structured_latent_odes_tpu.data.loader import pad_to
from structured_latent_odes_tpu.models import challenge_spec as jax_challenge_spec
from structured_latent_odes_tpu.models import classifier as jax_classifier
from structured_latent_odes_tpu.models import elbo_aux as jax_elbo_aux
from structured_latent_odes_tpu.models import elbo_main as jax_elbo_main
from structured_latent_odes_tpu.models import init_params_fast as jax_init
from structured_latent_odes_tpu.models import param_masks as jax_param_masks
from structured_latent_odes_tpu.models import proc_spec as jax_proc_spec
from structured_latent_odes_tpu.models import recon as jax_recon
from structured_latent_odes_tpu.prob import sample_normal_ps as jax_sample
from structured_latent_odes_tpu.train import svi as jsvi
from structured_latent_odes_tpu_torch import serve
from structured_latent_odes_tpu_torch.data.configs import LOADERS
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_from_jax, params_to_jax
from structured_latent_odes_tpu_torch.models import (
    challenge_spec,
    classifier,
    elbo_aux,
    elbo_main,
    init_params,
    param_masks,
    proc_spec,
    recon,
)
from structured_latent_odes_tpu_torch.prob import l1_of_parts
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.train.driver import device_batch
from structured_latent_odes_tpu_torch.train.svi import value_and_grad
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

LOSS_RTOL = 2e-6
L1_RTOL = 1e-5
GRAD_TOL = 1e-5
RECON_ATOL, RECON_RTOL = 1e-5, 1e-6
STEP_ATOL, STEP_LR_FRAC = 3e-7, 5e-3
N = 4
DATASETS = ("proc", "challenge")
SPECS = {"proc": (jax_proc_spec, proc_spec), "challenge": (jax_challenge_spec, challenge_spec)}
N_TIME = {"proc": 100, "challenge": 142}


def _specs(dataset, model="Mechanistic", backend="semilinear"):
    jc, pc = JAX_LOADERS[dataset](), LOADERS[dataset]()
    jc.model = pc.model = model
    jc.ode_backend = pc.ode_backend = backend
    jfn, pfn = SPECS[dataset]
    return jfn(jc, n_time=N_TIME[dataset]), pfn(pc, n_time=N_TIME[dataset])


_SPLITS = {}


def _rows(dataset, masked=False):
    """The first N rows of the dataset's train split, as serve loads it; with
    ``masked``, two padding rows with a zero mask and loader sample ids."""
    if dataset not in _SPLITS:
        _SPLITS[dataset] = serve._build(dataset, LOADERS[dataset](), "cpu")[1]["train"]
    batch = {k: v[:N] for k, v in _SPLITS[dataset].items()}
    if masked:
        batch["sample_id"] = np.arange(N, dtype=np.int32) + 40
        batch = pad_to(batch, N + 2)
    return batch


@functools.lru_cache(maxsize=None)
def _jax_params(jspec):
    """The JAX ``init_params(jax.random.key(0), spec)``, once per spec."""
    return jax_init(jax.random.key(0), jspec)


def _sids(batch):
    return jnp.asarray(batch.get("sample_id", np.arange(batch["observations"].shape[0])))


def _draws(key, sids, sites):
    """One standard-normal draw per (name, dim) site, under the sequential
    ``key, sub = split(key)`` of the JAX functions."""
    noise = {}
    for name, dim in sites:
        key, sub = jax.random.split(key)
        zeros = jnp.zeros((sids.shape[0], dim))
        noise[name] = torch.tensor(np.asarray(jax_sample(sub, sids, zeros, jnp.ones_like(zeros))))
    return noise


def _main_sites(spec):
    """elbo_main's and sample_prior_z's sites under the joint prior."""
    assert spec.prior == "joint"
    return [("z_u", spec.z_u_dim), (spec.epsilon_block.name, spec.epsilon_block.dim)]


def _aux_sites(spec):
    return [(b.name, b.dim) for b in spec.labeled_blocks]


def _torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _port(params):
    return params_from_jax(jax.tree.map(np.asarray, params), device="cpu")


def _fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


@pytest.mark.parametrize("model", ["Mechanistic", "MechanisticGauss"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_specs_match_jax(dataset, model):
    """Every field of the port's spec equals the JAX spec's; the nested specs
    field by field on the port's fields (the JAX ODE spec adds its adaptive
    and auto-dispatch knobs)."""
    jspec, pspec = _specs(dataset, model)
    for name, value in _fields(pspec).items():
        ref = getattr(jspec, name)
        if dataclasses.is_dataclass(value):
            for sub, v in _fields(value).items():
                r = getattr(ref, sub)
                if dataclasses.is_dataclass(v):
                    assert _fields(v) == {k: getattr(r, k) for k in _fields(v)}, (name, sub)
                else:
                    assert v == r, (name, sub)
        elif name in ("blocks", "labels"):
            assert [dataclasses.astuple(x) for x in value] == [dataclasses.astuple(x) for x in ref], name
        else:
            assert value == ref, name
    assert pspec.decoder.ode.ode_state_dim == {"proc": 8, "challenge": 5}[dataset]
    assert pspec.latent_dim == {"proc": 50, "challenge": 15}[dataset]


@pytest.mark.parametrize("dataset", DATASETS)
def test_init_params_shapes_match_jax(dataset):
    jspec, pspec = _specs(dataset)
    ours = params_to_jax(init_params(pspec, 0, device="cpu"))
    ref = _jax_params(jspec)
    assert jax.tree.structure(ours) == jax.tree.structure(ref)
    assert [np.shape(a) for a in jax.tree.leaves(ours)] == [np.shape(b) for b in jax.tree.leaves(ref)]


@pytest.mark.parametrize("dataset", DATASETS)
def test_param_masks_match_jax(dataset):
    jspec, pspec = _specs(dataset)
    params = _jax_params(jspec)
    main, aux = param_masks(pspec, _port(params))
    for ours, ref in zip((main, aux), jax_param_masks(jspec, params)):
        assert tree_leaves(ours) == [bool(x) for x in jax.tree.leaves(ref)]
    # proc scores its aux heads in the main loss too (aux_in_model)
    assert all(tree_leaves(main["aux"]) + tree_leaves(main["aux_std"])) == (dataset == "proc")


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("model", ["Mechanistic", "MechanisticGauss"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_losses_match_jax(dataset, model, masked):
    jspec, pspec = _specs(dataset, model)
    params = _jax_params(jspec)
    batch = _rows(dataset, masked)
    ts = np.arange(N_TIME[dataset], dtype=np.float32)
    k1, k2 = jax.random.key(3), jax.random.key(4)
    ref_m, ref_mets = jax.jit(lambda q, b: jax_elbo_main(jspec, q, k1, b, ts))(params, _jax(batch))
    ref_a = jax.jit(lambda q, b: jax_elbo_aux(jspec, q, k2, b))(params, _jax(batch))
    p, sids = _port(params), _sids(batch)
    loss_m, mets = elbo_main(pspec, p, 0, _torch(batch), ts, noise=_draws(k1, sids, _main_sites(jspec)))
    loss_a = elbo_aux(pspec, p, 0, _torch(batch), noise=_draws(k2, sids, _aux_sites(jspec)))
    np.testing.assert_allclose(float(loss_m), float(ref_m), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(l1_of_parts(*mets["l1_parts"])), float(ref_mets["l1"]), rtol=L1_RTOL)
    np.testing.assert_allclose(float(loss_a), float(ref_a), rtol=LOSS_RTOL)


def _assert_grads_close(ours, ref_tree, what):
    ref = tree_leaves(_port(ref_tree))
    ours = tree_leaves(ours)
    assert len(ours) == len(ref)
    for i, (g, r) in enumerate(zip(ours, ref)):
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err < GRAD_TOL, (what, i, tuple(r.shape), err)


@pytest.mark.parametrize("backend", ["semilinear", "semilinear_fused"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_loss_gradients_match_jax(dataset, backend):
    """Gradients of both losses into every leaf, through K1/K1-bwd or K2/K3
    (their plain versions here) against jax.grad; padding rows masked."""
    jspec, pspec = _specs(dataset, backend=backend)
    params = _jax_params(jspec)
    batch = _rows(dataset, masked=True)
    ts = np.arange(N_TIME[dataset], dtype=np.float32)
    k1, k2 = jax.random.key(3), jax.random.key(4)
    jb = _jax(batch)
    ref_m = jax.jit(jax.grad(lambda q: jax_elbo_main(jspec, q, k1, jb, ts)[0]))(params)
    ref_a = jax.jit(jax.grad(lambda q: jax_elbo_aux(jspec, q, k2, jb)))(params)
    p, tb, sids = _port(params), _torch(batch), _sids(batch)
    noise_m, noise_a = _draws(k1, sids, _main_sites(jspec)), _draws(k2, sids, _aux_sites(jspec))
    _, _, g_m = value_and_grad(lambda q: elbo_main(pspec, q, 0, tb, ts, noise=noise_m), p)
    _, _, g_a = value_and_grad(lambda q: elbo_aux(pspec, q, 0, tb, noise=noise_a), p)
    _assert_grads_close(g_m, ref_m, "elbo_main")
    _assert_grads_close(g_a, ref_a, "elbo_aux")
    aux_grads = tree_leaves(g_m["aux"]) + tree_leaves(g_m["aux_std"])
    assert any(float(g.abs().max()) > 0 for g in aux_grads) == (dataset == "proc")


@pytest.mark.parametrize("is_post", [True, False], ids=["posterior", "prior"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_recon_matches_jax(dataset, is_post):
    jspec, pspec = _specs(dataset)
    params = _jax_params(jspec)
    batch = _rows(dataset, masked=True)
    ts = np.arange(N_TIME[dataset], dtype=np.float32)
    key = jax.random.key(7)
    ref = jax.jit(lambda q, b: jax_recon(jspec, q, key, b, ts, is_post))(params, _jax(batch))
    sids = _sids(batch)
    if is_post:  # recon's own split, then sample_prior_z's
        noise = _draws(key, sids, [("z", jspec.latent_dim)])
    else:
        noise = _draws(jax.random.split(key)[1], sids, _main_sites(jspec))
    out = recon(pspec, _port(params), 0, _torch(batch), ts, is_post, noise=noise)
    assert set(out) == set(ref)
    assert out["solution_xt"].shape == (N + 2, N_TIME[dataset], pspec.decoder.ode.ode_state_dim)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RECON_RTOL, atol=RECON_ATOL, err_msg=k)


@pytest.mark.parametrize("dataset", DATASETS)
def test_classifier_matches_jax(dataset):
    jspec, pspec = _specs(dataset)
    params = _jax_params(jspec)
    obs = _rows(dataset)["observations"]
    key = jax.random.key(11)
    ref = jax.jit(lambda q, o: jax_classifier(jspec, q, key, o))(params, jnp.asarray(obs))
    dims = {b.name: b.dim for b in jspec.blocks}
    noise = _draws(key, jnp.arange(N), [(label.name, dims[label.block]) for label in jspec.labels])
    out = classifier(pspec, _port(params), 0, torch.from_numpy(obs), noise=noise)
    assert set(out) == set(ref) == {label.name for label in pspec.labels}
    for name in ref:
        if name in ("C12", "C6"):  # the continuous heads' regressed loc
            np.testing.assert_allclose(out[name].numpy(), np.asarray(ref[name]), rtol=RECON_RTOL, atol=RECON_ATOL)
        else:
            np.testing.assert_array_equal(out[name].numpy(), np.asarray(ref[name]))


@pytest.mark.parametrize("dataset", DATASETS)
def test_dual_step_matches_jax(dataset):
    """One shared-Adam dual step at the config's learning rate on N rows
    padded to 6 (the loader's mask): losses, params, Adam slots and counts.
    proc's aux heads are stepped by both losses (count 2), challenge's by the
    aux loss only."""
    jspec, pspec = _specs(dataset)
    lr = LOADERS[dataset]().learning_rate
    params = _jax_params(jspec)
    batch = {k: v[0] for k, v in stacked_minibatches(_rows(dataset), N + 2, shuffle=False).items()}
    ts = np.arange(float(N_TIME[dataset]), dtype=np.float32)
    joptim = jsvi.make_dual_optimizer(jspec, params, lr, "shared")
    jstate = jsvi.SVIState(params, joptim.init(params), jax.random.key(5))
    _, k1, k2 = jax.random.split(jstate.key, 3)
    sids = jnp.asarray(batch["sample_id"])
    noise = {"main": [_draws(k1, sids, _main_sites(jspec))], "aux": [_draws(k2, sids, _aux_sites(jspec))]}
    jstate, jmets = jax.jit(jsvi.make_dual_step(jspec, jnp.asarray(ts), joptim))(jstate, _jax(batch))
    init_state, pstep, _ = svi.make_train_step(pspec, torch.from_numpy(ts), lr, _port(params))
    pstate, pmets = pstep(init_state(_port(params), 0), device_batch(batch, "cpu"), noise=noise)
    for k in ("loss_main", "loss_aux", "l1"):
        np.testing.assert_allclose(float(pmets[k]), float(jmets[k]), rtol=LOSS_RTOL, err_msg=k)
    for p, r in zip(tree_leaves(pstate.params), tree_leaves(_port(jstate.params))):
        np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=0, atol=STEP_ATOL + STEP_LR_FRAC * lr)
    assert tree_leaves(pstate.opt.count) == [int(c) for c in jax.tree.leaves(jstate.opt.count)]
    for ours, ref in ((pstate.opt.mu, jstate.opt.mu), (pstate.opt.nu, jstate.opt.nu)):
        for a, b in zip(tree_leaves(ours), tree_leaves(_port(ref))):
            assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)
    aux_counts = set(tree_leaves(pstate.opt.count["aux"]) + tree_leaves(pstate.opt.count["aux_std"]))
    assert aux_counts == {2 if dataset == "proc" else 1}
