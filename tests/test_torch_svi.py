"""The PyTorch port's SVI engine (train/svi.py) against the JAX package's
(train/svi.py): the shared per-parameter Adam over several updates with
masks, per-leaf ``lr_scales`` and a per-batch ``lr_scale``; one and two dual
steps of ``make_train_step``'s step against JAX's ``make_dual_step`` at equal
params and equal draws (params and Adam slots after each step), with one and
two particles, the ``split`` optimizer, the ``aux_mult``/``lr_scale`` batch
overrides and the prior-lr multiplier; and ``make_eval_epoch`` against the
``eval_split`` host loop, as the JAX package tests its own.

The draws are JAX's ``sample_normal_ps`` under the key splits of JAX's step
(``split(state.key, 3)``, one key per loss, ``split(k, P)`` per particle),
handed to the port through ``noise=``.

Tolerances: Adam on given gradients 1e-6 relative + 1e-7 abs (the same
float32 update; ``1 - b**t`` may differ by an ulp). After dual steps: params
within 3e-7 abs (the update is lr 1e-3 times m_hat / sqrt(v_hat), which the
gradients' float32 differences move by far less than lr; measured 3e-8, an
ulp of |param| < 1), moments within 1e-4 of their leaf's largest value (they
carry the gradients' own float32 differences; measured up to 1.1e-5, on a
leaf whose gradients are small beside the others'), counts exact; the step's losses within 2e-6 relative (measured 2e-7). Eval epoch vs host
loop: 2e-5 relative, as the JAX package's own test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.prob import sample_normal_ps as jax_sample
from structured_latent_odes_tpu.train import svi as jsvi
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.data.loader import stacked_minibatches
from structured_latent_odes_tpu_torch.interop import params_from_jax
from structured_latent_odes_tpu_torch.models import cvs_spec, param_masks
from structured_latent_odes_tpu_torch.train import svi
from structured_latent_odes_tpu_torch.train.driver import device_batch, eval_split, read_epoch
from structured_latent_odes_tpu_torch.utils.tree import tree_leaves
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

T = 16
LR = 1e-3


def _specs(model="Mechanistic"):
    jc, pc = jax_cvs_config(), load_cvs_config()
    jc.model = pc.model = model
    return jax_cvs_spec(jc, n_time=T), cvs_spec(pc, n_time=T)


def _split(n, seed):
    r = np.random.RandomState(seed)
    return {
        "observations": r.rand(n, 3, T).astype(np.float32),
        "iext": (r.rand(n, 1) > 0.5).astype(np.float32),
        "rtpr": (r.rand(n, 1) > 0.5).astype(np.float32),
    }


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


def test_shared_adam_matches_jax():
    """Three dual updates of the shared Adam on given gradients: a leaf
    stepped by both losses, leaves stepped by one, per-leaf lr_scales and a
    per-batch lr scale (a 0-d tensor, as a stacked batch carries it)."""
    rng = np.random.RandomState(0)
    params = {"enc": rng.randn(3, 2), "dec": rng.randn(4), "aux": rng.randn(2)}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    main_mask = {"enc": True, "dec": True, "aux": False}
    aux_mask = {"enc": True, "dec": False, "aux": True}
    lr_scales = {"enc": 1.0, "dec": 3.0, "aux": 1.0}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    js, ts = jsvi.shared_adam_init(jp), svi.shared_adam_init(tp)
    for i in range(3):
        sc = 0.5 + 0.25 * i
        for mask, seed in ((main_mask, i), (aux_mask, 10 + i)):
            g = {k: np.random.RandomState(seed).randn(*v.shape).astype(np.float32) for k, v in params.items()}
            jp, js = jsvi.shared_adam_update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, mask,
                                            LR * jnp.float32(sc), lr_scales=lr_scales)
            tp, ts = svi.shared_adam_update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, mask,
                                            LR * torch.tensor(sc), lr_scales=lr_scales)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6, atol=1e-7)
        assert ts.count[k] == int(js.count[k])
    assert ts.count == {"enc": 6, "dec": 3, "aux": 3}


def _eps(key, sids, dim):
    zeros = jnp.zeros((sids.shape[0], dim))
    return torch.tensor(np.asarray(jax_sample(key, sids, zeros, jnp.ones_like(zeros))))


def _loss_noise(spec, key, sids, blocks):
    noise = {}
    for block in blocks:
        key, sub = jax.random.split(key)
        noise[block.name] = _eps(sub, sids, block.dim)
    return noise


def _step_noise(spec, key, batch, particles):
    """The draws of one JAX dual step from ``state.key``."""
    _, k1, k2 = jax.random.split(key, 3)
    sids = jnp.asarray(batch["sample_id"])

    def per_particle(k):
        return list(jax.random.split(k, particles)) if particles > 1 else [k]

    return {
        "main": [_loss_noise(spec, k, sids, spec.blocks) for k in per_particle(k1)],
        "aux": [_loss_noise(spec, k, sids, spec.labeled_blocks) for k in per_particle(k2)],
    }


def _assert_state_close(pspec, port_state, jax_state, split, what):
    for p, r in zip(tree_leaves(port_state.params), tree_leaves(_port(jax_state.params))):
        np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=0, atol=3e-7, err_msg=what)
    if split:  # two optax.masked(adam) chains: moments of the masked-in leaves, one count each
        masks = param_masks(pspec, port_state.params)
        for mask, ours, ref in zip(masks, port_state.opt, jax_state.opt):
            adam = ref.inner_state[0]
            keep = tree_leaves(mask)
            pairs = [(tree_leaves(ours.mu), tree_leaves(_port(adam.mu))),
                     (tree_leaves(ours.nu), tree_leaves(_port(adam.nu)))]
            counts = {c for c, k in zip(tree_leaves(ours.count), keep) if k}
            assert counts == {int(adam.count)}, what
    else:
        ref = jax_state.opt
        pairs = [(tree_leaves(port_state.opt.mu), tree_leaves(_port(ref.mu))),
                 (tree_leaves(port_state.opt.nu), tree_leaves(_port(ref.nu)))]
        keep = [True] * len(pairs[0][0])
        assert tree_leaves(port_state.opt.count) == [int(c) for c in jax.tree.leaves(ref.count)], what
    for ours, ref in pairs:
        ours = [o for o, k in zip(ours, keep) if k]
        assert len(ours) == len(ref), what
        for a, b in zip(ours, ref):
            assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30), what


CASES = {
    "shared": dict(),
    "particles2": dict(num_particles=2),
    "split": dict(optimizer="split"),
    "overrides": dict(aux_mult=92.0, lr_scale=0.5, prior_lr_mult=3.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_steps_match_jax(case):
    """Two dual steps on two batches (the second padded and masked); state
    compared after each."""
    opts = CASES[case]
    particles = opts.get("num_particles", 1)
    optimizer = opts.get("optimizer", "shared")
    prior_lr_mult = opts.get("prior_lr_mult", 1.0)
    jspec, pspec = _specs()
    params = jax_init(jax.random.key(0), jspec)
    stack = stacked_minibatches(_split(7, 1), 4, shuffle=False)
    batches = [{k: v[i] for k, v in stack.items()} for i in range(2)]
    for b in batches:
        for name in ("aux_mult", "lr_scale"):
            if name in opts:
                b[name] = np.float32(opts[name])
    ts = np.arange(float(T), dtype=np.float32)

    joptim = jsvi.make_dual_optimizer(jspec, params, LR, optimizer, prior_lr_mult=prior_lr_mult)
    jstep = jsvi.make_dual_step(jspec, jnp.asarray(ts), joptim, particles)
    jstate = jsvi.SVIState(params, joptim.init(params), jax.random.key(5))
    init_state, pstep, _ = svi.make_train_step(pspec, torch.from_numpy(ts), LR, _port(params),
                                               num_particles=particles, optimizer=optimizer,
                                               prior_lr_mult=prior_lr_mult)
    pstate = init_state(_port(params), 0)
    for i, batch in enumerate(batches):
        noise = _step_noise(jspec, jstate.key, batch, particles)
        jstate, jmets = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        pstate, pmets = pstep(pstate, device_batch(batch, "cpu"), noise=noise)
        for k in ("loss_main", "loss_aux", "l1"):
            np.testing.assert_allclose(float(pmets[k]), float(jmets[k]), rtol=2e-6, err_msg=f"{k} step {i}")
        _assert_state_close(pspec, pstate, jstate, optimizer == "split", f"{case} step {i}")
    assert pstate.step == 2


def test_train_epoch_steps_through_stacked_batches():
    """train_epoch is train_step over the stacked batches, in order."""
    _, pspec = _specs()
    params = _port(jax_init(jax.random.key(0), _specs()[0]))
    ts = torch.arange(float(T))
    init_state, step, epoch = svi.make_train_step(pspec, ts, LR, params)
    stack = device_batch(stacked_minibatches(_split(7, 1), 4, shuffle=False), "cpu")
    s_epoch, mets = epoch(init_state(params, 3), stack)
    s_step = init_state(params, 3)
    for i in range(2):
        s_step, m = step(s_step, {k: v[i] for k, v in stack.items()})
        assert float(m["loss_main"]) == float(mets["loss_main"][i])
    for a, b in zip(tree_leaves(s_epoch.params), tree_leaves(s_step.params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("is_post", [True, False], ids=["posterior", "prior"])
def test_eval_epoch_matches_host_loop(is_post):
    """make_eval_epoch over the stacked split reproduces eval_split's ELBO,
    L1 and label metrics at the same seed (tests/test_train_infra.py's
    test_fused_eval_epoch_matches_host_loop for the JAX package)."""
    _, pspec = _specs()
    params = _port(jax_init(jax.random.key(0), _specs()[0]))
    split = _split(10, 5)
    ts = torch.arange(float(T))
    loop = eval_split(pspec, params, 9, split, svi.make_eval_fns(pspec, ts), 4, is_post=is_post)
    stack = device_batch(stacked_minibatches(split, 4, shuffle=False), "cpu")
    no_steps = {"loss_main": torch.zeros(0), "loss_aux": torch.zeros(0)}
    _, (fused,) = read_epoch(no_steps, [svi.make_eval_epoch(pspec, ts)(params, 9, stack, is_post)])
    np.testing.assert_allclose(fused.elbo, loop.elbo, rtol=2e-5)
    np.testing.assert_allclose(fused.l1, loop.l1, rtol=2e-5)
    for name in loop.label_metrics:
        np.testing.assert_allclose(fused.label_metrics[name], loop.label_metrics[name], rtol=1e-6)
    assert loop.recon["mu_50"].shape == (10, 3, T) and loop.labels["iext"].shape == (10, 1)
