"""The plain reference agrees with the port on the CPU at a tiny size: the
draws, the weights' layout, three dual steps (CVS and proc) and a served
request. The tests import both; the reference imports nothing of the port."""

import copy

import numpy as np
import pytest
import torch

from port_bench import harness, weights
from port_bench.data import cvs as cvs_data
from port_bench.loops import common
from port_bench.reference import compare, sampler
from port_bench.reference import train as reference
from port_bench.reference.model import Model


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(name):
    return copy.deepcopy(harness.configuration(harness.benchmark(), name))


@pytest.mark.parametrize("seed", [0, 12, 2 ** 31 + 5, 2 ** 63 + 17])
def test_sampler_is_the_ports(seed):
    from structured_latent_odes_tpu_torch.prob import fold_seed, standard_normal_ps

    assert sampler.fold_seed(seed, 3, "main") == fold_seed(seed, 3, "main")
    sids = torch.tensor([0, 5, 2 ** 31 - 1, 70000])
    s = sampler.fold_seed(seed, "x")
    assert torch.equal(sampler.standard_normal(s, "main/iext", sids, (5,)), standard_normal_ps(s, "main/iext", sids, (5,)))


@pytest.mark.parametrize("name, n_time", [("cvs", 86), ("proc", 100)])
def test_weights_take_the_ports_layout(name, n_time):
    from structured_latent_odes_tpu_torch.models import init_params

    cfg = config(name)
    spec = common.port_spec(cfg, common.port_config(cfg), n_time)
    port = compare.flatten(init_params(spec, 0, device="cpu"))
    ours = weights.make(cfg, n_time, 3, "cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == {k: tuple(v.shape) for k, v in port.items()}
    assert compare.flatten(weights.to_tree(ours)).keys() == port.keys()


def _batches(split, batch, steps, rng):
    perm = rng.permutation(len(split["observations"]))[:batch * steps]
    out = []
    for i in range(steps):
        sel = perm[i * batch:(i + 1) * batch]
        b = {k: torch.as_tensor(v[sel]) for k, v in split.items()}
        b["mask"] = torch.ones(batch)
        b["sample_id"] = torch.as_tensor(sel)
        out.append(b)
    return out


@pytest.mark.parametrize("schedule", [
    {},
    {"aux_loss_multiplier": 460.0, "aux_mult_final": 46.0, "aux_anneal_epochs": 1500},
    {"aux_mult_start": 4.6, "aux_warmup_epochs": 1500},
    {"aux_mult_start": 4.6, "aux_warmup_epochs": 100, "aux_mult_final": 46.0, "aux_anneal_epochs": 50},
])
def test_the_aux_multiplier_is_the_ports_at_epoch_0(schedule):
    from structured_latent_odes_tpu_torch.train.driver import epoch_aux_mult

    cfg = config("cvs")
    cfg["config"].update(schedule)
    ports = epoch_aux_mult(common.port_config(cfg), 0)
    assert Model(cfg).aux_mult == (cfg["config"]["aux_loss_multiplier"] if ports is None else ports)


@pytest.mark.parametrize("name", ["cvs", "proc"])
def test_three_dual_steps_match_the_port(name):
    from structured_latent_odes_tpu_torch.train.svi import make_train_step, own_state

    cfg = config(name)
    if name == "cvs":
        cfg["data"].update(n_train=40, n_val=8, n_test=8)
    run = harness.Run(cell="t", cfg=cfg, traffic={}, seed=9, seconds=0, trace=False, t0=0, device=torch.device("cpu"))
    splits, times = common.splits(run, "cpu")
    config_ = common.port_config(cfg)
    spec = common.port_spec(cfg, config_, len(times))
    ts = torch.as_tensor(times)
    flat = weights.make(cfg, len(times), 4, "cpu")
    init_state, _, train_epoch = make_train_step(spec, ts, config_.learning_rate, weights.to_tree(flat),
                                                 dispatch="eager")
    batches = _batches(splits["train"], 12, 3, np.random.RandomState(1))
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    state, m1 = train_epoch(init_state(weights.to_tree(flat), 77), {k: v[:1] for k, v in stack.items()})
    moments = compare.flatten(own_state(state).opt.mu)
    state, m = train_epoch(state, {k: v[1:] for k, v in stack.items()})
    ref = reference.follow(Model(cfg), flat, 77, batches, ts)
    losses = [float(m1["loss_main"][0]), float(m1["loss_aux"][0])]
    for a, b in zip(m["loss_main"], m["loss_aux"]):
        losses += [float(a), float(b)]
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    gaps = compare.training_gaps({"losses": losses, "first_moments": moments,
                                  "params": compare.flatten(state.params)}, ref, flat)
    # by the worst leaf: elements that nearly cancel differ by float32
    # round-off, which a leaf's norm averages
    assert gaps["grad_gap"] < 1e-5 and gaps["change_gap"] < 1e-5, gaps


def test_a_request_matches_the_port():
    from structured_latent_odes_tpu_torch.serve import make_predict_fns

    cfg = config("cvs")
    obs, _ = cvs_data.trajectories(48, 5, "cpu")
    lo, hi = cvs_data.min_max(obs)
    x = cvs_data.model_layout(obs, lo, hi)
    times = np.arange(86, dtype=np.float32)
    spec = common.port_spec(cfg, common.port_config(cfg), 86)
    flat = weights.make(cfg, 86, 6, "cpu")
    recon_fn, classify_fn = make_predict_fns(spec, times, "cpu")
    out = recon_fn(weights.to_tree(flat), 2 ** 40 + 3, {"observations": x}, True)
    labels = classify_fn(weights.to_tree(flat), 2 ** 40 + 3, x)
    model = Model(cfg)
    ref = model.recon_post(flat, 2 ** 40 + 3, x, torch.as_tensor(times))
    ref_labels, margins = model.classify(flat, 2 ** 40 + 3, x)
    assert compare.band_gap(out, ref) < 1e-5
    assert compare.label_flips(labels, ref_labels, margins) == 0.0


def test_a_decision_taken_by_round_off_is_judged_either_way(monkeypatch):
    """A program whose step took one quantile decision the other way (a
    target on a band within round-off) reads as the reference: the
    comparison takes each undecided decision both ways."""
    _judged_either_way(monkeypatch, lambda band: isinstance(band, int))


def test_a_relu_gate_decided_by_round_off_is_judged_either_way(monkeypatch):
    """A program whose step took one of the decoder's ReLU gates the other
    way (a pre-activation within round-off of zero) reads as the reference."""
    _judged_either_way(monkeypatch, lambda site: site in ("x0", "rates"))


def _judged_either_way(monkeypatch, of_kind):
    from port_bench.reference import model as model_module

    cfg = config("cvs")
    cfg["data"].update(n_train=40, n_val=8, n_test=8)
    run = harness.Run(cell="t", cfg=cfg, traffic={}, seed=9, seconds=0, trace=False, t0=0, device=torch.device("cpu"))
    splits, times = common.splits(run, "cpu")
    ts = torch.as_tensor(times)
    flat = weights.make(cfg, len(times), 4, "cpu")
    batches = _batches(splits["train"], 12, 3, np.random.RandomState(1))
    model = Model(cfg)

    def follow(flips=frozenset()):
        return reference.follow(model, flat, 77, batches, ts, flips=flips)

    monkeypatch.setattr(model_module, "NEAR", 1e9)  # every decision noted: take the nearest of step 2's
    tag, band, element, _ = min((n for n in follow()["near"] if n[0] == ("step", 1) and of_kind(n[1])),
                                key=lambda n: n[3])
    monkeypatch.setattr(model_module, "NEAR", 0.0)
    flipped = follow(frozenset({(tag, band, element)}))
    assert compare.training_gaps(flipped, follow(), flat)["loss_gap"] > 1e-7
    monkeypatch.setattr(model_module, "NEAR", 1e9)
    near = follow()["near"]
    monkeypatch.setattr(model_module, "NEAR", 0.0)
    original = follow

    def near_first(flips=frozenset()):
        out = original(flips)
        out["near"] = sorted(near, key=lambda n: (n[:3] != (tag, band, element), n[3]))[:1]
        return out

    gaps, _ = compare.nearest_training_gaps(flipped, near_first, flat)
    assert gaps["loss_gap"] == 0.0 and gaps["change_gap"] == 0.0 and gaps["change_gap_worst"] == 0.0
