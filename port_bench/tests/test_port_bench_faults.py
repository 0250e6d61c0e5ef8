"""Each cell's comparison catches the faults that its timed path can have:
the harness drives the rest of a run (skipping its look for a card) with the
program broken underneath, and ``correct`` comes out false. A training step
that returns its state unchanged; one that leaves one leaf of its params
where it was (a fault confined to a few leaves); half of each batch left
out, the mean taken over the rest. (The cells run on one card: there is no
exchange between cards to leave out.)"""

import pytest

from port_bench import harness
from port_bench.tests._tiny import result_line, tiny_run


def _broken(make, fault):
    """A dual step's maker whose steps have ``fault``."""
    from structured_latent_odes_tpu_torch.train.svi import SVIState

    def broken_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(state, batch, *rest, **kw):
            if fault == "half_batch":
                mask = batch["mask"].clone()
                mask[..., mask.shape[-1] // 2:] = 0.0
                batch = {**batch, "mask": mask}
            new, metrics = step(state, batch, *rest, **kw)
            if fault == "state_unchanged":
                new = SVIState(state.params, state.opt, state.seed, new.step)
            if fault == "one_leaf_unchanged":
                params = dict(new.params)
                params["decoder"] = dict(params["decoder"], q50=state.params["decoder"]["q50"])
                new = SVIState(params, new.opt, new.seed, new.step)
            return new, metrics
        return broken

    return broken_make


def _wrap_step(monkeypatch, module, name, fault):
    """The program's dual step (``name`` in ``module``) with ``fault``."""
    monkeypatch.setattr(module, name, _broken(getattr(module, name), fault))


@pytest.mark.parametrize("fault", ["state_unchanged", "one_leaf_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch, capsys):
    from structured_latent_odes_tpu_torch.train import svi

    _wrap_step(monkeypatch, svi, "make_dual_step", fault)
    harness.execute(tiny_run("cvs_train"), harness.benchmark())
    assert result_line(capsys)["correct"] is False


@pytest.mark.parametrize("fault", ["state_unchanged", "one_leaf_unchanged", "half_batch"])
def test_a_broken_stacked_step_is_not_correct(fault, monkeypatch, capsys):
    from structured_latent_odes_tpu_torch.train import ensemble

    _wrap_step(monkeypatch, ensemble, "make_stacked_dual_step", fault)
    harness.execute(tiny_run("proc_sweep"), harness.benchmark())
    assert result_line(capsys)["correct"] is False
