"""The PyTorch port's serving path end to end on the CPU: ``serve.main`` on a
tiny CVS dataset generated in ``tmp_path`` (through ``load_model(...,
config=cfg)``), from checkpoints written by the JAX package. Checks the
ensemble mean of two checkpoints, the averaged predictor's own ``l1``, the
majority label vote and its tie-break against the JAX package's, that the
port loads the same splits and parameters as the JAX ``load_model``, and that
the served backends agree."""

import jax
import numpy as np
import pytest
import torch

from structured_latent_odes_tpu import serve as jax_serve
from structured_latent_odes_tpu.data.configs import load_cvs_config as jax_cvs_config
from structured_latent_odes_tpu.models import cvs_spec as jax_cvs_spec
from structured_latent_odes_tpu.models import init_params as jax_init
from structured_latent_odes_tpu.train import checkpoint as jax_ckpt
from structured_latent_odes_tpu_torch import serve
from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.interop import params_to_jax

TOL = 1e-5


@pytest.fixture
def served(tmp_path):
    """Port and JAX configs on one tiny data dir, and two JAX checkpoints."""
    pc, jc = load_cvs_config(), jax_cvs_config()
    pc.data_path = jc.data_path = str(tmp_path / "cvs")
    pc.data_size = jc.data_size = 40
    spec = jax_cvs_spec(jc)
    ckpts = []
    for seed in (0, 1):
        path = str(tmp_path / f"member{seed}.npz")
        jax_ckpt.save(path, jax_init(jax.random.key(seed), spec))
        ckpts.append(path)
    return pc, jc, ckpts, tmp_path


def test_serve_ensemble_mean_and_vote(served):
    pc, _, ckpts, tmp_path = served
    out_path = str(tmp_path / "preds.npz")
    out = serve.main(
        ["--dataset", "cvs", "--checkpoint", *ckpts, "--classify", "--device", "cpu",
         "--output", out_path, "--seed", "3"],
        config=pc,
    )
    with np.load(out_path) as z:
        written = {k: z[k] for k in z.files}
    assert sorted(written) == sorted(out) == sorted(
        ["l1", "solution_xt", "mu_75", "mu_50", "mu_25", "std", "z", "pred_iext", "pred_rtpr"]
    )
    assert written["mu_50"].shape == (4, 3, 86) and np.isfinite(written["mu_50"]).all()

    # each member on its own, through the library entry points
    members = []
    for c in ckpts:
        spec, params, times, splits = serve.load_model("cvs", c, config=pc, device="cpu")
        recon_fn, classify_fn = serve.make_predict_fns(spec, times, device="cpu")
        batch = {k: torch.as_tensor(v) for k, v in splits["test"].items()}
        r = {k: v.numpy() for k, v in recon_fn(params, 3, batch, True).items()}
        labels = {k: v.numpy() for k, v in classify_fn(params, 3, batch["observations"]).items()}
        members.append((r, labels))
    for k in ("solution_xt", "mu_75", "mu_50", "mu_25", "std", "z"):
        np.testing.assert_allclose(written[k], np.mean([m[0][k] for m in members], 0), rtol=0, atol=1e-6)
    obs = splits["test"]["observations"]
    np.testing.assert_allclose(written["l1"], np.abs(written["mu_50"] - obs).mean(), rtol=1e-6)
    votes = jax_serve._combine_labels(spec, [m[1] for m in members])
    for name in ("iext", "rtpr"):
        np.testing.assert_array_equal(written[f"pred_{name}"], votes[name])


def test_label_vote_tie_goes_to_class_0():
    spec = serve.cvs_spec(load_cvs_config())
    preds = [{"iext": np.array([[1.0], [1.0]]), "rtpr": np.array([[0.0], [1.0]])},
             {"iext": np.array([[0.0], [1.0]]), "rtpr": np.array([[0.0], [1.0]])}]
    out = serve._combine_labels(spec, preds)
    ref = jax_serve._combine_labels(jax_cvs_spec(jax_cvs_config()), preds)
    np.testing.assert_array_equal(out["iext"], [[0.0], [1.0]])  # a 1-1 tie -> class 0
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


def test_port_loads_what_jax_loads(served):
    pc, jc, ckpts, _ = served
    spec, params, times, splits = serve.load_model("cvs", ckpts[1], config=pc, device="cpu")
    jspec, jparams, jtimes, jsplits = jax_serve.load_model("cvs", ckpts[1], config=jc)
    np.testing.assert_array_equal(times, jtimes)
    for name in jsplits:
        for k in jsplits[name]:
            np.testing.assert_array_equal(splits[name][k], jsplits[name][k])
    got = jax.tree_util.tree_leaves(params_to_jax(params))
    for a, b in zip(got, jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert spec.latent_dim == jspec.latent_dim == 15


def test_served_backends_agree(served):
    pc, _, ckpts, tmp_path = served
    outs = {}
    for backend in ("semilinear", "semilinear_seq", "semilinear_pallas", "semilinear_fused"):
        cfg = pc.copy()
        cfg.ode_backend = backend
        outs[backend] = serve.main(
            ["--dataset", "cvs", "--checkpoint", ckpts[0], "--prior", "--device", "cpu",
             "--output", str(tmp_path / f"{backend}.npz")],
            config=cfg,
        )
    for backend, out in outs.items():
        for k in out:
            np.testing.assert_allclose(out[k], outs["semilinear_seq"][k], rtol=0, atol=TOL,
                                       err_msg=f"{backend}:{k}")


def test_default_device_fails_loudly_without_a_card(served):
    pc, _, ckpts, tmp_path = served
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--dataset", "cvs", "--checkpoint", ckpts[0],
                    "--output", str(tmp_path / "x.npz")], config=pc)


@pytest.mark.parametrize("dataset,item", [("proc", "A13"), ("challenge", "A12")])
def test_unported_datasets_name_their_roadmap_item(dataset, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.load_model(dataset, "unused.npz", device="cpu")
