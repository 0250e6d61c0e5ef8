"""Kernels K1 and K2 of the PyTorch port against their plain PyTorch versions,
on a CUDA card. Marked ``gpu``; each test skips when no card is present.

This file imports no JAX: the machine with the card has none. Run it there
with (``--noconftest`` skips tests/conftest.py, which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerances: K1 computes exactly the plain version's float32 operations, so
1e-6 abs (the measured gap is 0). K2 sums the heads in another order and
uses CUDA's expf: 1e-5 abs plus 1e-5 relative, the JAX package's own
tolerance for its fused kernel (tests/test_fused_step.py). Trajectories at
random weights reach |x| of tens, where float32 roundoff accumulated over 85
steps differs by about 1e-6 relative between two summation orders.
"""

import numpy as np
import pytest
import torch

from structured_latent_odes_tpu_torch.data.configs import load_cvs_config
from structured_latent_odes_tpu_torch.models import cvs_spec, init_params, recon
from structured_latent_odes_tpu_torch.nn.ode_model import initialize_state
from structured_latent_odes_tpu_torch.ops import fused_step, recurrence

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("M", [500, 777, 5 * 16411])
def test_affine_scan_kernel_matches_plain(cuda, M):
    gen = torch.Generator().manual_seed(M)
    A = (torch.rand((85, M), generator=gen) * 0.5 + 0.5).to(cuda)
    B = ((torch.rand((85, M), generator=gen) - 0.5) * 0.2).to(cuda)
    x0 = (torch.rand((M,), generator=gen) * 2 - 1).to(cuda)
    before = recurrence.affine_scan_tm.launches
    out = recurrence.affine_scan_tm(A, B, x0)
    torch.cuda.synchronize()
    assert recurrence.affine_scan_tm.launches == before + 1
    ref = recurrence.affine_scan_plain(A, B, x0)
    assert float((out - ref).abs().max()) <= 1e-6


@pytest.mark.parametrize("grid", ["uniform", "nonuniform"])
@pytest.mark.parametrize("method", fused_step.METHODS)
def test_fused_kernel_matches_plain(cuda, method, grid):
    spec = cvs_spec(load_cvs_config())
    ode = init_params(spec, 0, device=cuda)["decoder"]["ode"]
    z = torch.randn((100, 15), generator=torch.Generator().manual_seed(1)).to(cuda)
    x0 = initialize_state(ode, z)
    if grid == "uniform":
        ts = torch.arange(86.0, device=cuda)
    else:
        ts = torch.tensor(np.cumsum(np.abs(np.random.RandomState(0).randn(86)) * 0.2 + 0.05),
                          dtype=torch.float32, device=cuda)
    W = ode["dyn_hidden"]["W"]
    u = torch.nn.functional.linear(z, W[:, 1:], ode["dyn_hidden"]["b"])
    args = (u, W[:, 0], ode["prod"]["W"], ode["prod"]["b"], ode["degr"]["W"], ode["degr"]["b"], x0, ts)
    before = fused_step.fused_semilinear_fwd.launches
    out = fused_step.fused_semilinear_fwd(*args, method)
    torch.cuda.synchronize()
    assert fused_step.fused_semilinear_fwd.launches == before + 1
    ref = fused_step.fused_semilinear_fwd_plain(*args, method)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


def test_served_backends_agree_on_card(cuda):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_cvs_config()
    obs = torch.rand((100, 3, 86), generator=torch.Generator().manual_seed(2)).to(cuda)
    ts = np.arange(86, dtype=np.float32)
    outs = {}
    for backend in ("semilinear", "semilinear_seq", "semilinear_fused"):
        cfg.ode_backend = backend
        spec = cvs_spec(cfg)
        params = init_params(spec, 0, device=cuda)
        with torch.inference_mode():
            outs[backend] = recon(spec, params, 0, {"observations": obs}, ts, True)
    # scaled by each output's largest value: the bands cancel to small values
    # while the state's roundoff stays absolute
    for backend in ("semilinear", "semilinear_fused"):
        for k, v in outs[backend].items():
            ref = outs["semilinear_seq"][k]
            assert float((v - ref).abs().max()) <= 1e-5 + 1e-5 * float(ref.abs().max()), (backend, k)


def test_kernels_refuse_autograd_on_card(cuda):
    A = torch.rand((4, 8), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="training slice"):
        recurrence.affine_scan_tm(A, A.detach(), A.detach()[0])
