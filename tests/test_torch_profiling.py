"""The PyTorch port's profiler trace (``utils/profiling.py``) on the CPU:
``trace`` writes a Chrome-trace JSON that parses, and ``--profile-dir``
traces epoch ``min(start + 1, num_epochs)`` of a run, as the JAX loop does:
the second epoch, the only one of a run of one epoch, the first one after a
resume; the trace carries the driver's spans."""

import contextlib
import io
import json
import os
import re

import pytest
import torch

from structured_latent_odes_tpu_torch import training_cvs
from structured_latent_odes_tpu_torch.data.cvs import make_dataset
from structured_latent_odes_tpu_torch.utils.profiling import trace
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)


def test_trace_writes_a_parseable_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as t:
        x = torch.randn(32, 32)
        (x @ x).sum()
    assert os.path.dirname(t.path) == str(tmp_path / "prof") and t.path.endswith(".json")
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cvs")) + os.sep
    make_dataset(d, data_size=20, seed=0, device="cpu")
    return d


def _traced_epochs(data_dir, root, prof, *extra):
    argv = ["--data-path", data_dir, "--results-root", str(root), "--mini-batch-size", "8", "--no-plot",
            "--no-eval-train", "--device", "cpu", "--profile-dir", str(prof), *extra]
    with contextlib.redirect_stdout(io.StringIO()) as out:
        training_cvs.main(argv)
    return [int(e) for e in re.findall(r"profiler trace of epoch (\d+)", out.getvalue())]


@pytest.mark.parametrize("epochs,resume_from,traced", [(2, None, 1), (0, None, 0), (3, 1, 3), (2, 1, 2)],
                         ids=["second", "only", "after-resume", "last-after-resume"])
def test_profile_dir_traces_one_epoch(data_dir, tmp_path, epochs, resume_from, traced):
    extra = ["--num-epochs", str(epochs)]
    if resume_from is not None:
        _traced_epochs(data_dir, tmp_path, tmp_path / "first", "--num-epochs", str(resume_from),
                       "--checkpoint-every", "1")
        extra += ["--resume"]
    assert _traced_epochs(data_dir, tmp_path, tmp_path / "prof", *extra) == [traced]
    (name,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"entry.epoch", "entry.batches", "dispatch.train", "dispatch.eval", "wait.epoch"} <= names
