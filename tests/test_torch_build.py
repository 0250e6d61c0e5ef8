"""The PyTorch port's kernel builder (ops/_build.py) on the CPU, with a stand-in
``nvcc`` on PATH: one library per (source, defines), one compiler process per
missing library, nvcc's output returned, a failed build raised with that
output, and a built library not built again. JAX is imported, as in every
test_torch_* file, and stays on the CPU.
"""

import os
import stat

import jax  # noqa: F401
import pytest
import torch  # noqa: F401

from structured_latent_odes_tpu_torch.ops import _build

_FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; shift; fi
  shift
done
echo "ptxas info    : Used 31 registers"
{body}
"""


def _fake_nvcc(tmp_path, monkeypatch, body):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(body=body))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))


def test_build_keys_libraries_by_source_and_defines(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    a = _build._plan(("fused_semilinear_fwd", (("SLODE_H", 25), ("SLODE_D", 5))))[2]
    b = _build._plan(("fused_semilinear_fwd", (("SLODE_H", 25), ("SLODE_D", 8))))[2]
    again = _build._plan(("fused_semilinear_fwd", (("SLODE_H", 25), ("SLODE_D", 5))))
    assert a != b and a == again[2]
    assert "-DSLODE_D=5" in again[1] and "arch=compute_90a,code=sm_90a" in again[1]


def test_build_runs_one_compiler_per_missing_library(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, ': > "$out"')
    targets = [("affine_scan", ()), ("fused_semilinear_fwd", (("SLODE_H", 25), ("SLODE_D", 5)))]
    logs = _build.build(targets)
    assert sorted(logs) == sorted(targets)
    assert all("Used 31 registers" in log for log in logs.values())
    assert all(os.path.exists(_build._plan(t)[2]) for t in targets)
    assert _build.build(targets) == {}  # built once, not again


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'echo "error: no such instruction"; exit 2')
    with pytest.raises(RuntimeError, match="no such instruction"):
        _build.build([("affine_scan", ())])
    assert not os.listdir(tmp_path / "out")  # no half-written library left behind
