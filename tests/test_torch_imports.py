"""Import guard: no module of the PyTorch port, and nothing ``chip_smoke.py``
imports, loads ``jax``, ``optax``, ``pandas``, ``matplotlib`` or any module
of the JAX package. Run in a subprocess with those blocked, so an import of
any fails loudly; every module of the port is walked, the training slice's,
the proc and challenge workloads' and the sweep's included."""

import os
import subprocess
import sys
import textwrap

import jax  # noqa: F401  (the test process holds both packages; the child must not)
import torch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any import of jax now raises
    sys.modules["optax"] = None
    sys.modules["pandas"] = None  # the card's machine has no pandas
    sys.modules["matplotlib"] = None  # nor matplotlib (the port's eval is numpy only)
    import structured_latent_odes_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # its imports; its main() runs only as a script
    bad = sorted(m for m in sys.modules
                 if m == "structured_latent_odes_tpu" or m.startswith("structured_latent_odes_tpu."))
    assert not bad, bad
    assert "jaxlib" not in sys.modules
    print(" ".join(names))
    """
)


def test_port_never_imports_jax_or_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert proc.returncode == 0, proc.stderr
    walked = set(proc.stdout.split())
    assert len(walked) >= 47  # every module of the port was imported
    training = {"prob.elbo", "train.svi", "train.driver", "train.backend", "train.artifacts",
                "train.metrics", "utils.rng", "utils.device", "training_cvs", "data.proc",
                "data.challenge", "training_proc", "training_challenge", "train.ensemble", "sweep",
                "eval", "eval.metrics", "eval.__main__"}
    assert {f"structured_latent_odes_tpu_torch.{m}" for m in training} <= walked
