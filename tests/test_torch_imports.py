"""Import guard: no module of the PyTorch port, and nothing ``chip_smoke.py``
imports, loads ``jax``, ``optax``, ``pandas``, ``matplotlib``, ``sklearn``
or any module of the JAX package. Run in a subprocess with those blocked,
so an import of any fails loudly; every module of the port is walked, the
training slice's, the proc and challenge workloads', the sweep's, the
generic, adjoint and adaptive solvers', the native loader's, the
profiler's, the plotting and figure modules' (these two import matplotlib
only when they draw), the parallel package's and the CUDA graphs' (the
memo, a copy of the JAX package's, and the graph helper) included."""

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
    sys.modules["matplotlib"] = None  # nor matplotlib: plotting imports it when it draws
    sys.modules["sklearn"] = None  # nor scikit-learn
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
    assert len(walked) >= 58  # every module of the port was imported
    training = {"prob.elbo", "train.svi", "train.driver", "train.backend", "train.artifacts",
                "train.metrics", "utils.rng", "utils.device", "training_cvs", "data.proc",
                "data.challenge", "training_proc", "training_challenge", "train.ensemble", "sweep",
                "eval", "eval.metrics", "eval.__main__", "ode.solvers", "ode.adjoint",
                "native", "utils.profiling", "utils.plotting", "eval.figures", "parallel", "parallel.mesh",
                "parallel.launch", "parallel.train", "parallel.timepar", "utils.memo", "utils.graphs"}
    assert {f"structured_latent_odes_tpu_torch.{m}" for m in training} <= walked


def test_utils_import_no_layer_above_them():
    """No module under the port's ``utils/`` imports ``ops``, ``train``,
    ``models``, ``nn`` or ``prob`` (read from every import statement of the
    sources, those inside functions too): the lowest layer knows none of its
    callers, and a kernel registers its counters with ``utils/graphs.py``
    from below."""
    import ast

    above = {f"structured_latent_odes_tpu_torch.{m}" for m in ("ops", "train", "models", "nn", "prob")}
    utils = os.path.join(REPO, "structured_latent_odes_tpu_torch", "utils")
    found = []
    for name in sorted(os.listdir(utils)):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(utils, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                modules = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = "structured_latent_odes_tpu_torch.utils" if node.level else ""
                modules = [f"{base}.{node.module}" if base and node.module else node.module or base]
                modules += [f"{modules[0]}.{a.name}" for a in node.names]
            else:
                continue
            found += [(name, m) for m in modules if any(m == a or m.startswith(a + ".") for a in above)]
    assert not found, found
