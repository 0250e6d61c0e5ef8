"""Nothing under port_bench/ imports JAX, the JAX package or the JAX
benchmark, comparing each module's top-level name whole (the port's name
begins with the JAX package's); the reference imports nothing of the
program."""

import ast
import os

import pytest

from port_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH) for f in fs if f.endswith(".py"))


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [f for f in FILES if os.sep + "reference" + os.sep in f],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "structured_latent_odes_tpu_torch" not in top_level_imports(path)


@pytest.mark.parametrize("name, forbidden", [
    ("structured_latent_odes_tpu_torch.models", False),
    ("structured_latent_odes_tpu_torch", False),
    ("structured_latent_odes_tpu.models", True),
    ("structured_latent_odes_tpu", True),
    ("jax", True),
    ("jaxlib.xla_client", True),
    ("flax.linen", True),
    ("bench", True),
    ("benchmark_tools", False),
])
def test_forbidden_names_are_compared_whole(monkeypatch, name, forbidden):
    import sys
    import types

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) == forbidden
