"""No module of the benchmark imports JAX or the JAX package (whole
top-level names), and the reference imports nothing of the port either."""

import ast
import os

import pytest

import harness

JAX = {"jax", "jaxlib", "flax", "shine_mapping_tpu"}
PORT = "shine_mapping_tpu_torch"


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    root = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_import(path):
    assert not set(_top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(_top_level_imports(path)) | JAX


def test_the_module_check_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "shine_mapping_tpu_torch_x", types.ModuleType("x"))
    monkeypatch.delitem(sys.modules, "shine_mapping_tpu", raising=False)
    assert "shine_mapping_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in harness.forbidden_modules()
