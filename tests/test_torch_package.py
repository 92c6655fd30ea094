"""Package boundary and config of the PyTorch port.

The port must import on a host without jax and import nothing of the JAX
package; every YAML under config/ must load to the same fields in both
packages' configs."""

import dataclasses
import glob
import os
import pkgutil
import subprocess
import sys

import pytest

import shine_mapping_tpu_torch
from shine_mapping_tpu.config import SHINEConfig as JaxConfig
from shine_mapping_tpu_torch.config import SHINEConfig, torch_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "**", "*.yaml"), recursive=True))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        shine_mapping_tpu_torch.__path__, "shine_mapping_tpu_torch."))


def test_port_imports_without_jax():
    """Every module of the port imports with ``jax`` and the JAX package
    made unimportable (a None entry in sys.modules raises ImportError)."""
    mods = _port_modules()
    for m in ("train.trainer", "mesher", "eval.metrics", "eval.evaluator",
              "eval.crop_intersection", "utils.checkpoint", "utils.profiling",
              "utils.experiment", "utils.metrics_logger", "cli.common", "cli.shine_batch",
              "cli.shine_incre", "train.importance", "train.sparse_adam",
              "ops.marching", "ops.native_build", "parallel", "parallel.mesh",
              "parallel.comm", "parallel.ingest", "visualizer", "data.rgbd_converter"):
        assert "shine_mapping_tpu_torch." + m in mods, m
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'shine_mapping_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'shine_mapping_tpu')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_lazy_top_level_names_resolve_without_jax():
    """``shine_mapping_tpu_torch.{Mesher, HashGridHost, LiDARDataset,
    MapVisualizer}``, as the JAX package exports them lazily, on a host
    where jax cannot be imported."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'shine_mapping_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import shine_mapping_tpu_torch as p\n"
        "names = ['Mesher', 'HashGridHost', 'LiDARDataset', 'MapVisualizer']\n"
        "assert all(n in p.__all__ for n in names)\n"
        "print(' '.join(getattr(p, n).__module__ for n in names))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        "shine_mapping_tpu_torch.mesher", "shine_mapping_tpu_torch.ops.hashgrid",
        "shine_mapping_tpu_torch.data.dataset", "shine_mapping_tpu_torch.visualizer"]
    with pytest.raises(AttributeError):
        shine_mapping_tpu_torch.NotAName  # noqa: B018


def test_every_jax_module_has_a_twin():
    """Every module of the JAX package has one of the same name in the port."""
    import shine_mapping_tpu

    jax_mods = {m.name.split(".", 1)[1] for m in pkgutil.walk_packages(
        shine_mapping_tpu.__path__, "shine_mapping_tpu.")}
    port = {m.split(".", 1)[1] for m in _port_modules()}
    assert not jax_mods - port, sorted(jax_mods - port)


def test_no_port_module_imports_the_jax_package():
    """No import statement of the port, at module level or inside a function
    (the imports that run only when a path is taken), names the JAX package
    or jax."""
    import ast

    root = os.path.dirname(shine_mapping_tpu_torch.__file__)
    bad = []
    for path in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        for node in ast.walk(ast.parse(open(path).read(), path)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "shine_mapping_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_every_yaml_loads_to_equal_fields(path):
    want = dataclasses.asdict(JaxConfig().load(path))
    got = dataclasses.asdict(SHINEConfig().load(path))
    assert got.keys() == want.keys()
    # the one intended difference: setting.device names the torch device
    assert got.pop("device") == torch_device(want.pop("device"))
    assert got == want


def test_device_mapping():
    assert [torch_device(d) for d in ("tpu", "cuda", "gpu", "cpu", "cuda:1")] == [
        "cuda", "cuda", "cuda", "cpu", "cuda:1"]
    with pytest.raises(ValueError):
        torch_device("mps")


def test_unknown_tpu_section_key_raises(tmp_path):
    src = open(CONFIGS[0]).read() + "tpu:\n  feature_updat: pallas\n"
    p = tmp_path / "typo.yaml"
    p.write_text(src)
    with pytest.raises(ValueError, match="unknown keys"):
        SHINEConfig().load(str(p))
