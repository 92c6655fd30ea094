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
              "ops.marching", "ops.native_build"):
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
