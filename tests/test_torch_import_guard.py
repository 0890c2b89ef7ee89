"""The port imports torch and numpy, never JAX and nothing of ``repro``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "repro" or n.startswith("repro."))
import torch.distributed as dist
print(json.dumps({"imported": names, "bad": bad,
                  "group": dist.is_initialized()}))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["group"] is False      # no import starts a process group
    for mod in ("repro_torch.kernels.fused_mlp", "repro_torch.models.layers",
                "repro_torch.runtime.serve_loop", "repro_torch.launch.serve",
                "repro_torch.core.planner", "repro_torch.core.simulator",
                "repro_torch.kernels.maxplus_scan",
                "repro_torch.kernels.price_rows",
                "repro_torch.core.pipeline_model_torch",
                "repro_torch.configs.xrbench",
                "repro_torch.kernels.rwkv6_scan",
                "repro_torch.kernels.rglru_scan",
                "repro_torch.models.rwkv6", "repro_torch.models.rglru",
                "repro_torch.kernels.flash_attention",
                "repro_torch.configs.gemma3_4b",
                "repro_torch.optim.adamw", "repro_torch.runtime.steps",
                "repro_torch.runtime.train_loop",
                "repro_torch.checkpoint.store",
                "repro_torch.data.pipeline", "repro_torch.launch.train",
                "repro_torch.distributed.hints",
                "repro_torch.distributed.sharding",
                "repro_torch.distributed.pipeline",
                "repro_torch.launch.mesh", "repro_torch.launch.dryrun"):
        assert mod in res["imported"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_chip_smoke_imports_no_jax_or_reference():
    path = SRC.parent / "chip_smoke.py"
    for name in _imports(path):
        assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), name
