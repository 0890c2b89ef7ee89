"""Nothing the harness runs loads JAX or the JAX package, and the plain
reference imports nothing of the program.  Top-level module names are
compared whole: ``repro_torch`` starts with ``repro`` and is allowed in
the harness."""
import ast
import json
import subprocess
import sys

from portbench import catalog

BANNED = {"jax", "jaxlib", "flax", "repro"}

LOAD_ALL = """
import json, sys
sys.path.insert(0, {src!r})
from portbench import catalog, run
import portbench.sweep
b = catalog.benchmark()
for w in catalog.workload_names():
    cell = catalog.workload(w)
    catalog.driver(cell["driver"])
    catalog.family(catalog.config(cell["config"])["family"])
    catalog.generator(catalog.mix(cell["traffic"])["generator"])
for m in b["end_to_end"] + b["per_layer"]:
    catalog.metric_reader(m["name"])
import repro_torch.runtime.serve_loop, repro_torch.configs
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_harness_loads_no_jax():
    code = LOAD_ALL.format(src=str(catalog.REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=catalog.REPO).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & BANNED, top & BANNED
    assert "repro_torch" in top


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_harness_source_imports_jax():
    for path in catalog.HERE.rglob("*.py"):
        assert not _imports(path) & BANNED, path


def test_reference_imports_nothing_of_the_program():
    for path in (catalog.HERE / "reference").rglob("*.py"):
        assert not _imports(path) & ({"repro_torch", "portbench"} | BANNED), \
            path


def test_run_refuses_what_it_finds_loaded(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert run.banned_modules() == ["repro"]
