"""Find a cell's parts by name, as files under this folder.

Every cell, configuration, traffic mix and metric lives in a file of its
own, named after it: ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<mix>.json`` and ``metrics/<metric>.py``.  The code a file of
data needs is found by the name it gives: a cell's ``driver``
(``drivers/<driver>.py``), a configuration's ``family``
(``families/<family>.py``: the program's config, the weights, the plain
reference), a mix's ``generator`` (``generators/<generator>.py``).  The
harness reads ``BENCHMARK.json`` at the repository's root for which
metrics a cell reports.  Adding a cell, a configuration, a mix or a
metric adds files; nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def workload(name: str, root: Path = HERE) -> Dict[str, Any]:
    """The cell ``workloads/<name>.json``."""
    return _json(root / "workloads" / f"{_checked(name)}.json")


def config(name: str, root: Path = HERE) -> Dict[str, Any]:
    """The model configuration ``configs/<name>.json``."""
    return _json(root / "configs" / f"{_checked(name)}.json")


def mix(name: str, root: Path = HERE) -> Dict[str, Any]:
    """The traffic mix ``traffic/<name>.json``."""
    return _json(root / "traffic" / f"{_checked(name)}.json")


def benchmark(root: Path = REPO) -> Dict[str, Any]:
    return _json(root / "BENCHMARK.json")


def workload_names(root: Path = HERE) -> List[str]:
    return sorted(p.name[:-len(".json")]
                  for p in (root / "workloads").glob("*.json"))


def cell_metrics(bench: Dict[str, Any], cell: str, trace: bool
                 ) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    tracing off, its per-layer metrics with tracing on.  A metric without
    a ``workloads`` list goes to every cell; a per-layer one without it,
    to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def _module(folder: str, name: str, root: Path):
    """The module of ``<folder>/<name>.py``, loaded once a process (a
    name may hold ``.`` and ``-``)."""
    key = (f"portbench.{folder}."
           f"{_checked(name).replace('.', '_').replace('-', '_')}")
    if root == HERE and key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(
        key, root / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    if root == HERE:
        sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = HERE) -> Callable[[Any], Any]:
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    return _module("metrics", name, root).read


def driver(name: str, root: Path = HERE):
    """``drivers/<name>.py``, whose ``run`` drives a cell."""
    return _module("drivers", name, root)


def family(name: str, root: Path = HERE):
    """``families/<name>.py``: a model family's program configuration,
    weights and plain reference."""
    return _module("families", name, root)


def generator(name: str, root: Path = HERE):
    """``generators/<name>.py``, whose ``requests(mix, n, seed, vocab,
    max_len, rate)`` makes a mix's requests: objects with ``rid``,
    ``offset`` (seconds after the traffic starts), ``prompt`` (token
    ids) and ``max_new``."""
    return _module("generators", name, root)
