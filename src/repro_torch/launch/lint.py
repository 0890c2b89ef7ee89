"""Static artifact lint: sweep plan artifacts through the verifier.

Runs the pass-based static verifier (``repro_torch.core.verify``) over plan
artifacts on disk — never the simulator — so a CI lane or a pre-serve
hook can certify a store directory or a committed golden suite in
seconds.

Two input modes, auto-detected per path:

  * **store directory** — every ``*.plan.json`` / ``*.span.json`` /
    ``*.mtplan.json`` artifact under the directory is decoded and
    verified (schema, identity token, placement, routing, slot DAG,
    conservation, fold, tenancy).  Orphaned ``*.tmp`` files (writers
    that died before the atomic rename) are reported and, with
    ``--clean``, deleted.
  * **golden suite JSON** — ``tests/golden/xrbench_plans.json`` or
    ``tests/golden/lm_plans.json``.  Snapshots pin numbers, not full
    plans, so the matching graphs are re-planned (pipeorgan @ AMP, the
    suites' pinned configuration) and each fresh plan is verified.
    A single-artifact JSON file (has a ``kind`` field) is verified
    directly.

Exit status is 1 when any error-severity finding survives; ``--strict``
also fails on warning findings and on orphaned tmp files.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.lint <store-dir|golden.json>... \
      [--clean] [--strict] [--quiet]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Iterable, List, Tuple

from repro_torch.core.hwconfig import PAPER_HW
from repro_torch.core.noc import Topology
from repro_torch.core.verify import VerifyReport, verify_plan

#: artifact filename patterns a store directory may hold.
ARTIFACT_GLOBS = ("*.plan.json", "*.span.json", "*.mtplan.json")

#: golden snapshot filename -> zero-arg factory of {name: Graph}.  The
#: suites pin pipeorgan @ AMP on PAPER_HW; the lint re-plans with exactly
#: that configuration.
_GOLDEN_FACTORIES = {
    "xrbench_plans.json": "repro_torch.configs.xrbench:all_tasks",
    "lm_plans.json": "repro_torch.configs.lm_graphs:lm_graphs",
}


def _load_factory(spec: str):
    mod_name, fn_name = spec.split(":")
    import importlib
    return getattr(importlib.import_module(mod_name), fn_name)


def _emit(report: VerifyReport, label: str, quiet: bool) -> Tuple[int, int]:
    """Print one result line (plus findings) and return (errors, warnings)."""
    n_err, n_warn = len(report.errors), len(report.warnings)
    status = "OK" if report.ok else "FAIL"
    if not quiet or not report.ok:
        print(f"[lint] {label}: {status} "
              f"({n_err} errors, {n_warn} warnings)")
        for f in report.findings:
            print(f"         {f}")
    return n_err, n_warn


def lint_directory(root: Path, clean: bool = False,
                   quiet: bool = False) -> Tuple[int, int, int]:
    """Verify every artifact under ``root``; returns (errors, warnings,
    orphaned-tmp count — post-clean when ``clean``)."""
    errors = warnings = 0
    paths: List[Path] = []
    for pat in ARTIFACT_GLOBS:
        paths.extend(root.rglob(pat))
    for path in sorted(set(paths)):
        if path.suffix == ".tmp":
            continue
        label = str(path.relative_to(root))
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError) as exc:
            print(f"[lint] {label}: FAIL (unreadable: {exc})")
            errors += 1
            continue
        e, w = _emit(verify_plan(doc), label, quiet)
        errors += e
        warnings += w
    tmp = sorted(root.rglob("*.tmp"))
    for path in tmp:
        verb = "removing" if clean else "orphaned"
        print(f"[lint] {path.relative_to(root)}: {verb} tmp file")
        if clean:
            try:
                path.unlink()
            except OSError:
                pass
    n_tmp = 0 if clean else len(tmp)
    if not paths and not tmp:
        print(f"[lint] {root}: no artifacts found")
    return errors, warnings, n_tmp


def lint_golden(path: Path, quiet: bool = False) -> Tuple[int, int]:
    """Re-plan and verify every entry of a golden suite (or verify a
    single-artifact JSON directly); returns (errors, warnings)."""
    doc = json.loads(path.read_text())
    if isinstance(doc, dict) and "kind" in doc:
        return _emit(verify_plan(doc), str(path), quiet)
    spec = _GOLDEN_FACTORIES.get(path.name)
    if spec is None:
        raise SystemExit(
            f"{path}: not an artifact (no 'kind') and not a known golden "
            f"suite (one of {sorted(_GOLDEN_FACTORIES)})")
    graphs = _load_factory(spec)()
    missing = sorted(set(doc) - set(graphs))
    if missing:
        print(f"[lint] {path.name}: {len(missing)} snapshot entries have "
              f"no graph factory match: {missing[:5]}")
    from repro_torch.core.planner import plan_pipeorgan
    errors = warnings = 0
    for name in sorted(doc):
        if name not in graphs:
            errors += 1
            continue
        plan = plan_pipeorgan(graphs[name], PAPER_HW, Topology.AMP)
        e, w = _emit(verify_plan(plan, hw=PAPER_HW, topology=Topology.AMP),
                     f"{path.name}:{name}", quiet)
        errors += e
        warnings += w
    return errors, warnings


def main(argv: Iterable[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="statically verify plan artifacts (no simulator)")
    ap.add_argument("paths", nargs="+",
                    help="store directory or golden-suite JSON")
    ap.add_argument("--clean", action="store_true",
                    help="delete orphaned *.tmp files in store directories")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings and orphaned tmp files too")
    ap.add_argument("--quiet", action="store_true",
                    help="print only failing artifacts")
    args = ap.parse_args(argv)

    errors = warnings = tmp = 0
    for raw in args.paths:
        path = Path(raw)
        if path.is_dir():
            e, w, t = lint_directory(path, clean=args.clean,
                                     quiet=args.quiet)
            errors, warnings, tmp = errors + e, warnings + w, tmp + t
        elif path.is_file():
            e, w = lint_golden(path, quiet=args.quiet)
            errors, warnings = errors + e, warnings + w
        else:
            print(f"[lint] {path}: no such file or directory")
            errors += 1
    failed = errors > 0 or (args.strict and (warnings > 0 or tmp > 0))
    print(f"[lint] total: {errors} errors, {warnings} warnings, "
          f"{tmp} orphaned tmp -> {'FAIL' if failed else 'OK'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
