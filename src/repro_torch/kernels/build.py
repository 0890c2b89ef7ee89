"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``_build/lib<name>-<digest>.so`` at first use (the digest
covers the sources and flags, so an edit rebuilds).  The build runs on
the machine with the card; nothing is compiled at import time, so the
CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: flags of one source only.  ``price_rows`` must round every float64
#: operation as the host does (the DP compares its latencies exactly), so
#: nvcc may not contract ``a * b + c`` into a fused multiply-add there.
EXTRA_FLAGS = {"price_rows": ("-fmad=false",)}


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


@dataclasses.dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float          # 0.0 when the library was already built
    log: str                # nvcc's output (ptxas registers / spills)


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (see README.md)")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[BuildResult]:
    """Compile every named kernel library that is missing, one ``nvcc``
    per source, all started together; raise if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: List[BuildResult] = []
    running = []
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            results.append(BuildResult(name, path, 0.0, ""))
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, path, tmp, proc))
    failures = []
    for name, path, tmp, proc in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)
        results.append(BuildResult(name, path, time.perf_counter() - t0,
                                   log))
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return results


def load(name: str) -> ctypes.CDLL:
    """Load the library of kernel ``name``, building it first if missing.
    Each kernel's wrapper loads it once and keeps the handle."""
    path = library_path(name)
    if not path.exists():
        build([name])
    return ctypes.CDLL(str(path))
