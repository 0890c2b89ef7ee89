"""Step-atomic checkpoints of trees of tensors.

Port of ``repro.checkpoint.store``, with its on-disk layout key for key,
so a checkpoint written by either package restores in the other.
Layout: ``<dir>/step_%08d/`` (written to ``.tmp_step_%08d`` and then
renamed, so a crash mid-save never corrupts the latest checkpoint), one
``.npy`` a leaf, named by the leaf's path as ``jax.tree_util`` names it
(dict keys, sequence indices, NamedTuple fields such as ``AdamWState``'s
``step``/``mu``/``nu``) joined by ``/`` with ``/`` written as ``__``, and
a ``metadata.json`` with the step and the sorted keys.  numpy has no
bfloat16, so bfloat16 leaves are stored as float32 (exact) and restored
in the target leaf's dtype.  ``restore`` places each leaf on the target
leaf's device, or distributes it onto a mesh: a DTensor target leaf (or
a ``NamedSharding`` of ``shardings``) keeps this rank's shard of it, so
restoring onto another mesh than the one that saved is a reshard.

``AsyncCheckpointer`` copies the tree to the host on the caller's thread
(the training loop updates its tensors in place afterwards) and writes
it on a background thread, overlapping the write with the next steps.
A tree of DTensors is gathered by every rank of its mesh (a collective)
and written by rank 0 alone; ``wait`` then ends in a barrier, so no rank
reads a checkpoint before it is published.
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten


def _to_numpy(leaf: Any) -> np.ndarray:
    """A host copy of ``leaf`` (bfloat16 as float32, exactly); a DTensor
    gathered in full first (a collective)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to(device="cpu", dtype=dtype, copy=True).numpy()
    return np.asarray(leaf)


def _key(path) -> str:
    return "/".join(path)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {_key(path): _to_numpy(leaf)
            for path, leaf in flatten_with_path(tree)}


def save(directory: str | Path, step: int, tree: Any,
         metadata: Optional[dict] = None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = _flatten(tree)
    for key, arr in flat.items():
        np.save(tmp / (key.replace("/", "__") + ".npy"), arr)
    meta = dict(metadata or {})
    meta.update({"step": step, "keys": sorted(flat)})
    (tmp / "metadata.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                      # atomic publish
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")]
    return max(steps) if steps else None


def restore(directory: str | Path, step: int, target: Any,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``target``: each leaf a new tensor
    in the target leaf's dtype, on its device (numpy arrays and scalars
    as numpy arrays of their dtype).  A DTensor target leaf, or a leaf
    whose entry in ``shardings`` (a matching tree of
    ``distributed.sharding.NamedSharding``, None for none) is given,
    becomes a DTensor of those placements holding this rank's shard:
    every rank reads the file and keeps its part."""
    from repro_torch.distributed.sharding import from_full, sharding_of
    d = Path(directory) / f"step_{step:08d}"
    targets = flatten_with_path(target)
    shards = ([None] * len(targets) if shardings is None
              else _sharding_leaves(shardings, len(targets)))
    out = []
    for (path, leaf), sh in zip(targets, shards):
        arr = np.load(d / (_key(path).replace("/", "__") + ".npy"))
        if isinstance(leaf, DTensor) or sh is not None:
            sh = sh if sh is not None else sharding_of(leaf)
            device = (leaf.to_local().device if isinstance(leaf, DTensor)
                      else leaf.device)
            full = torch.from_numpy(arr).to(dtype=leaf.dtype)
            out.append(from_full(full, sh, device))
        elif isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype))
        else:
            out.append(arr.astype(np.asarray(leaf).dtype))
    return unflatten(target, out)


def _sharding_leaves(shardings: Any, n: int) -> List[Any]:
    """The leaves of a shardings tree, None entries kept."""
    from repro_torch.distributed.sharding import NamedSharding
    out: List[Any] = []

    def walk(node):
        if node is None or isinstance(node, NamedSharding):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            for v in node:
                walk(v)
    walk(shardings)
    if len(out) != n:
        raise ValueError(f"{len(out)} shardings for {n} leaves")
    return out


def read_metadata(directory: str | Path, step: int) -> dict:
    d = Path(directory) / f"step_{step:08d}"
    return json.loads((d / "metadata.json").read_text())


class AsyncCheckpointer:
    """Background-thread checkpoint writer (overlaps with training).
    ``saves`` records each save: its step, the seconds of the host copy
    on the caller's thread and of the write on the background thread.
    A write that failed raises from the next ``wait``."""

    def __init__(self, directory: str | Path):
        self.directory = Path(directory)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_saved: Optional[int] = None
        self.saves: List[Dict[str, float]] = []
        self._group = False

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[dict] = None) -> None:
        self.wait()
        self._group = any(isinstance(t, DTensor) for t in leaves(tree))
        t0 = time.perf_counter()
        host_tree = tree_map(_to_numpy, tree)   # snapshot on host
        record = {"step": step, "snapshot_s": time.perf_counter() - t0}
        self.saves.append(record)
        if self._group and dist.get_rank() != 0:
            self.last_saved = step           # rank 0 writes
            return

        def work():
            t1 = time.perf_counter()
            try:
                save(self.directory, step, host_tree, metadata)
            except Exception as e:  # noqa: BLE001 — raised by wait()
                self._error = e
                return
            record["write_s"] = time.perf_counter() - t1
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._group:
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err
