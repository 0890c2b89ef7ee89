"""Deterministic, shard-aware token pipeline.

Port of ``repro.data.pipeline``: an index-based sampler over a
memory-mapped token file, or a synthetic generator with the same
semantics (a learnable arithmetic stream plus 2% noise tokens).  Every
example is a function of (seed, index) alone, with the reference's numpy
``RandomState`` seeding, so the port's batches are the reference's bit
for bit, and a restart at step k replays the exact global batches.
``device_batches`` yields each global batch on a device, or on a mesh
(``shard_batch``): each rank makes only its rows, the global batch's
block at its coordinate on the data axes (pod-major, the reference's
``P(("pod", "data"))`` order), and holds them as a ``Shard(0)`` DTensor
over those axes; no rank materializes the global batch.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.hints import batch_axes, placements
from repro_torch.models.common import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    seed: int = 0
    corpus_path: Optional[str] = None    # memmap of uint16 tokens
    n_synthetic_docs: int = 4096


class TokenDataset:
    """Deterministic random-access dataset of (tokens, labels) examples."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._corpus = None
        if cfg.corpus_path and Path(cfg.corpus_path).exists():
            self._corpus = np.memmap(cfg.corpus_path, dtype=np.uint16,
                                     mode="r")

    def example(self, index: int) -> np.ndarray:
        """(seq_len + 1,) tokens for global example ``index`` (stateless)."""
        cfg = self.cfg
        if self._corpus is not None:
            n = len(self._corpus) - (cfg.seq_len + 1)
            rng = np.random.RandomState((cfg.seed * 0x9E3779B1 + index)
                                        % 2**31)
            start = rng.randint(0, max(1, n))
            return np.asarray(self._corpus[start:start + cfg.seq_len + 1],
                              np.int32)
        # synthetic: learnable arithmetic stream (next = cur + stride mod m)
        # plus noise tokens, deterministic in (seed, index)
        rng = np.random.RandomState((cfg.seed * 0x9E3779B1 + index) % 2**31)
        m = min(cfg.vocab, 97)
        stride = 1 + index % 5
        start = rng.randint(0, m)
        base = (start + stride * np.arange(cfg.seq_len + 1)) % m
        noise = rng.rand(cfg.seq_len + 1) < 0.02
        base = np.where(noise, rng.randint(0, cfg.vocab, cfg.seq_len + 1),
                        base)
        return base.astype(np.int32)

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        idx0 = step * cfg.global_batch
        toks = np.stack([self.example(idx0 + i)
                         for i in range(cfg.global_batch)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def shard_batch_at(self, step: int, shard: int, n_shards: int
                       ) -> Dict[str, np.ndarray]:
        """Only this host's slice of the global batch."""
        cfg = self.cfg
        per = cfg.global_batch // n_shards
        idx0 = step * cfg.global_batch + shard * per
        toks = np.stack([self.example(idx0 + i) for i in range(per)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_device(host: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """One host batch as contiguous tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def data_shard(mesh) -> tuple:
    """(this rank's index, the count) of the data shards of ``mesh``:
    its coordinate on the data axes, pod-major."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for a in batch_axes(mesh):
        n = mesh.size(names.index(a))
        index, count = index * n + coord[names.index(a)], count * n
    return index, count


def shard_batch(ds: TokenDataset, step: int, mesh, device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """The global batch at ``step`` as DTensors on ``mesh``: rows over the
    data axes where the batch divides them (each rank making its rows
    alone), else every rank holding all of it."""
    dev = resolve_device(device or mesh.device_type)
    index, count = data_shard(mesh)
    daxes = batch_axes(mesh)
    if ds.cfg.global_batch % count == 0:
        host = ds.shard_batch_at(step, index, count)
        pl = placements((daxes, None), mesh)
    else:
        host = ds.global_batch_at(step)
        pl = placements((None, None), mesh)
    return {k: DTensor.from_local(v, mesh, pl, run_check=False)
            for k, v in to_device(host, dev).items()}


def device_batches(ds: TokenDataset, device: DeviceLike = None,
                   start_step: int = 0, mesh=None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the global batches from ``start_step`` on, on ``device``
    (``cuda`` unless the caller names another), or with ``mesh`` as its
    DTensors (``shard_batch``)."""
    dev = None if mesh is not None else resolve_device(device)
    step = start_step
    while True:
        if mesh is not None:
            yield shard_batch(ds, step, mesh, device)
        else:
            yield to_device(ds.global_batch_at(step), dev)
        step += 1
