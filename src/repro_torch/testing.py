"""Random inputs for the port's tests and ``chip_smoke.py``.

``synthetic_rows`` makes planner pricing rows (``PriceRow``) beyond the
shapes a planning run gives: wider slot DAGs and more incoming edges.
The planner never calls this module.  ``train_batch`` makes a training
batch of any arch, patch embeddings and frames included.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .core.pipeline_model_torch import PriceRow
from .models.common import ModelConfig


def train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """A seeded numpy batch for ``cfg``'s loss: int32 "tokens" and
    "labels" (batch, seq) below the vocab, and float32 "patch_embeds"
    (vlm) or "frames" (encdec) drawn from a standard normal."""
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
           for k in ("tokens", "labels")}
    if cfg.arch_kind == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.arch_kind == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def synthetic_rows(edge_counts: Sequence[int], seed: int = 0,
                   max_in_degree: int = 4) -> List[PriceRow]:
    """Random candidates shaped like ``build_row``'s, one per entry of
    ``edge_counts``: every edge takes up to ``max_in_degree`` earlier
    edges of its row as incoming (edge order is a slot-DAG order), the
    last edge and about a fifth of the others drain into the sink, about
    70% carry NoC stats, and loads reach past the compute interval so
    that some edges congest.  Made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    rows = []
    for E in edge_counts:
        f = rng.uniform(0.0, 8.0, (7, E))
        n = rng.integers(1, 4096, E)
        f[2] = n
        f[3] = np.minimum(n, rng.integers(1, 64, E))
        sp = rng.random(E) < 0.7
        fin = rng.random(E) < 0.2
        fin[-1] = True
        in_deg = np.zeros(E, np.int32)
        in_idx: List[int] = []
        for k in range(1, E):
            ins = np.sort(rng.choice(k, rng.integers(0, min(k, max_in_degree)
                                                     + 1), replace=False))
            in_deg[k] = len(ins)
            in_idx.extend(ins.tolist())
        rows.append(PriceRow(
            E, f, sp | (fin.astype(np.uint8) << 1), in_deg,
            np.asarray(in_idx, np.int32),
            float(rng.uniform(0.0, 1e5)), 0.0, 0.0, 0.0, 0.0, 0.0,
            n.tolist()))
    return rows
