"""Batched torch twin of the Fig. 3 interval equations (``pipeline_model``).

Port of ``repro.core.pipeline_model_jax``.  ``segment_cost`` prices one
candidate at a time with Python floats; the planner's DP calls it
thousands of times per cold plan.  This module re-expresses the per-edge
interval recurrence over ragged slot-DAG rows so *all* (cut, org,
staging) candidates of a span batch are priced in one kernel launch:

  * the host (``build_row``) prepares everything that is cheap and
    irregular — dataflows, granularities, PE allocation, NoC traffic
    analysis (``_pair_traffic`` stays host-side, served by whole-sweep
    ``noc.analyze_batch`` passes over cached ``RouteIncidence`` tables
    and LRU-cached per pair), DRAM / SRAM byte totals, the compute
    lower bound, and each edge's incoming edges as a list;
  * the device (``kernels.price_rows``: the CUDA kernel on ``cuda``, its
    plain torch version on ``cpu``) replays only the sequential part
    numpy cannot batch: per-edge ``delta`` chaining (producer-side rate
    floors follow DAG paths), congestion capping, pipeline-fill critical
    paths and the join drain.

Engine-split idiom: ``pipeline_model.segment_cost`` is the semantic pin;
``tests/test_torch_engine_parity.py`` holds this module to 1e-6 relative
latency against it.  The kernel is built without fused multiply-adds and
runs the host's operations in the host's order, so its float64 results
match ``segment_cost`` to the last bit.  Numbers stay float64 — cycle
counts exceed 2**24, where float32 drops whole cycles.

One call, one launch: ``price_rows`` packs a call's rows, whatever their
edge counts, into one staging tensor (``stage_rows``), copies it to the
card once, launches once and copies one packed output back.  The
reference instead launched once per power-of-two edge bucket;
``price_cache_info`` still counts those buckets, the (padded edges,
batch) shapes a call reuses or meets first, for
``Planner.cache_registry()``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import price_rows as _kernel
from ..models.common import resolve_device
from .dataflow import Dataflow
from .granularity import Granularity
from .graph import Op
from .hwconfig import HWConfig
from .noc import TrafficStats
from .pipeline_model import (SegmentCost, chain_edges, edge_burst_count,
                             op_compute_cycles, op_work, segment_cost,
                             weight_dram_traffic)


# ---------------------------------------------------------------------------
# host-side candidate rows
# ---------------------------------------------------------------------------


_FLOAT_FIELDS = ("t_prod", "t_cons", "n_bursts", "fill", "load", "hops",
                 "hop_unit")


@dataclasses.dataclass
class PriceRow:
    """One candidate's device inputs + host passthrough scalars.

    ``floats`` holds the seven per-edge rows of ``_FLOAT_FIELDS`` (each
    also readable by its name: ``row.t_prod`` is ``row.floats[0]``) and
    ``flags`` the two per-edge masks (bit 0 ``stats_present``, bit 1
    ``final``), so that a call's rows stage in one copy each.
    ``in_deg`` / ``in_idx`` list the producer-side rate-chain adjacency,
    the kernel's input: edge k's incoming edges (the edges into its
    producer slot) are the next ``in_deg[k]`` entries of ``in_idx``, in
    edge order; ``inc`` is the same as the reference's (E, E) matrix.
    ``host_cost`` short-circuits depth-1 candidates, which have no
    recurrence and are priced entirely on the host.
    """
    n_edges: int
    floats: np.ndarray          # float64 (7, E); n_bursts >= 1
    flags: np.ndarray           # uint8 (E,)
    in_deg: np.ndarray          # int32 (E,)
    in_idx: np.ndarray          # int32 (sum of in_deg,)
    mem_stall: float
    # host passthrough for SegmentCost assembly
    dram_bytes: float
    sram_bytes: float
    comp_lb: float
    dram_energy: float
    sram_energy: float
    intervals: List[int]
    host_cost: Optional[SegmentCost] = None

    @property
    def stats_present(self) -> np.ndarray:
        """bool: the edge has NoC stats (its flows cross the NoC)."""
        return (self.flags & 1).astype(bool)

    @property
    def final(self) -> np.ndarray:
        """bool: the edge drains into the sink slot."""
        return (self.flags & 2).astype(bool)

    @property
    def inc(self) -> np.ndarray:
        """bool (E, E): ``inc[k, d]`` marks edge d as incoming to edge k's
        producer slot, the reference's form of the incoming lists."""
        E = self.n_edges
        inc = np.zeros((E, E), bool)
        inc[np.repeat(np.arange(E), self.in_deg), self.in_idx] = True
        return inc


for _j, _name in enumerate(_FLOAT_FIELDS):
    setattr(PriceRow, _name,
            property(lambda self, j=_j: self.floats[j],
                     doc=f"row {_j} of ``floats``"))
del _j, _name


def build_row(
    ops: Sequence[Op],
    dataflows: Sequence[Dataflow],
    grans: Sequence[Granularity],
    pe_alloc: Sequence[int],
    hw: HWConfig,
    noc_stats: Optional[Sequence[Optional[TrafficStats]]],
    via_global_buffer: bool,
    external_in_bytes: float,
    external_out_bytes: float,
    skip_in_bytes: float = 0.0,
    array_pes: Optional[int] = None,
    edges: Optional[Sequence[Tuple[int, int]]] = None,
) -> PriceRow:
    """Mirror of ``segment_cost``'s argument list -> one device row."""
    D = len(ops)
    if array_pes is None:
        array_pes = hw.num_pes
    if D == 1:
        cost = segment_cost(ops, dataflows, grans, pe_alloc, hw, noc_stats,
                            via_global_buffer, external_in_bytes,
                            external_out_bytes, skip_in_bytes,
                            array_pes=array_pes, edges=edges)
        return PriceRow(0, np.zeros((7, 0)), np.zeros(0, np.uint8),
                        np.zeros(0, np.int32), np.zeros(0, np.int32), 0.0,
                        cost.dram_bytes, cost.sram_bytes,
                        cost.compute_cycles, cost.dram_energy,
                        cost.sram_energy,
                        list(cost.intervals), host_cost=cost)

    edge_list = tuple(edges) if edges is not None else chain_edges(D)
    E = len(edge_list)
    assert len(grans) == E

    ext_dram = external_in_bytes + external_out_bytes + skip_in_bytes
    dram = ext_dram + weight_dram_traffic(ops, dataflows, hw, pe_alloc)
    mem_stall = dram / hw.dram_bw_bytes_per_cycle
    sink = D - 1
    interior_bytes = sum(ops[u].output_volume() for u in range(D)
                         if u != sink) * hw.bytes_per_word
    sram_traffic = dram + (2.0 * interior_bytes if via_global_buffer
                           else 0.0)
    comp_lb = max(op_compute_cycles(op, p, hw)
                  for op, p in zip(ops, pe_alloc))

    incoming: Dict[int, List[int]] = {}
    for k, (u, v) in enumerate(edge_list):
        incoming.setdefault(v, []).append(k)

    floats = np.zeros((7, E))
    t_prod, t_cons, n_bursts, fill, load, hops, hop_unit = floats
    n_bursts[:] = 1.0
    sp = np.zeros(E, bool)
    fin = np.zeros(E, bool)
    in_deg = np.zeros(E, np.int32)
    in_idx: List[int] = []
    intervals: List[int] = []
    for k, (u, v) in enumerate(edge_list):
        outv = max(1, ops[u].output_volume())
        n_src = max(1, pe_alloc[u])
        n_dst = max(1, pe_alloc[v])
        n_k = edge_burst_count(outv, n_src)
        intervals.append(n_k)
        n_bursts[k] = float(n_k)
        t_prod[k] = op_work(ops[u], hw) / outv / hw.dot_product_size
        inv = max(1, ops[v].input_volume())
        t_cons[k] = (n_src * op_work(ops[v], hw) / inv
                     / (n_dst * hw.dot_product_size))
        fill[k] = float(min(n_k, max(1, math.ceil(grans[k].elements
                                                  / n_src))))
        stats = (noc_stats[k]
                 if (noc_stats is not None and not via_global_buffer)
                 else None)
        if stats is not None:
            sp[k] = True
            load[k] = stats.worst_channel_load
            hops[k] = float(stats.max_path_hops)
            hop_unit[k] = stats.hop_energy(hw)
        fin[k] = (v == sink)
        ins = incoming.get(u, ())
        in_deg[k] = len(ins)
        in_idx.extend(ins)

    if not fin.any():
        raise ValueError("pipeline DAG has no edge into the final slot")
    return PriceRow(E, floats, sp | (fin.astype(np.uint8) << 1), in_deg,
                    np.asarray(in_idx, np.int32), mem_stall, dram,
                    sram_traffic, comp_lb, dram * hw.e_dram,
                    sram_traffic * hw.e_sram, intervals)


_SHAPES_SEEN: Dict[Tuple[int, int], int] = {}
_HITS = 0
_MISSES = 0


def price_cache_info() -> Tuple[int, int, Optional[int], int]:
    """(hits, misses, maxsize, currsize) of the edge-bucket shapes — the
    (padded edges, batch) signature a call's bucket reuses (hit) or meets
    first (miss), as the reference's registry counts them.  Feeds
    ``Planner.cache_registry()`` like the lru_cache providers."""
    return (_HITS, _MISSES, None, len(_SHAPES_SEEN))


def price_cache_clear() -> None:
    global _HITS, _MISSES
    _SHAPES_SEEN.clear()
    _HITS = _MISSES = 0


_bucket_edges = _kernel.bucket_edges      # the reference's name


def _count_buckets(rows: Sequence[PriceRow]) -> None:
    global _HITS, _MISSES
    sizes: Dict[int, int] = {}
    for r in rows:
        e_pad = _bucket_edges(r.n_edges)
        sizes[e_pad] = sizes.get(e_pad, 0) + 1
    for key in sizes.items():
        if key in _SHAPES_SEEN:
            _HITS += 1
        else:
            _MISSES += 1
        _SHAPES_SEEN[key] = _SHAPES_SEEN.get(key, 0) + 1


def stage_rows(rows: Sequence[PriceRow], pin: bool = False
               ) -> Tuple[torch.Tensor, _kernel.Layout]:
    """Rows with a recurrence (``n_edges >= 1``) in the kernel's ragged
    layout, in one uint8 staging tensor (``kernels.price_rows.layout``);
    ``pin`` pins it for the copy to the card."""
    B = len(rows)
    E = np.fromiter((r.n_edges for r in rows), np.int64, B)
    deg = np.concatenate([r.in_deg for r in rows])
    lay = _kernel.layout(B, int(E.sum()), int(deg.sum()))
    stage = torch.empty(lay.nbytes, dtype=torch.uint8, pin_memory=pin)
    host = stage.numpy()

    def part(at, n, dtype):
        return host[at:at + n * np.dtype(dtype).itemsize].view(dtype)

    np.concatenate([r.floats for r in rows], axis=1,
                   out=part(lay.floats, 7 * lay.N, np.float64
                            ).reshape(7, lay.N))
    part(lay.mem_stall, B, np.float64)[:] = [r.mem_stall for r in rows]
    rp = part(lay.row_ptr, B + 1, np.int32)
    rp[0] = 0
    np.cumsum(E, out=rp[1:])
    ip = part(lay.in_ptr, lay.N + 1, np.int32)
    ip[0] = 0
    np.cumsum(deg, out=ip[1:])
    np.concatenate([r.in_idx for r in rows], out=part(lay.in_idx, lay.M,
                                                       np.int32))
    np.concatenate([r.flags for r in rows], out=part(lay.flags, lay.N,
                                                     np.uint8))
    return stage, lay


def _assemble(rows: Sequence[PriceRow], out: np.ndarray,
              lay: _kernel.Layout) -> List[SegmentCost]:
    """``SegmentCost``s from the packed output of ``stage_rows(rows)``."""
    B = lay.B
    lat = out[:B].tolist()
    hop_e = out[B:2 * B].tolist()
    congested = out[2 * B:3 * B].tolist()
    deltas = out[3 * B:].tolist()
    costs = []
    at = 0
    for b, r in enumerate(rows):
        # positional, in SegmentCost's field order: latency, compute,
        # dram and sram bytes, hop, dram and sram energy, interval
        # delays, intervals, congested
        costs.append(SegmentCost(
            lat[b], r.comp_lb, r.dram_bytes, r.sram_bytes, hop_e[b],
            r.dram_energy, r.sram_energy, deltas[at:at + r.n_edges],
            list(r.intervals), congested[b] != 0.0))
        at += r.n_edges
    return costs


def price_rows(rows: Sequence[PriceRow], device=None) -> List[SegmentCost]:
    """Price a batch of candidates: one kernel launch for all of them.

    Depth-1 rows pass through their host cost.  The rest are staged
    together (``stage_rows``) and priced on ``device`` (default ``cuda``,
    which raises without a card; ``"cpu"`` runs the plain version on the
    same staging tensor): one copy to the card, one launch, one copy of
    the packed output back.  A call with only depth-1 rows touches no
    device.
    """
    out: List[Optional[SegmentCost]] = [None] * len(rows)
    idxs = []
    for i, row in enumerate(rows):
        if row.host_cost is not None:
            out[i] = row.host_cost
        else:
            idxs.append(i)
    if not idxs:
        return out  # type: ignore[return-value]
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"price_rows runs on cuda or cpu, not {dev}")
    priced = [rows[i] for i in idxs]
    _count_buckets(priced)
    stage, lay = stage_rows(priced, pin=dev.type == "cuda")
    costs = _assemble(priced, _kernel.price_rows(stage, lay, dev), lay)
    for i, cost in zip(idxs, costs):
        out[i] = cost
    return out  # type: ignore[return-value]
