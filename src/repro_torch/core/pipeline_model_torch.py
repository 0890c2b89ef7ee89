"""Batched torch twin of the Fig. 3 interval equations (``pipeline_model``).

Port of ``repro.core.pipeline_model_jax``.  ``segment_cost`` prices one
candidate at a time with Python floats; the planner's DP calls it
thousands of times per cold plan.  This module re-expresses the per-edge
interval recurrence over padded slot-DAG tensors so *all* (cut, org,
staging) candidates of a span batch are priced in one kernel launch per
edge bucket:

  * the host (``build_row``) prepares everything that is cheap and
    irregular — dataflows, granularities, PE allocation, NoC traffic
    analysis (``_pair_traffic`` stays host-side, served by whole-sweep
    ``noc.analyze_batch`` passes over cached ``RouteIncidence`` tables
    and LRU-cached per pair), DRAM / SRAM byte totals, the compute
    lower bound;
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

Shape discipline: candidates bucket by padded edge count (powers of two,
floor 2), as in the reference, one launch per bucket.
``price_cache_info`` counts the (padded edges, batch) shapes a call
reuses or meets first, for ``Planner.cache_registry()``; hits + misses is
the number of buckets priced.
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


@dataclasses.dataclass
class PriceRow:
    """One candidate's device inputs + host passthrough scalars.

    Arrays are length ``n_edges``; ``inc[k, d]`` marks edge d as incoming
    to edge k's producer slot (the producer-side rate-chain adjacency).
    ``host_cost`` short-circuits depth-1 candidates, which have no
    recurrence and are priced entirely on the host.
    """
    n_edges: int
    t_prod: np.ndarray
    t_cons: np.ndarray
    n_bursts: np.ndarray        # float64, each >= 1
    fill: np.ndarray
    load: np.ndarray
    hops: np.ndarray
    hop_unit: np.ndarray        # per-burst hop energy of the edge's flows
    stats_present: np.ndarray   # bool
    final: np.ndarray           # bool: edge drains into the sink slot
    inc: np.ndarray             # bool (E, E)
    mem_stall: float
    # host passthrough for SegmentCost assembly
    dram_bytes: float
    sram_bytes: float
    comp_lb: float
    dram_energy: float
    sram_energy: float
    intervals: List[int]
    host_cost: Optional[SegmentCost] = None


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
        return PriceRow(0, *(np.zeros(0),) * 8, np.zeros(0, bool),
                        np.zeros((0, 0), bool), 0.0, cost.dram_bytes,
                        cost.sram_bytes, cost.compute_cycles,
                        cost.dram_energy, cost.sram_energy,
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

    t_prod = np.zeros(E)
    t_cons = np.zeros(E)
    n_bursts = np.ones(E)
    fill = np.zeros(E)
    load = np.zeros(E)
    hops = np.zeros(E)
    hop_unit = np.zeros(E)
    sp = np.zeros(E, bool)
    fin = np.zeros(E, bool)
    inc = np.zeros((E, E), bool)
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
        for d in incoming.get(u, ()):
            inc[k, d] = True

    if not fin.any():
        raise ValueError("pipeline DAG has no edge into the final slot")
    return PriceRow(E, t_prod, t_cons, n_bursts, fill, load, hops,
                    hop_unit, sp, fin, inc, mem_stall, dram,
                    sram_traffic, comp_lb, dram * hw.e_dram,
                    sram_traffic * hw.e_sram, intervals)


_SHAPES_SEEN: Dict[Tuple[int, int], int] = {}
_HITS = 0
_MISSES = 0


def price_cache_info() -> Tuple[int, int, Optional[int], int]:
    """(hits, misses, maxsize, currsize) of the batch shapes — the shape
    signature a call reuses (hit) or meets first (miss).  Feeds
    ``Planner.cache_registry()`` like the lru_cache providers."""
    return (_HITS, _MISSES, None, len(_SHAPES_SEEN))


def price_cache_clear() -> None:
    global _HITS, _MISSES
    _SHAPES_SEEN.clear()
    _HITS = _MISSES = 0


def _bucket_edges(E: int) -> int:
    return max(2, 1 << (E - 1).bit_length())


def pack_rows(rows: Sequence[PriceRow], E_pad: int, device
              ) -> Tuple[torch.Tensor, ...]:
    """One edge bucket's rows as the kernel's (B, E_pad) tensors on
    ``device``: t_prod, t_cons, n, fill, load, hops, hop_unit, sp, fin,
    inc, mem_stall.  Padded edges are inert (t = 0, n = 1, masks off)."""
    B = len(rows)
    # the seven float rows in one array, so the batch reaches the device
    # in four copies
    f = np.zeros((7, B, E_pad))
    f[2] = 1.0
    masks = np.zeros((2, B, E_pad), bool)                # sp, fin
    inc = np.zeros((B, E_pad, E_pad), bool)
    mem_stall = np.zeros(B)
    for b, r in enumerate(rows):
        e = r.n_edges
        for j, a in enumerate((r.t_prod, r.t_cons, r.n_bursts, r.fill,
                               r.load, r.hops, r.hop_unit)):
            f[j, b, :e] = a
        masks[0, b, :e] = r.stats_present
        masks[1, b, :e] = r.final
        inc[b, :e, :e] = r.inc
        mem_stall[b] = r.mem_stall
    ft = torch.from_numpy(f).to(device)
    mt = torch.from_numpy(masks).to(device)
    return (*ft, mt[0], mt[1], torch.from_numpy(inc).to(device),
            torch.from_numpy(mem_stall).to(device))


def price_rows(rows: Sequence[PriceRow], device=None) -> List[SegmentCost]:
    """Price a batch of candidates; one kernel launch per edge bucket.

    Depth-1 rows pass through their host cost.  The rest are grouped by
    padded edge count and priced on ``device`` (default ``cuda``, which
    raises without a card; ``"cpu"`` runs the plain version); padded edges
    are inert (t = 0, n = 1, masks off) and sliced away before
    ``SegmentCost`` assembly.
    """
    global _HITS, _MISSES
    out: List[Optional[SegmentCost]] = [None] * len(rows)
    groups: Dict[int, List[int]] = {}
    for i, row in enumerate(rows):
        if row.host_cost is not None:
            out[i] = row.host_cost
        else:
            groups.setdefault(_bucket_edges(row.n_edges), []).append(i)
    if not groups:
        return out  # type: ignore[return-value]
    dev = resolve_device(device)

    for E_pad, idxs in sorted(groups.items()):
        B = len(idxs)
        key = (E_pad, B)
        if key in _SHAPES_SEEN:
            _HITS += 1
        else:
            _MISSES += 1
        _SHAPES_SEEN[key] = _SHAPES_SEEN.get(key, 0) + 1
        lat, congested, hop_e, deltas = _kernel.price_rows(
            *pack_rows([rows[i] for i in idxs], E_pad, dev))
        lat = lat.cpu().numpy()
        congested = congested.cpu().numpy()
        hop_e = hop_e.cpu().numpy()
        deltas = deltas.cpu().numpy()
        for b, i in enumerate(idxs):
            r = rows[i]
            out[i] = SegmentCost(
                latency_cycles=float(lat[b]),
                compute_cycles=r.comp_lb,
                dram_bytes=r.dram_bytes,
                sram_bytes=r.sram_bytes,
                noc_hop_energy=float(hop_e[b]),
                dram_energy=r.dram_energy,
                sram_energy=r.sram_energy,
                interval_delays=[float(x) for x in
                                 deltas[b, :r.n_edges]],
                intervals=list(r.intervals),
                congested=bool(congested[b]))
    return out  # type: ignore[return-value]

