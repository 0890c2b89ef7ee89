"""Pipeline-interval latency & energy model — Fig. 3 equations.

Three execution modes for a segment:

  * depth-1 (no pipelining): the op runs on the full array; DRAM traffic
    (inputs, outputs, weights with refetch) is serialized with compute.
  * coarse-grained, via the Global Buffer: layers alternate on the *full*
    array, one granularity chunk at a time; intermediates stay in SRAM.
    Latency = sequential compute + DRAM stalls; the weight working set of
    the whole segment competes for SRAM (the Sec. III-A trade-off).
  * fine-grained, PE-to-PE: the array is spatially partitioned between the
    segment's layers; Fig. 3 interval equations with the NoC model:

      n_j           = ceil(outvol_j / g_j)              intervals of pair j
      producer_side = delta_{j-1} * n_{j-1} / n_j       (rate normalization)
      delta_j       = max(producer, consumer, comm) + mem-stall share
      latency       = sum_j delta_j + (n_last - 1) * delta_last + hop fill
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple

from .dataflow import Dataflow, _refetch_factors
from .graph import Op
from .granularity import Granularity
from .hwconfig import HWConfig
from .noc import TrafficStats


@dataclasses.dataclass
class SegmentCost:
    latency_cycles: float
    compute_cycles: float           # compute-bound lower bound
    dram_bytes: float
    sram_bytes: float               # global-buffer traffic
    noc_hop_energy: float
    dram_energy: float
    sram_energy: float
    interval_delays: List[float]
    intervals: List[int]
    congested: bool

    @property
    def total_energy(self) -> float:
        return self.noc_hop_energy + self.dram_energy + self.sram_energy

    @property
    def objective(self) -> "Tuple[float, float]":
        """(latency_cycles, dram_bytes) — the DP's Pareto axes.  The
        frontier is pruned on these two; richer selection rules
        (``plan_api.Objective``) rank the surviving points by
        ``metrics``."""
        return (self.latency_cycles, self.dram_bytes)

    @property
    def metrics(self) -> "dict":
        """The objective-facing metric dict (``plan_api.METRICS``)."""
        return {"latency_cycles": self.latency_cycles,
                "dram_bytes": self.dram_bytes,
                "energy": self.total_energy}


def op_work(op: Op, hw: HWConfig) -> float:
    """Cycle-weight of an op: MAC-limited or data-movement-limited.

    A PE retires ``dot_product_size`` MACs but only ~1 word per cycle, so
    weightless movers (ADD/CONCAT/POOL) are bound by their output volume.
    """
    return max(op.macs(), hw.dot_product_size * op.output_volume())


def op_compute_cycles(op: Op, pes: int, hw: HWConfig) -> float:
    return op_work(op, hw) / max(1, pes * hw.dot_product_size)


def weight_dram_traffic(ops: Sequence[Op], dataflows: Sequence[Dataflow],
                        hw: HWConfig,
                        pe_alloc: Optional[Sequence[int]] = None) -> float:
    """Weight bytes fetched from DRAM for a segment.

    A layer's weights are fetched once if they stay resident on chip: in
    the layer's partition RFs (spatially partitioned pipelining) plus its
    share of the SRAM.  Deeper segments leave less buffer per layer
    (Sec. III-A trade-off); an over-budget layer streams its weights with
    its dataflow's refetch factor.
    """
    total_w = sum(op.weight_volume() for op in ops) * hw.bytes_per_word
    if total_w <= hw.sram_bytes:
        return float(total_w)
    D = max(1, len(ops))
    traffic = 0.0
    for i, (op, df) in enumerate(zip(ops, dataflows)):
        w_bytes = op.weight_volume() * hw.bytes_per_word
        resident = hw.sram_bytes / D
        if pe_alloc is not None:
            resident += pe_alloc[i] * hw.rf_bytes_per_pe
        if w_bytes <= resident:
            traffic += w_bytes
        else:
            refetch = _refetch_factors(op, df)["w"]
            traffic += w_bytes * max(1.0, refetch)
    return traffic


@functools.lru_cache(maxsize=None)
def chain_edges(depth: int) -> Tuple[Tuple[int, int], ...]:
    """The implicit linear pipeline DAG: slot j feeds slot j+1.

    Memoized: the result is immutable and the ``pipeline_edges`` property
    re-derives it on every access of every linear segment (depths are
    bounded by ``DP_MAX_SPAN`` plus a few degenerate cases, so the cache
    stays tiny)."""
    return tuple((j, j + 1) for j in range(depth - 1))


def gb_port_words_per_cycle(hw: HWConfig) -> float:
    """Aggregate global-buffer port bandwidth (one word per column lane
    per cycle) — the single definition shared by the analytical GB-staged
    interval model and the simulator's GB port server, so the two price
    the same serialization."""
    return max(1.0, float(hw.pe_cols))


def edge_burst_count(op_out_volume: int, producer_pes: int) -> int:
    """Bursts an edge moves: one word per producer PE per interval."""
    return max(1, math.ceil(max(1, op_out_volume) / max(1, producer_pes)))


def segment_cost(
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
    dram_bw_fraction: float = 1.0,
) -> SegmentCost:
    """Price one segment.  ``edges=None`` keeps the original linear-chain
    path bit-for-bit; an explicit edge list prices a branch-parallel slot
    DAG through ``_dag_segment_cost`` (same per-pair interval equations,
    generalized to fork multicasts, concurrent branches and join drains).

    ``dram_bw_fraction`` is the share of the DRAM/GB bandwidth this
    segment can actually use — 1.0 (the default, bit-identical) when the
    graph owns the substrate, less when co-resident tenants contend for
    the same memory interface (the multi-tenant planner prices their
    steady-state demand here).
    """
    D = len(ops)
    assert len(pe_alloc) == D
    if array_pes is None:
        array_pes = hw.num_pes
    if edges is not None and D > 1:
        return _dag_segment_cost(ops, dataflows, grans, pe_alloc, hw,
                                 noc_stats, via_global_buffer,
                                 external_in_bytes, external_out_bytes,
                                 skip_in_bytes, array_pes, tuple(edges),
                                 dram_bw_fraction)
    ext_dram = external_in_bytes + external_out_bytes + skip_in_bytes
    w_traffic = weight_dram_traffic(ops, dataflows, hw, pe_alloc)
    dram = ext_dram + w_traffic
    mem_stall = dram / (hw.dram_bw_bytes_per_cycle
                        * min(1.0, max(dram_bw_fraction, 1e-6)))

    # ---- depth-1 (no pipelining) --------------------------------------------
    if D == 1:
        comp = op_compute_cycles(ops[0], array_pes, hw)
        lat = comp + mem_stall
        return SegmentCost(
            latency_cycles=lat, compute_cycles=comp, dram_bytes=dram,
            sram_bytes=dram, noc_hop_energy=0.0,
            dram_energy=dram * hw.e_dram, sram_energy=dram * hw.e_sram,
            interval_delays=[lat], intervals=[1], congested=False)

    intervals: List[int] = []
    for j, g in enumerate(grans):
        outvol = ops[j].output_volume()
        n = max(1, math.ceil(outvol / max(1, g.elements)))
        intervals.append(n)

    interior_bytes = sum(ops[j].output_volume() for j in range(D - 1)
                         ) * hw.bytes_per_word

    # ---- pipelined (fine: PE-to-PE via NoC; coarse: staged through GB) -------
    # Both keep the blocked *spatial* partitioning (Sec. IV-B: coarse
    # pipelining "is always done in a blocked organization"); the GB path
    # simply replaces NoC hops with SRAM round-trips.
    # Burst model (Sec. IV-C / Fig. 15): every "compute interval" — the
    # temporal-reduction time per output word — each producer PE emits one
    # word into the NoC in lockstep.  Congestion happens when the burst
    # cannot drain through the hottest link within the interval.  The Alg. 1
    # granularity sets how many bursts must land before the consumer can
    # start (pipeline fill); finer granularity => shorter fill.
    sram_traffic = dram + (2.0 * interior_bytes if via_global_buffer
                           else 0.0)

    deltas: List[float] = []
    burst_counts: List[int] = []
    fill_intervals: List[int] = []
    congested = False
    max_hops = 0.0
    hop_e = 0.0
    prev_delta = 0.0
    prev_n = 1
    for j in range(D - 1):
        outv = max(1, ops[j].output_volume())
        n_src = max(1, pe_alloc[j])
        n_dst = max(1, pe_alloc[j + 1])
        n_j = max(1, math.ceil(outv / n_src))          # bursts in the run
        # producer: cycles of temporal reduction per word per PE
        t_prod = op_work(ops[j], hw) / outv / hw.dot_product_size
        # consumer: absorb n_src words per burst across its partition
        inv = max(1, ops[j + 1].input_volume())
        t_cons = (n_src * op_work(ops[j + 1], hw) / inv
                  / (n_dst * hw.dot_product_size))
        producer_side = prev_delta * (prev_n / n_j) if j > 0 else 0.0
        compute_interval = max(t_prod, t_cons, producer_side)
        stats = (noc_stats[j]
                 if (noc_stats is not None and not via_global_buffer)
                 else None)
        if stats is not None:
            comm = stats.interval_comm_delay(compute_interval)
            congested = congested or stats.congested(compute_interval)
            max_hops = max(max_hops, stats.max_path_hops)
            hop_e += stats.hop_energy(hw) * n_j
        else:
            comm = compute_interval
        delta = max(compute_interval, comm) + mem_stall / max(1, n_j)
        deltas.append(delta)
        burst_counts.append(n_j)
        # bursts before one granularity chunk is complete -> consumer start
        fill_intervals.append(
            min(n_j, max(1, math.ceil(grans[j].elements / n_src))))
        prev_delta, prev_n = delta, n_j

    fill = sum(d * f for d, f in zip(deltas, fill_intervals))
    latency = fill + burst_counts[-1] * deltas[-1] + max_hops
    # steady-state bound: stages run concurrently on their partitions
    comp_lb = max(op_compute_cycles(op, p, hw)
                  for op, p in zip(ops, pe_alloc))
    intervals = burst_counts
    return SegmentCost(
        latency_cycles=latency,
        compute_cycles=comp_lb,
        dram_bytes=dram,
        sram_bytes=sram_traffic,
        noc_hop_energy=hop_e,
        dram_energy=dram * hw.e_dram,
        sram_energy=sram_traffic * hw.e_sram,
        interval_delays=deltas,
        intervals=intervals,
        congested=congested)


def _dag_segment_cost(
    ops: Sequence[Op],
    dataflows: Sequence[Dataflow],
    grans: Sequence[Granularity],
    pe_alloc: Sequence[int],
    hw: HWConfig,
    noc_stats: Optional[Sequence[Optional[TrafficStats]]],
    via_global_buffer: bool,
    external_in_bytes: float,
    external_out_bytes: float,
    skip_in_bytes: float,
    array_pes: int,
    edges: Tuple[Tuple[int, int], ...],
    dram_bw_fraction: float = 1.0,
) -> SegmentCost:
    """Fig. 3 interval equations over an explicit pipeline slot DAG.

    ``edges[k] = (u, v)`` streams slot u's output into slot v;
    ``grans[k]`` / ``noc_stats[k]`` align with ``edges``.  The linear
    chain is the special case ``edges == chain_edges(D)`` (for which this
    reproduces the classic path exactly); branch segments add fork
    multicast out-edges, concurrent branch chains and multi-edge join
    convergence.  Generalizations of the chain formulas:

      * producer-side rate chaining follows every DAG path — an edge's
        compute interval is floored by the slowest *incoming* edge of its
        producer slot (burst-ratio converted), exactly like ``prev_delta
        * n_prev / n_j`` chains along the chain;
      * pipeline fill accumulates along the *critical path* of
        ``delta_e x fill_e`` contributions rather than the full sum;
      * the segment drains when the slowest edge into the sink (the
        join) finishes: ``max over final edges of (path_fill + n_e *
        delta_e)``.
    """
    D = len(ops)
    assert len(grans) == len(edges)
    ext_dram = external_in_bytes + external_out_bytes + skip_in_bytes
    w_traffic = weight_dram_traffic(ops, dataflows, hw, pe_alloc)
    dram = ext_dram + w_traffic
    mem_stall = dram / (hw.dram_bw_bytes_per_cycle
                        * min(1.0, max(dram_bw_fraction, 1e-6)))

    sink = D - 1
    interior_bytes = sum(ops[u].output_volume() for u in range(D)
                         if u != sink) * hw.bytes_per_word
    sram_traffic = dram + (2.0 * interior_bytes if via_global_buffer
                           else 0.0)

    incoming: dict = {}
    for k, (u, v) in enumerate(edges):
        incoming.setdefault(v, []).append(k)

    n_bursts: List[int] = []
    deltas: List[float] = []
    fills: List[int] = []
    path_fill: List[float] = []
    congested = False
    max_hops = 0.0
    hop_e = 0.0
    for k, (u, v) in enumerate(edges):
        outv = max(1, ops[u].output_volume())
        n_src = max(1, pe_alloc[u])
        n_dst = max(1, pe_alloc[v])
        n_k = edge_burst_count(outv, n_src)
        t_prod = op_work(ops[u], hw) / outv / hw.dot_product_size
        inv = max(1, ops[v].input_volume())
        t_cons = (n_src * op_work(ops[v], hw) / inv
                  / (n_dst * hw.dot_product_size))
        producer_side = max(
            (deltas[d] * (n_bursts[d] / n_k) for d in incoming.get(u, ())),
            default=0.0)
        compute_interval = max(t_prod, t_cons, producer_side)
        stats = (noc_stats[k]
                 if (noc_stats is not None and not via_global_buffer)
                 else None)
        if stats is not None:
            comm = stats.interval_comm_delay(compute_interval)
            congested = congested or stats.congested(compute_interval)
            max_hops = max(max_hops, stats.max_path_hops)
            hop_e += stats.hop_energy(hw) * n_k
        else:
            comm = compute_interval
        delta = max(compute_interval, comm) + mem_stall / max(1, n_k)
        fill_k = min(n_k, max(1, math.ceil(grans[k].elements / n_src)))
        upstream_fill = max(
            (path_fill[d] for d in incoming.get(u, ())), default=0.0)
        n_bursts.append(n_k)
        deltas.append(delta)
        fills.append(fill_k)
        path_fill.append(upstream_fill + delta * fill_k)

    finals = incoming.get(sink, [])
    if not finals:
        raise ValueError("pipeline DAG has no edge into the final slot")
    latency = max(path_fill[k] + n_bursts[k] * deltas[k]
                  for k in finals) + max_hops
    comp_lb = max(op_compute_cycles(op, p, hw)
                  for op, p in zip(ops, pe_alloc))
    return SegmentCost(
        latency_cycles=latency,
        compute_cycles=comp_lb,
        dram_bytes=dram,
        sram_bytes=sram_traffic,
        noc_hop_energy=hop_e,
        dram_energy=dram * hw.e_dram,
        sram_energy=sram_traffic * hw.e_sram,
        interval_delays=deltas,
        intervals=n_bursts,
        congested=congested)
