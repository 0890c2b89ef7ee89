"""Multi-tenant substrate planning: co-resident graphs on one PE array.

The paper's XR-Bench usage scenarios run *concurrent* tasks — eye
segmentation, gaze estimation and hand tracking share one device — yet
single-graph planning owns the whole substrate.  This module plans N
``PlanRequest``s onto one array at once:

  * **spatial partitions** — contiguous column bands of the PE array
    (the same whole-column band allocation ``spatial.place_branches``
    uses for parallel branches, lifted to tenant granularity).  Each
    tenant is planned by the ordinary cut-point DP on its band's
    sub-``HWConfig`` and all tenants run concurrently;
  * **time-multiplexed slices** — every tenant keeps the whole array and
    the substrate is shared in share-weighted slices (fluid
    processor-sharing model), which preserves the serialized makespan
    but can improve share-weighted completion times;
  * **serialized** — the whole-substrate plans executed back to back in
    priority order: the baseline every other candidate is guarded
    against (the double-guard discipline: a multi-tenant plan is never
    worse than serializing the tenants).

Cross-tenant interference is *priced*, not ignored (Krishnan et al.:
shared-NoC contention dominates exactly this regime):

  * shared NoC links — every tenant's flow sets are translated into
    full-substrate coordinates (``noc.offset_flow_batch``) and
    accumulated onto one link-load map with shared ingress-port
    arbitration (``noc.interference_channel_load``, the cross-tenant
    generalization of ``join_flow_batch``).  Column bands are
    link-disjoint under dimension-ordered routing, so this price is
    zero for the spatial candidates — which is the point of spatial
    isolation — but the machinery prices any overlapping partitioning.
  * contended DRAM/GB bandwidth — each tenant's steady-state DRAM
    demand rate reduces its co-residents' usable bandwidth share, priced
    through ``pipeline_model.segment_cost(dram_bw_fraction=...)``.

``MultiTenantPlan`` round-trips losslessly through a ``PlanStore``
directory (``.mtplan.json`` artifacts keyed by the request's cache
token), so a warm store boots with zero planner invocations; see
``docs/serving.md`` for the offline-plan -> warm-store -> admission flow.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .artifact import (PlanSchemaError, PlanStore, plan_from_dict,
                       plan_to_dict)
from .hwconfig import HWConfig
from .noc import (FlowBatch, Topology, analyze_batch,
                  interference_channel_load, offset_flow_batch)
from .pipeline_model import segment_cost, weight_dram_traffic
from .plan_api import Constraint, PlanRequest
from .planner import PlanResult, SegmentPlan, edge_flow_batch
from .spatial import SpatialOrg, _band_rows

#: schema version of the ``.mtplan.json`` artifact (independent of the
#: single-plan schema: tenant plans embed via ``plan_to_dict``).
MT_SCHEMA_VERSION = 1
MT_ARTIFACT_KIND = "pipeorgan-mtplan"
MT_SUFFIX = ".mtplan.json"

#: a co-resident tenant never sees less than this share of the DRAM
#: bandwidth (the interface is arbitrated, not starved).
MIN_DRAM_BW_FRACTION = 0.05


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a planning problem plus its scheduling weight.

    ``share`` weights substrate allocation (band widths, time slices and
    the admission scheduler's weighted round-robin); ``priority`` orders
    the serialized schedule and admission (higher first).
    """
    request: PlanRequest
    share: float = 1.0
    priority: int = 0
    name: Optional[str] = None

    def __post_init__(self) -> None:
        if self.share <= 0:
            raise ValueError("tenant share must be > 0")
        if self.name is None:
            object.__setattr__(self, "name", self.request.graph.name)

    def to_json_dict(self) -> dict:
        return {"name": self.name, "share": self.share,
                "priority": self.priority,
                "request": self.request.to_json_dict()}


@dataclasses.dataclass(frozen=True)
class MultiTenantRequest:
    """N tenants on one substrate, frozen at construction.

    Every tenant request must target the same hardware and topology (one
    physical array); identity follows ``PlanRequest``: the tuple of
    tenant identities plus the partition-search knobs is the cache key,
    and ``cache_token()`` is the ``PlanStore`` file key.
    """
    tenants: Tuple[TenantSpec, ...]
    min_band_cols: int = 4
    time_slice: bool = True

    def __post_init__(self) -> None:
        if not isinstance(self.tenants, tuple):
            object.__setattr__(self, "tenants", tuple(self.tenants))
        if len(self.tenants) < 2:
            raise ValueError("a MultiTenantRequest needs >= 2 tenants")
        if self.min_band_cols < 1:
            raise ValueError("min_band_cols must be >= 1")
        hw0 = self.tenants[0].request.hw
        topo0 = self.tenants[0].request.topology
        for t in self.tenants[1:]:
            if t.request.hw != hw0:
                raise ValueError("all tenants must share one HWConfig "
                                 "(one physical substrate)")
            if t.request.topology != topo0:
                raise ValueError("all tenants must share one topology")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique: {names}")

    @property
    def hw(self) -> HWConfig:
        return self.tenants[0].request.hw

    @property
    def topology(self) -> Topology:
        return self.tenants[0].request.topology

    @property
    def key(self) -> Tuple:
        return (tuple(t.request.key for t in self.tenants),
                tuple((t.share, t.priority, t.name) for t in self.tenants),
                self.min_band_cols, self.time_slice)

    def __hash__(self) -> int:
        return hash(self.key)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, MultiTenantRequest):
            return NotImplemented
        return self.key == other.key

    def to_json_dict(self) -> dict:
        return {"tenants": [t.to_json_dict() for t in self.tenants],
                "min_band_cols": self.min_band_cols,
                "time_slice": self.time_slice}

    def cache_token(self) -> str:
        blob = json.dumps(self.to_json_dict(), sort_keys=True,
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TenantPlan:
    """One tenant's slice of a resolved multi-tenant plan."""
    name: str
    share: float
    priority: int
    plan: PlanResult                      # planned on its (band) substrate
    band: Optional[Tuple[int, int]]       # [col0, col1) or None = whole array
    latency_cycles: float                 # interference-priced run time
    completion_cycles: float              # finish time under the schedule
    dram_bytes: float
    dram_bw_fraction: float               # usable DRAM bandwidth share
    link_interference: float              # worst shared-channel load delta


@dataclasses.dataclass
class MultiTenantPlan:
    """The resolved schedule: mode, per-tenant plans, guard baselines.

    ``candidates`` records every (label, makespan, dram,
    weighted_completion) the search priced — including the guard-rejected
    ones — so reports can show what the serialized baseline cost and
    what spatial partitioning won.
    """
    mode: str                             # "spatial" | "time" | "serialized"
    tenants: List[TenantPlan]
    makespan_cycles: float
    dram_bytes: float
    energy: float
    serialized_cycles: float
    serialized_dram: float
    weighted_completion_cycles: float
    candidates: Tuple[Tuple[str, float, float, float], ...] = ()

    @property
    def speedup_vs_serialized(self) -> float:
        return self.serialized_cycles / max(self.makespan_cycles, 1e-12)


# ---------------------------------------------------------------------------
# band substrates
# ---------------------------------------------------------------------------


def band_hw(hw: HWConfig, width: int) -> HWConfig:
    """The sub-substrate a column band exposes to the single-graph DP.

    Same rows, ``width`` columns, and the proportional slice of the
    shared global buffer.  DRAM bandwidth is left whole — contention for
    it is priced separately per co-residency (``dram_bw_fraction``), not
    baked into the band.
    """
    if not 1 <= width <= hw.pe_cols:
        raise ValueError(f"band width {width} outside [1, {hw.pe_cols}]")
    if width == hw.pe_cols:
        return hw
    return dataclasses.replace(
        hw, name=f"{hw.name}-band{hw.pe_rows}x{width}", pe_cols=width,
        sram_bytes=max(1, (hw.sram_bytes * width) // hw.pe_cols))


def band_splits(request: MultiTenantRequest,
                work: Sequence[float]) -> List[Tuple[int, ...]]:
    """Candidate column-band splits: share-, work- and equal-weighted.

    Each split is a tuple of band widths (one per tenant, in tenant
    order) covering all columns, every band >= ``min_band_cols``.
    ``work`` weights the work-proportional candidate (typically the
    tenants' solo whole-substrate latencies)."""
    hw = request.hw
    n = len(request.tenants)
    if hw.pe_cols < n * request.min_band_cols:
        return []
    weightings = [
        [t.share for t in request.tenants],
        list(work),
        [1.0] * n,
    ]
    splits: List[Tuple[int, ...]] = []
    for weights in weightings:
        if min(weights) <= 0:
            continue
        cols = _band_rows(weights, hw.pe_cols)
        # enforce the minimum width by stealing from the widest band
        while min(cols) < request.min_band_cols:
            cols[cols.index(min(cols))] += 1
            cols[cols.index(max(cols))] -= 1
        split = tuple(cols)
        if split not in splits:
            splits.append(split)
    return splits


# ---------------------------------------------------------------------------
# interference pricing
# ---------------------------------------------------------------------------


def segment_flow_batches(seg: SegmentPlan) -> List[FlowBatch]:
    """Each pipeline edge's priced flow set, in band-local coordinates —
    the same reconstruction the simulator replays (``edge_flow_batch``:
    own stream, path-riding skips, join-converging siblings)."""
    if seg.placement is None or seg.placement.via_global_buffer:
        return []
    fine = seg.org in (SpatialOrg.FINE_STRIPED_1D,
                       SpatialOrg.CHECKERBOARD_2D)
    out_volumes = [op.output_volume() for op in seg.ops]
    return [edge_flow_batch(seg.placement, seg.pipeline_edges, k,
                            seg.pe_alloc, out_volumes, seg.intra_skips,
                            seg.traffic_scale, fine)
            for k in range(len(seg.pipeline_edges))]


def repriced_cost(seg: SegmentPlan, hw: HWConfig, topology: Topology,
                  dram_bw_fraction: float = 1.0,
                  link_deltas: Optional[Sequence[float]] = None):
    """Re-price one planned segment under co-residency.

    Rebuilds the per-edge NoC stats the planner priced (flow for flow),
    adds each edge's shared-channel interference delta to its worst
    load, and re-runs the Fig. 3 interval model with the contended DRAM
    bandwidth share.  With ``dram_bw_fraction=1.0`` and zero deltas this
    reproduces ``seg.cost`` — the identity the regression tests pin.
    """
    fbs = segment_flow_batches(seg)
    if fbs:
        stats = []
        for k, st in enumerate(analyze_batch(fbs, hw, topology)):
            delta = link_deltas[k] if link_deltas else 0.0
            if delta > 0:
                st = dataclasses.replace(
                    st, worst_channel_load=st.worst_channel_load + delta)
            stats.append(st)
    else:
        stats = None
    via_gb = (seg.placement.via_global_buffer
              if seg.placement is not None else False)
    w_traffic = weight_dram_traffic(seg.ops, seg.dataflows, hw,
                                    seg.pe_alloc)
    ext = max(0.0, seg.cost.dram_bytes - seg.skip_in_bytes - w_traffic)
    return segment_cost(
        seg.ops, seg.dataflows, seg.granularities, seg.pe_alloc, hw,
        stats, via_gb, ext, 0.0, seg.skip_in_bytes, seg.array_pes,
        seg.edges or None, dram_bw_fraction=dram_bw_fraction)


def _dram_bw_fractions(plans: Sequence[PlanResult],
                       hw: HWConfig) -> List[float]:
    """Per-tenant usable DRAM bandwidth share under co-residency.

    Each tenant's steady-state demand rate (bytes per cycle over its
    solo run) is subtracted from its co-residents' available bandwidth;
    a floor keeps the arbiter work-conserving rather than starving."""
    rates = [p.dram_bytes / max(p.latency_cycles, 1.0) for p in plans]
    bw = hw.dram_bw_bytes_per_cycle
    return [min(1.0, max(MIN_DRAM_BW_FRACTION,
                         1.0 - (sum(rates) - r) / bw))
            for r in rates]


def _hot_flow_batch(plan: PlanResult, bhw: HWConfig, topology: Topology,
                    col0: int) -> Optional[FlowBatch]:
    """A tenant's steady-state interference set: its hottest edge's flow
    batch, translated into full-substrate coordinates."""
    fbs = [fb for seg in plan.segments for fb in segment_flow_batches(seg)]
    if not fbs:
        return None
    # one batched sweep over every edge; argmax keeps the first maximum,
    # matching the scalar strictly-greater scan this replaced
    loads = [st.worst_channel_load
             for st in analyze_batch(fbs, bhw, topology)]
    return offset_flow_batch(fbs[int(np.argmax(loads))], 0, col0)


# ---------------------------------------------------------------------------
# schedule models
# ---------------------------------------------------------------------------


def _serial_order(tenants: Sequence[TenantSpec],
                  lat: Sequence[float]) -> List[int]:
    """Priority order, shortest-first within a priority level."""
    return sorted(range(len(tenants)),
                  key=lambda i: (-tenants[i].priority, lat[i],
                                 tenants[i].name))


def _fluid_completions(lat: Sequence[float],
                       shares: Sequence[float]) -> List[float]:
    """Share-weighted processor-sharing completion times.

    All tenants run 'concurrently'; each active tenant progresses at
    ``share_i / sum(active shares)`` of the substrate rate.  Work
    conserving: the last completion equals ``sum(lat)`` exactly."""
    n = len(lat)
    remaining = [float(x) for x in lat]
    done = [0.0] * n
    active = set(range(n))
    t = 0.0
    while active:
        tot = sum(shares[i] for i in active)
        step, first = min((remaining[i] * tot / shares[i], i)
                          for i in active)
        t += step
        for i in list(active):
            remaining[i] -= step * shares[i] / tot
            if remaining[i] <= 1e-9 * max(1.0, lat[i]):
                done[i] = t
                active.discard(i)
    return done


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Candidate:
    label: str
    mode: str
    tenants: List[TenantPlan]
    makespan: float
    dram: float
    energy: float

    @property
    def weighted_completion(self) -> float:
        tot = sum(t.share for t in self.tenants)
        return sum(t.share * t.completion_cycles
                   for t in self.tenants) / max(tot, 1e-12)


def _plan_one(req: PlanRequest, planner, store: Optional[PlanStore]
              ) -> PlanResult:
    """Store -> planner -> save-back, the ServeEngine resolution order."""
    if store is not None:
        try:
            plan = store.load(req)
        except PlanSchemaError:
            plan = None
        if plan is not None:
            return plan
    plan = planner.plan(req)
    if store is not None:
        store.save(req, plan)
    return plan


def resolve_multi_tenant(request: MultiTenantRequest,
                         planner=None,
                         store: Optional[PlanStore] = None
                         ) -> MultiTenantPlan:
    """Resolve N tenants onto one substrate.

    Searches serialized, time-multiplexed and column-band spatial
    candidates; prices cross-tenant link and DRAM interference into the
    concurrent ones; and selects under the double guard: a candidate is
    admissible only if it is no worse than the serialized baseline on
    *both* makespan and DRAM traffic, ties broken by share-weighted
    completion (where time multiplexing can win), then by the simplest
    mode.  With a warm ``store`` (multi-tenant artifact hit) this makes
    zero planner invocations.
    """
    if store is not None:
        cached = load_plan(store, request)
        if cached is not None:
            cached.source = "store"        # plain attribute, not a field
            return cached
    if planner is None:
        from .planner_service import get_planner
        planner = get_planner()
    hw, topology = request.hw, request.topology
    tenants = request.tenants
    n = len(tenants)

    # -- serialized whole-substrate baseline (always a candidate) ------------
    solo = [_plan_one(t.request, planner, store) for t in tenants]
    solo_lat = [p.latency_cycles for p in solo]
    order = _serial_order(tenants, solo_lat)
    completion = [0.0] * n
    t_acc = 0.0
    for i in order:
        t_acc += solo_lat[i]
        completion[i] = t_acc
    serialized = _Candidate(
        "serialized", "serialized",
        [TenantPlan(t.name, t.share, t.priority, solo[i], None,
                    solo_lat[i], completion[i], solo[i].dram_bytes, 1.0,
                    0.0)
         for i, t in enumerate(tenants)],
        makespan=sum(solo_lat), dram=sum(p.dram_bytes for p in solo),
        energy=sum(p.energy for p in solo))

    candidates: List[_Candidate] = [serialized]

    # -- time-multiplexed slices (whole substrate, fluid share weights) ------
    if request.time_slice:
        fluid = _fluid_completions(solo_lat, [t.share for t in tenants])
        candidates.append(_Candidate(
            "time-sliced", "time",
            [TenantPlan(t.name, t.share, t.priority, solo[i], None,
                        solo_lat[i], fluid[i], solo[i].dram_bytes, 1.0,
                        0.0)
             for i, t in enumerate(tenants)],
            makespan=sum(solo_lat),
            dram=serialized.dram, energy=serialized.energy))

    # -- spatial column-band partitions --------------------------------------
    def _spatial_candidate(label: str, split: Tuple[int, ...],
                           bhws: Sequence[HWConfig],
                           band_plans: Sequence[PlanResult]) -> _Candidate:
        """Price one concurrent band layout: per-tenant DRAM bandwidth
        shares plus per-edge shared-link interference deltas."""
        col0 = [sum(split[:i]) for i in range(n)]
        fracs = _dram_bw_fractions(band_plans, hw)
        hot = [_hot_flow_batch(p, bhw, topology, c0)
               for p, bhw, c0 in zip(band_plans, bhws, col0)]
        rows: List[TenantPlan] = []
        for i, t in enumerate(tenants):
            others = [h for j, h in enumerate(hot)
                      if j != i and h is not None]
            lat_i = 0.0
            link_delta_max = 0.0
            for seg in band_plans[i].segments:
                deltas: List[float] = []
                for fb in segment_flow_batches(seg):
                    own = offset_flow_batch(fb, 0, col0[i])
                    lone, shared = interference_channel_load(
                        own, others, hw, topology)
                    deltas.append(max(0.0, shared - lone))
                link_delta_max = max(link_delta_max,
                                     max(deltas, default=0.0))
                cost = repriced_cost(seg, bhws[i], topology, fracs[i],
                                     deltas or None)
                lat_i += cost.latency_cycles
            rows.append(TenantPlan(
                t.name, t.share, t.priority, band_plans[i],
                (col0[i], col0[i] + split[i]), lat_i, lat_i,
                band_plans[i].dram_bytes, fracs[i], link_delta_max))
        return _Candidate(
            label, "spatial", rows,
            makespan=max(r.latency_cycles for r in rows),
            dram=sum(r.dram_bytes for r in rows),
            energy=sum(p.energy for p in band_plans))

    for split in band_splits(request, solo_lat):
        bhws = [band_hw(hw, w) for w in split]
        breqs = [dataclasses.replace(t.request, hw=bhw)
                 for t, bhw in zip(tenants, bhws)]
        band_plans = [_plan_one(r, planner, store) for r in breqs]
        label = f"spatial-{'x'.join(map(str, split))}"
        candidates.append(
            _spatial_candidate(label, split, bhws, band_plans))
        if sum(p.dram_bytes for p in band_plans) > serialized.dram:
            # the latency-first band plans spend more DRAM than the
            # whole-substrate baseline (smaller GB slice → more
            # externalized traffic) and would trip the DRAM guard; ask
            # the DP for the fastest band plans under each tenant's solo
            # DRAM cap and price that layout as a second candidate
            capped = list(band_plans)
            improved = False
            for i, (breq, p) in enumerate(zip(breqs, band_plans)):
                if p.dram_bytes <= solo[i].dram_bytes:
                    continue
                cp = _plan_one(dataclasses.replace(
                    breq, constraints=tuple(breq.constraints) + (
                        Constraint("dram_bytes",
                                   max_value=solo[i].dram_bytes),)),
                    planner, store)
                if cp.dram_bytes <= solo[i].dram_bytes:
                    capped[i] = cp
                    improved = True
            if improved:
                candidates.append(_spatial_candidate(
                    label + "-dramcap", split, bhws, capped))

    # -- double guard + selection --------------------------------------------
    admissible = [serialized] + [
        c for c in candidates[1:]
        if c.makespan <= serialized.makespan and c.dram <= serialized.dram]
    mode_rank = {"serialized": 0, "time": 1, "spatial": 2}
    best = min(admissible,
               key=lambda c: (c.makespan, c.dram, c.weighted_completion,
                              mode_rank[c.mode], c.label))

    result = MultiTenantPlan(
        mode=best.mode, tenants=best.tenants,
        makespan_cycles=best.makespan, dram_bytes=best.dram,
        energy=best.energy, serialized_cycles=serialized.makespan,
        serialized_dram=serialized.dram,
        weighted_completion_cycles=best.weighted_completion,
        candidates=tuple((c.label, c.makespan, c.dram,
                          c.weighted_completion) for c in candidates))
    result.source = "planner"              # plain attribute, not a field
    if store is not None:
        save_plan(store, request, result)
    return result


# ---------------------------------------------------------------------------
# artifact round trip (PlanStore integration)
# ---------------------------------------------------------------------------


def _tenant_to_dict(t: TenantPlan) -> dict:
    return {"name": t.name, "share": t.share, "priority": t.priority,
            "band": list(t.band) if t.band is not None else None,
            "latency_cycles": t.latency_cycles,
            "completion_cycles": t.completion_cycles,
            "dram_bytes": t.dram_bytes,
            "dram_bw_fraction": t.dram_bw_fraction,
            "link_interference": t.link_interference,
            "plan": plan_to_dict(t.plan)}


def _tenant_from_dict(d: dict) -> TenantPlan:
    return TenantPlan(
        name=d["name"], share=d["share"], priority=d["priority"],
        plan=plan_from_dict(d["plan"]),
        band=tuple(d["band"]) if d["band"] is not None else None,
        latency_cycles=d["latency_cycles"],
        completion_cycles=d["completion_cycles"],
        dram_bytes=d["dram_bytes"],
        dram_bw_fraction=d["dram_bw_fraction"],
        link_interference=d["link_interference"])


def mtplan_to_dict(plan: MultiTenantPlan) -> dict:
    return {"mode": plan.mode,
            "tenants": [_tenant_to_dict(t) for t in plan.tenants],
            "makespan_cycles": plan.makespan_cycles,
            "dram_bytes": plan.dram_bytes, "energy": plan.energy,
            "serialized_cycles": plan.serialized_cycles,
            "serialized_dram": plan.serialized_dram,
            "weighted_completion_cycles": plan.weighted_completion_cycles,
            "candidates": [list(c) for c in plan.candidates]}


def mtplan_from_dict(d: dict) -> MultiTenantPlan:
    return MultiTenantPlan(
        mode=d["mode"],
        tenants=[_tenant_from_dict(t) for t in d["tenants"]],
        makespan_cycles=d["makespan_cycles"],
        dram_bytes=d["dram_bytes"], energy=d["energy"],
        serialized_cycles=d["serialized_cycles"],
        serialized_dram=d["serialized_dram"],
        weighted_completion_cycles=d["weighted_completion_cycles"],
        candidates=tuple(tuple(c) for c in d["candidates"]))


@dataclasses.dataclass
class MultiTenantArtifact:
    """A resolved multi-tenant plan plus its request identity."""
    plan: MultiTenantPlan
    request: Optional[dict] = None        # MultiTenantRequest.to_json_dict()
    token: Optional[str] = None
    schema_version: int = MT_SCHEMA_VERSION

    @staticmethod
    def from_plan(plan: MultiTenantPlan,
                  request: Optional[MultiTenantRequest] = None
                  ) -> "MultiTenantArtifact":
        return MultiTenantArtifact(
            plan=plan,
            request=request.to_json_dict() if request is not None else None,
            token=request.cache_token() if request is not None else None)

    def to_json(self) -> str:
        doc = {"kind": MT_ARTIFACT_KIND,
               "schema_version": self.schema_version,
               "token": self.token,
               "request": self.request,
               "plan": mtplan_to_dict(self.plan)}
        return json.dumps(doc, indent=1, sort_keys=True) + "\n"

    @staticmethod
    def from_json(text: str) -> "MultiTenantArtifact":
        doc = json.loads(text)
        if doc.get("kind") != MT_ARTIFACT_KIND:
            raise PlanSchemaError(
                f"not a multi-tenant artifact (kind={doc.get('kind')!r})")
        version = doc.get("schema_version")
        if version != MT_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"multi-tenant artifact schema v{version} != supported "
                f"v{MT_SCHEMA_VERSION}; re-plan and re-save")
        return MultiTenantArtifact(plan=mtplan_from_dict(doc["plan"]),
                                   request=doc.get("request"),
                                   token=doc.get("token"),
                                   schema_version=version)

    def save(self, path) -> Path:
        path = Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(self.to_json())
        os.replace(tmp, path)
        return path

    @staticmethod
    def load(path) -> "MultiTenantArtifact":
        return MultiTenantArtifact.from_json(Path(path).read_text())


def store_path(store: PlanStore, request: MultiTenantRequest) -> Path:
    names = "+".join(t.name or "" for t in request.tenants)
    safe = "".join(ch if ch.isalnum() or ch in "-_.+" else "_"
                   for ch in names)
    return store.root / (f"{safe}-mt-{request.cache_token()[:16]}"
                         f"{MT_SUFFIX}")


def save_plan(store: PlanStore, request: MultiTenantRequest,
              plan: MultiTenantPlan) -> Path:
    store.saves += 1
    return MultiTenantArtifact.from_plan(plan, request).save(
        store_path(store, request))


def load_plan(store: PlanStore,
              request: MultiTenantRequest) -> Optional[MultiTenantPlan]:
    path = store_path(store, request)
    if not path.exists():
        store.misses += 1
        return None
    art = MultiTenantArtifact.load(path)   # schema mismatch raises
    if art.token != request.cache_token():
        store.misses += 1
        return None
    store.hits += 1
    return art.plan


# ---------------------------------------------------------------------------
# differential validation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiTenantValidation:
    """Per-tenant differential reports plus schedule-level consistency."""
    mode: str
    tenants: Dict[str, "ValidationReport"]    # noqa: F821 (simulator)
    makespan_cycles: float                    # analytical (contended)
    simulated_makespan: float                 # simulator, uncontended

    @property
    def ok(self) -> bool:
        # the repo-wide contract is the latency band (congestion-verdict
        # agreement is asserted separately on the substrates that pin it)
        return all(r.latency_within_band for r in self.tenants.values())


def validate_multi_tenant(request: MultiTenantRequest,
                          plan: MultiTenantPlan,
                          max_bursts: Optional[int] = None
                          ) -> MultiTenantValidation:
    """Differential-check every tenant's slot DAGs against the simulator.

    Each tenant's plan is executed segment by segment on its own (band)
    substrate under the repo-wide latency band contract; the schedule
    level then recombines the simulated latencies with the plan's mode
    (max for concurrent spatial partitions, sum otherwise)."""
    from .simulator import DEFAULT_MAX_BURSTS, validate_plan
    max_bursts = max_bursts or DEFAULT_MAX_BURSTS
    reports: Dict[str, object] = {}
    sims: List[float] = []
    for tp in plan.tenants:
        hw_t = (band_hw(request.hw, tp.band[1] - tp.band[0])
                if tp.band is not None else request.hw)
        rep = validate_plan(tp.plan, hw=hw_t, max_bursts=max_bursts)
        reports[tp.name] = rep
        sims.append(sum(s.simulated_latency for s in rep.segments))
    simulated = max(sims) if plan.mode == "spatial" else sum(sims)
    return MultiTenantValidation(plan.mode, reports, plan.makespan_cycles,
                                 simulated)
