"""Static plan verifier: pass-based invariant checking, no simulator.

PipeOrgan's headline claim — congestion-free communication under a
flexible spatial organization — is checked dynamically elsewhere (the
event simulator inside the ``LATENCY_BAND`` contract).  This module
proves the *structural* half statically: every invariant below is a
property of the plan object alone (plus the hardware it targets), so a
corrupted artifact, a planner regression or a hand-edited plan is caught
in microseconds without replaying a single burst.

``verify_plan(target, hw, topology) -> VerifyReport`` accepts a
``PlanResult``, a ``PlanArtifact``, a ``MultiTenantPlan`` /
``MultiTenantArtifact``, a single ``SegmentPlan`` (span-shelf payloads)
or a raw artifact ``dict`` and runs independent, individually-toggleable
passes:

  placement      P001 partition violation, P002 grid/slot range
  tenancy        P003 band geometry, P004 bands not link-disjoint
  routing        R001 link over capacity vs. claimed congestion-free,
                 R002 4-port ingress arbitration infeasible,
                 R003 stored NoC stats disagree with reconstruction
  graph          G001 cyclic slot DAG, G002 malformed DAG/segmentation
  granularity    G003 granularity disagrees with Fig. 4 re-derivation,
                 G004 non-pipelinable granularity streamed PE-to-PE
  conservation   G005 per-segment byte conservation broken
  schema         A001 wrong artifact kind, A002 schema version mismatch
  identity       A003 token mismatch, A004 request/plan mismatch
  fold           A005 translated span is not a period-shifted image of
                 its representative

Every finding carries a stable code, a severity and a location.  The
routing pass reconstructs the dimension-ordered X-then-Y routes through
the same ``RouteIncidence`` tables the planner priced with
(``edge_flow_batch`` is the one flow construction shared by planner,
simulators and this verifier), so "verified" means "the exact flows the
plan will transport fit the links" — not an approximation of them.

Wired in three places: ``Planner.plan(verify=...)`` (post-condition
gate), ``PlanStore``/``SpanShelf`` read-through modes, and the
``python -m repro_torch.launch.lint`` CLI (docs/verifier.md describes
the reference's verifier, of which this is a copy).
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple, Union)

import numpy as np

from .granularity import finest_granularity
from .graph import Graph
from .hwconfig import HWConfig, PAPER_HW
from .noc import (FlowBatch, Topology, analyze_batch,
                  interference_channel_load, offset_flow_batch,
                  route_incidence)
from .pipeline_model import weight_dram_traffic
from .plan_api import content_token, graph_fingerprint, _jsonable
from .planner import PlanResult, SegmentPlan, edge_flow_batch
from .spatial import SpatialOrg

__all__ = [
    "Finding", "VerifyReport", "PlanVerifyError", "PlanVerifyWarning",
    "verify_plan", "verify_segment", "pass_names", "FINDING_CODES",
    "VERIFY_MODES",
]

#: accepted values everywhere a verification mode is taken
#: (``Planner.plan``, ``PlanStore``, ``SpanShelf``).
VERIFY_MODES = ("off", "warn", "strict")

#: relative tolerance for re-derived floats (dram bytes, channel loads).
#: Artifacts are lossless and the host pricer is deterministic, so the
#: tolerance only absorbs engine noise (the torch pricer, built with
#: ``-fmad=false``, is bit-equal to the host).
FLOAT_RTOL = 1e-6

ERROR = "error"
WARNING = "warning"

#: finding code -> (pass name, one-line description); the docs table and
#: the CLI legend render from this.
FINDING_CODES: Dict[str, Tuple[str, str]] = {
    "P001": ("placement", "PE partition violation (empty/overlapping "
                          "slot, bad pe_alloc)"),
    "P002": ("placement", "placement outside the grid (shape or slot "
                          "id out of range)"),
    "P003": ("tenancy", "multi-tenant column band geometry illegal"),
    "P004": ("tenancy", "spatial-mode tenant bands are not "
                        "link-disjoint"),
    "R001": ("routing", "per-link injected rate exceeds link capacity "
                        "while the plan claims congestion-free"),
    "R002": ("routing", "4-port ingress arbitration infeasible at the "
                        "claimed interval"),
    "R003": ("routing", "stored NoC stats disagree with the "
                        "reconstructed routes"),
    "G001": ("graph", "pipeline slot DAG has a cycle"),
    "G002": ("graph", "malformed slot DAG or segmentation"),
    "G003": ("granularity", "stored granularity disagrees with the "
                            "Fig. 4 / LCM re-derivation"),
    "G004": ("granularity", "non-pipelinable granularity streamed "
                            "PE-to-PE (not staged through GB)"),
    "G005": ("conservation", "segment DRAM bytes != external in/out + "
                             "skip + weight traffic"),
    "A001": ("schema", "wrong artifact kind"),
    "A002": ("schema", "artifact schema version mismatch"),
    "A003": ("identity", "artifact token does not hash its request"),
    "A004": ("identity", "artifact request disagrees with its plan"),
    "A005": ("fold", "fold-translated span is not a period-shifted "
                     "image of its representative"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verified-invariant violation."""
    code: str             # stable id, e.g. "R001"
    severity: str         # "error" | "warning"
    location: str         # e.g. "segment[3] [12,20)"
    message: str

    def __str__(self) -> str:
        return f"{self.code} {self.severity} @ {self.location}: " \
               f"{self.message}"


class PlanVerifyError(ValueError):
    """Raised by strict-mode verification on error-severity findings."""

    def __init__(self, report: "VerifyReport"):
        self.report = report
        lines = "\n  ".join(str(f) for f in report.errors)
        super().__init__(
            f"plan verification failed ({len(report.errors)} error(s) "
            f"on {report.target}):\n  {lines}")


class PlanVerifyWarning(UserWarning):
    """Emitted by warn-mode verification; carries the offending report."""


@dataclasses.dataclass
class VerifyReport:
    """The outcome of one ``verify_plan`` run."""
    target: str
    passes_run: Tuple[str, ...]
    findings: List[Finding]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        """True when no error-severity finding survived (warnings allowed)."""
        return not self.errors

    def summary(self) -> str:
        status = "OK" if self.ok else "FAIL"
        head = (f"verify {self.target}: {status} "
                f"({len(self.passes_run)} passes, "
                f"{len(self.errors)} errors, "
                f"{len(self.warnings)} warnings)")
        if not self.findings:
            return head
        return head + "\n" + "\n".join(f"  {f}" for f in self.findings)

    def raise_if_errors(self) -> "VerifyReport":
        if self.errors:
            raise PlanVerifyError(self)
        return self


# ---------------------------------------------------------------------------
# pass framework
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Ctx:
    """Everything a plan-scope pass may consult."""
    plan: PlanResult
    hw: HWConfig
    topology: Topology
    graph: Optional[Graph]        # reconstructed from the plan's own ops
    artifact: Optional[object] = None   # PlanArtifact when verifying one
    prefix: str = ""                    # location prefix (tenant scope)
    whole_graph: bool = True            # segments must partition [0, N)
    _value_keys: Dict[int, Tuple] = dataclasses.field(default_factory=dict)

    def loc(self, i: int) -> str:
        seg = self.plan.segments[i].segment
        return f"{self.prefix}segment[{i}] [{seg.start},{seg.stop})"

    def value_key(self, i: int, seg: "SegmentPlan") -> Tuple:
        """Per-run cache of ``_seg_value_key`` — several passes key their
        twin-dedup memos on it for the same segment."""
        key = self._value_keys.get(i)
        if key is None:
            key = _seg_value_key(seg)
            self._value_keys[i] = key
        return key


_PassFn = Callable[[_Ctx], Iterator[Finding]]
_PASSES: Dict[str, _PassFn] = {}


def _register_pass(name: str) -> Callable[[_PassFn], _PassFn]:
    def deco(fn: _PassFn) -> _PassFn:
        _PASSES[name] = fn
        return fn
    return deco


def pass_names() -> Tuple[str, ...]:
    """Every registered plan-scope pass, in execution order, plus the
    artifact- and tenancy-scope passes handled by the dispatcher."""
    return tuple(_PASSES) + ("schema", "identity", "tenancy")


def _rebuild_graph(plan: PlanResult) -> Optional[Graph]:
    """The graph the plan claims to implement, rebuilt from its own ops.

    Segment ops carry their full shape and (by-name) wiring, so the
    concatenation in segment order *is* the original graph whenever the
    plan is well-formed; a malformed plan (duplicate names, broken
    topological order) yields ``None`` and the graph-dependent passes
    report through ``graph``'s own findings instead of crashing."""
    try:
        ops = [op
               for seg in sorted(plan.segments, key=lambda s: s.segment.start)
               for op in seg.ops]
        return Graph(plan.graph_name, ops)
    except (ValueError, KeyError):
        return None


# ---------------------------------------------------------------------------
# placement pass (P001 / P002)
# ---------------------------------------------------------------------------


@_register_pass("placement")
def _check_placement(ctx: _Ctx) -> Iterator[Finding]:
    hw = ctx.hw
    # fold-translated twins share one placement object and one pe_alloc
    # value — the grid census (bincount over 1k cells) runs once per
    # unique (placement, alloc), with findings re-located per segment
    clean: set = set()
    for i, seg in enumerate(ctx.plan.segments):
        key = (id(seg.placement), tuple(seg.pe_alloc), len(seg.ops),
               seg.array_pes, seg.branches)
        if key in clean:
            continue
        found = list(_placement_findings(seg, ctx.loc(i), hw))
        if not found:
            clean.add(key)
        yield from found


def _placement_findings(seg: SegmentPlan, loc: str,
                        hw: HWConfig) -> Iterator[Finding]:
    D = len(seg.ops)
    if len(seg.pe_alloc) != D:
        yield Finding("P001", ERROR, loc,
                      f"pe_alloc has {len(seg.pe_alloc)} entries for "
                      f"{D} slots")
        return
    bad = [p for p in seg.pe_alloc if p < 1]
    if bad:
        yield Finding("P001", ERROR, loc,
                      f"pe_alloc entries must be >= 1 (got {bad})")
    usable = seg.array_pes if seg.array_pes is not None else hw.num_pes
    if sum(seg.pe_alloc) > usable:
        yield Finding("P001", ERROR, loc,
                      f"pe_alloc sums to {sum(seg.pe_alloc)} > usable "
                      f"substrate {usable}")
    pl = seg.placement
    if pl is None:
        if D > 1:
            yield Finding("P001", ERROR, loc,
                          "multi-op segment carries no placement")
        return
    grid = np.asarray(pl.grid)
    if grid.shape != (hw.pe_rows, hw.pe_cols):
        yield Finding("P002", ERROR, loc,
                      f"placement grid {grid.shape} != substrate "
                      f"({hw.pe_rows}, {hw.pe_cols})")
        return
    vals = grid.ravel()
    if vals.size and (int(vals.min()) < 0 or int(vals.max()) >= D):
        yield Finding("P002", ERROR, loc,
                      f"grid assigns slot ids outside [0, {D}) "
                      f"(range [{int(vals.min())}, {int(vals.max())}])")
        return
    counts = np.bincount(vals, minlength=D)
    empty = [s for s in range(D) if counts[s] == 0]
    if empty:
        yield Finding("P001", ERROR, loc,
                      f"slots {empty} own no PEs — the per-slot "
                      "partitions are not disjoint and complete")
    elif seg.branches:
        # branch segments derive pe_alloc from the placed grid, so
        # the counts must agree exactly (linear segments allocate
        # over `usable` before row quantization — no such identity)
        mismatch = [(s, int(counts[s]), seg.pe_alloc[s])
                    for s in range(D) if int(counts[s]) != seg.pe_alloc[s]]
        if mismatch:
            yield Finding("P001", ERROR, loc,
                          "branch-segment pe_alloc disagrees with the "
                          f"placed grid (slot, grid, alloc): {mismatch}")


# ---------------------------------------------------------------------------
# graph pass (G001 / G002)
# ---------------------------------------------------------------------------


def _dag_cycle(D: int, edges: Sequence[Tuple[int, int]]) -> bool:
    """Kahn's algorithm: True when the slot DAG has a cycle."""
    indeg = [0] * D
    adj: Dict[int, List[int]] = {}
    for u, v in edges:
        indeg[v] += 1
        adj.setdefault(u, []).append(v)
    ready = [u for u in range(D) if indeg[u] == 0]
    seen = 0
    while ready:
        u = ready.pop()
        seen += 1
        for v in adj.get(u, ()):
            indeg[v] -= 1
            if indeg[v] == 0:
                ready.append(v)
    return seen != D


@_register_pass("graph")
def _check_graph(ctx: _Ctx) -> Iterator[Finding]:
    segs = ctx.plan.segments
    if not segs:
        yield Finding("G002", ERROR, ctx.prefix or "plan",
                      "plan has no segments")
        return
    order = sorted(range(len(segs)), key=lambda i: segs[i].segment.start)
    if ctx.whole_graph:
        if segs[order[0]].segment.start != 0:
            yield Finding("G002", ERROR, ctx.loc(order[0]),
                          "first segment does not start at slot 0")
        for a, b in zip(order, order[1:]):
            if segs[a].segment.stop != segs[b].segment.start:
                yield Finding(
                    "G002", ERROR, ctx.loc(b),
                    f"segments do not tile the graph: [{segs[a].segment.start},"
                    f"{segs[a].segment.stop}) then [{segs[b].segment.start},"
                    f"{segs[b].segment.stop})")
    for i, seg in enumerate(segs):
        loc = ctx.loc(i)
        D = len(seg.ops)
        if seg.segment.depth != D:
            yield Finding("G002", ERROR, loc,
                          f"segment spans {seg.segment.depth} slots but "
                          f"carries {D} ops")
            continue
        if len(seg.dataflows) != D:
            yield Finding("G002", ERROR, loc,
                          f"{len(seg.dataflows)} dataflows for {D} slots")
        edges = seg.pipeline_edges
        if D == 1:
            if edges:
                yield Finding("G002", ERROR, loc,
                              "single-slot segment carries pipeline edges")
            continue
        oob = [(u, v) for u, v in edges
               if not (0 <= u < D and 0 <= v < D)]
        if oob:
            yield Finding("G002", ERROR, loc,
                          f"edges reference slots outside [0, {D}): {oob}")
            continue
        if _dag_cycle(D, edges):
            yield Finding("G001", ERROR, loc,
                          f"pipeline slot DAG has a cycle: {list(edges)}")
            continue
        back = [(u, v) for u, v in edges if u >= v]
        if back:
            # slots are numbered in topological order by construction;
            # a non-forward edge means the DAG and the slot numbering
            # disagree even if no cycle closed
            yield Finding("G002", ERROR, loc,
                          f"edges not topologically forward: {back}")
        if len(seg.granularities) != len(edges):
            yield Finding("G002", ERROR, loc,
                          f"{len(seg.granularities)} granularities for "
                          f"{len(edges)} pipeline edges")
        if not any(v == D - 1 for _, v in edges):
            yield Finding("G002", ERROR, loc,
                          "no pipeline edge into the final slot — the "
                          "segment can never drain")
        touched = {u for e in edges for u in e}
        dead = [s for s in range(D) if s not in touched]
        if dead:
            yield Finding("G002", ERROR, loc,
                          f"slots {dead} touch no pipeline edge")


# ---------------------------------------------------------------------------
# granularity pass (G003 / G004)
# ---------------------------------------------------------------------------


#: identity-keyed memo for the sorted-tiles tuple: fold-translated twins
#: share one tiles dict by reference, so the sort runs once per unique
#: dataflow shape (values hold the dict so ids cannot be recycled)
_TILES_KEY_CACHE: Dict[int, Tuple[dict, Tuple]] = {}
_TILES_KEY_MAX = 65536


def _tiles_key(tiles: dict) -> Tuple:
    hit = _TILES_KEY_CACHE.get(id(tiles))
    if hit is not None and hit[0] is tiles:
        return hit[1]
    key = tuple(sorted(tiles.items()))
    if len(_TILES_KEY_CACHE) >= _TILES_KEY_MAX:
        _TILES_KEY_CACHE.clear()
    _TILES_KEY_CACHE[id(tiles)] = (tiles, key)
    return key


def _df_key(df) -> Tuple:
    """Translation-invariant value key of a dataflow (name excluded)."""
    return (df.loop_order, _tiles_key(df.tiles), df.stationary)


def _seg_value_key(seg: SegmentPlan) -> Tuple:
    """Name-free value identity of a segment's derivation inputs, shared
    by fold-translated twins — the memo key for the granularity and
    conservation passes (clean verdicts only; failures recompute so the
    message carries the twin's own op names)."""
    from .planner import _op_static_sig
    return (tuple(_op_static_sig(op) for op in seg.ops),
            tuple(_df_key(df) for df in seg.dataflows),
            seg.pipeline_edges, tuple(seg.pe_alloc))


@_register_pass("granularity")
def _check_granularity(ctx: _Ctx) -> Iterator[Finding]:
    clean: set = set()
    for i, seg in enumerate(ctx.plan.segments):
        loc = ctx.loc(i)
        D = len(seg.ops)
        edges = seg.pipeline_edges
        if D < 2 or len(seg.granularities) != len(edges) \
                or len(seg.dataflows) != D:
            continue    # malformed shapes are the graph pass's findings
        key = (ctx.value_key(i, seg),
               tuple((gr.elements, tuple(gr.fused_ranks), gr.pipelinable,
                      gr.reason) for gr in seg.granularities),
               tuple((gr.producer == seg.ops[u].name
                      and gr.consumer == seg.ops[v].name)
                     for gr, (u, v) in zip(seg.granularities, edges)
                     if 0 <= u < D and 0 <= v < D),
               seg.placement is None or seg.placement.via_global_buffer)
        if key in clean:
            continue
        found = list(_granularity_findings(seg, loc))
        if not found:
            clean.add(key)
        yield from found


def _granularity_findings(seg: SegmentPlan, loc: str) -> Iterator[Finding]:
    D = len(seg.ops)
    edges = seg.pipeline_edges
    for k, (u, v) in enumerate(edges):
        if not (0 <= u < D and 0 <= v < D):
            continue
        got = seg.granularities[k]
        want = finest_granularity(seg.ops[u], seg.dataflows[u],
                                  seg.ops[v], seg.dataflows[v])
        diffs = []
        if got.elements != want.elements:
            diffs.append(f"elements {got.elements} != {want.elements}")
        if got.pipelinable != want.pipelinable:
            diffs.append(f"pipelinable {got.pipelinable} != "
                         f"{want.pipelinable}")
        if tuple(got.fused_ranks) != tuple(want.fused_ranks):
            diffs.append(f"fused_ranks {tuple(got.fused_ranks)} != "
                         f"{tuple(want.fused_ranks)}")
        if got.producer != seg.ops[u].name:
            diffs.append(f"producer {got.producer!r} != "
                         f"{seg.ops[u].name!r}")
        if got.consumer != seg.ops[v].name:
            diffs.append(f"consumer {got.consumer!r} != "
                         f"{seg.ops[v].name!r}")
        if diffs:
            yield Finding(
                "G003", ERROR, f"{loc} edge {k} ({u}->{v})",
                "granularity disagrees with re-derivation: "
                + "; ".join(diffs))
    if (seg.placement is not None
            and not seg.placement.via_global_buffer
            and any(not gr.pipelinable for gr in seg.granularities)):
        why = "; ".join(gr.reason for gr in seg.granularities
                        if not gr.pipelinable)
        yield Finding("G004", ERROR, loc,
                      "non-pipelinable granularity streamed PE-to-PE "
                      f"instead of staging through the GB ({why})")


# ---------------------------------------------------------------------------
# byte-conservation pass (G005)
# ---------------------------------------------------------------------------


@_register_pass("conservation")
def _check_conservation(ctx: _Ctx) -> Iterator[Finding]:
    hw = ctx.hw
    clean: set = set()
    for i, seg in enumerate(ctx.plan.segments):
        loc = ctx.loc(i)
        if not seg.ops or len(seg.pe_alloc) != len(seg.ops):
            continue
        # the conservation identity is name-free, so fold-translated
        # twins (same shapes, dataflows, costs) settle on the memo
        key = (ctx.value_key(i, seg), float(seg.skip_in_bytes),
               float(seg.cost.dram_bytes))
        if key in clean:
            continue
        bpw = hw.bytes_per_word
        try:
            w_traffic = weight_dram_traffic(seg.ops, seg.dataflows, hw,
                                            seg.pe_alloc)
        except (ValueError, KeyError, ZeroDivisionError) as e:
            yield Finding("G005", ERROR, loc,
                          f"weight traffic not derivable from the plan "
                          f"({e})")
            continue
        expected = (seg.ops[0].input_volume() * bpw
                    + seg.ops[-1].output_volume() * bpw
                    + seg.skip_in_bytes + w_traffic)
        got = seg.cost.dram_bytes
        if not math.isclose(got, expected, rel_tol=FLOAT_RTOL,
                            abs_tol=1e-6):
            yield Finding(
                "G005", ERROR, loc,
                f"dram_bytes {got:.6g} != external_in + external_out + "
                f"skip_in + weight_traffic = {expected:.6g} — bytes are "
                "not conserved across the segment boundary")
        else:
            clean.add(key)


# ---------------------------------------------------------------------------
# routing pass (R001 / R002 / R003)
# ---------------------------------------------------------------------------


def _segment_edge_batches(seg: SegmentPlan) -> List[FlowBatch]:
    """Reconstruct the exact per-edge flow sets the planner priced."""
    fine = seg.org in (SpatialOrg.FINE_STRIPED_1D,
                       SpatialOrg.CHECKERBOARD_2D)
    out_volumes = [op.output_volume() for op in seg.ops]
    return [edge_flow_batch(seg.placement, seg.pipeline_edges, k,
                            seg.pe_alloc, out_volumes, seg.intra_skips,
                            seg.traffic_scale, fine)
            for k in range(len(seg.pipeline_edges))]


def _worst_link(fb: FlowBatch, hw: HWConfig,
                topology: Topology) -> Optional[Tuple[float, object, bool]]:
    """(load, decoded link key, is_ingress_port) of the hottest link, or
    ``None`` when the incidence fallback applies (zero-word flows)."""
    if not len(fb):
        return None
    inc = route_incidence(fb, hw, topology)
    w = fb.words.astype(np.float64)
    if not inc.valid_for(w) or inc.path_len.shape[0] == 0:
        return None
    w_kept = w[inc.keep]
    loads = np.bincount(inc.inv, weights=w_kept[inc.fidx],
                        minlength=inc.n_links)
    li = int(np.argmax(loads))
    code = int(inc.uniq[li])
    ingress = code >= (inc.rows * inc.cols) ** 2
    return float(loads[li]), inc.link_keys()[li], ingress


def _routing_findings(seg: SegmentPlan, loc: str, hw: HWConfig,
                      topology: Topology,
                      dram_bw_fraction: float = 1.0) -> Iterator[Finding]:
    """Static congestion-freedom check for one pipelined segment.

    Reconstructs every pipeline edge's flow set, re-analyzes it on the
    shared route-incidence tables, and replays the Fig. 3 interval
    recursion (compute intervals only — no simulation) to decide whether
    the hottest link/ingress-port drains within its interval.  The
    derived verdict must agree with the plan's stored ``congested`` flag
    and the stored worst-edge ``TrafficStats``.
    """
    D = len(seg.ops)
    edges = seg.pipeline_edges
    try:
        batches = _segment_edge_batches(seg)
        stats = analyze_batch(batches, hw, topology)
    except (ValueError, IndexError, KeyError) as e:
        yield Finding("R003", ERROR, loc,
                      f"routes not reconstructible from the plan ({e})")
        return

    worst = max(stats, key=lambda st: st.worst_channel_load)
    stored = seg.noc
    if stored is None:
        yield Finding("R003", ERROR, loc,
                      "pipelined PE-to-PE segment carries no NoC stats")
    else:
        pairs = [("worst_channel_load", stored.worst_channel_load,
                  worst.worst_channel_load),
                 ("total_hop_words", stored.total_hop_words,
                  worst.total_hop_words),
                 ("max_path_hops", stored.max_path_hops,
                  worst.max_path_hops),
                 ("num_links_used", stored.num_links_used,
                  worst.num_links_used)]
        bad = [f"{k} {a!r} != {b!r}" for k, a, b in pairs
               if not math.isclose(float(a), float(b),
                                   rel_tol=FLOAT_RTOL, abs_tol=1e-9)]
        if bad:
            yield Finding(
                "R003", ERROR, loc,
                "stored NoC stats disagree with the reconstructed "
                "X-then-Y routes: " + "; ".join(bad))
            return   # intervals derived from disagreeing stats are noise

    # replay the interval recursion (pipeline_model._dag_segment_cost,
    # of which the linear chain is the special case) to recover each
    # edge's compute interval — the capacity bound of the burst model
    mem_stall = seg.cost.dram_bytes / (
        hw.dram_bw_bytes_per_cycle
        * min(1.0, max(dram_bw_fraction, 1e-6)))
    incoming: Dict[int, List[int]] = {}
    for k, (u, v) in enumerate(edges):
        incoming.setdefault(v, []).append(k)
    from .pipeline_model import edge_burst_count, op_work
    n_bursts: List[int] = []
    deltas: List[float] = []
    derived_congested = False
    culprit: Optional[Tuple[int, float, float]] = None
    for k, (u, v) in enumerate(edges):
        outv = max(1, seg.ops[u].output_volume())
        n_src = max(1, seg.pe_alloc[u])
        n_dst = max(1, seg.pe_alloc[v])
        n_k = edge_burst_count(outv, n_src)
        t_prod = op_work(seg.ops[u], hw) / outv / hw.dot_product_size
        inv = max(1, seg.ops[v].input_volume())
        t_cons = (n_src * op_work(seg.ops[v], hw) / inv
                  / (n_dst * hw.dot_product_size))
        producer_side = max(
            (deltas[d] * (n_bursts[d] / n_k) for d in incoming.get(u, ())),
            default=0.0)
        compute_interval = max(t_prod, t_cons, producer_side)
        st = stats[k]
        comm = st.interval_comm_delay(compute_interval)
        if st.congested(compute_interval):
            derived_congested = True
            if culprit is None:
                culprit = (k, st.worst_channel_load, compute_interval)
        delta = max(compute_interval, comm) + mem_stall / max(1, n_k)
        n_bursts.append(n_k)
        deltas.append(delta)

    if derived_congested and not seg.cost.congested:
        k, load, interval = culprit            # type: ignore[misc]
        link = _worst_link(batches[k], hw, topology)
        if link is not None and link[2]:
            yield Finding(
                "R002", ERROR, f"{loc} edge {k}",
                f"ingress port {link[1]} absorbs {link[0]:.3g} words per "
                f"interval of {interval:.3g} cycles — the 4-port "
                "arbitration cannot drain the burst, yet the plan claims "
                "congestion-free")
        else:
            where = f" (hottest link {link[1]})" if link is not None else ""
            yield Finding(
                "R001", ERROR, f"{loc} edge {k}",
                f"injected rate {load:.3g} words/interval exceeds the "
                f"link capacity of {interval:.3g} cycles/interval"
                f"{where}, yet the plan claims congestion-free")
    elif seg.cost.congested and not derived_congested:
        yield Finding(
            "R001", WARNING, loc,
            "plan claims congestion but every reconstructed link drains "
            "within its interval (conservative claim — safe, but the "
            "plan may have been priced on different routes)")


@_register_pass("routing")
def _check_routing(ctx: _Ctx) -> Iterator[Finding]:
    # memo lives for one pass run: id()-based key components are only
    # stable while the plan object keeps its sub-objects alive.
    # Translated copies of one representative span key equal, so a
    # 300-layer LM stack re-analyzes each unique span once, not 300 times.
    memo: Dict[Tuple, List[Tuple[str, str, str, str]]] = {}
    for i, seg in enumerate(ctx.plan.segments):
        D = len(seg.ops)
        if (D < 2 or seg.placement is None
                or seg.placement.via_global_buffer
                or len(seg.pe_alloc) != D
                or len(seg.granularities) != len(seg.pipeline_edges)):
            continue
        key = (ctx.value_key(i, seg), id(seg.placement), id(seg.noc),
               tuple(seg.intra_skips), float(seg.traffic_scale),
               float(seg.cost.dram_bytes), bool(seg.cost.congested))
        found = memo.get(key)
        if found is None:
            found = [(f.code, f.severity,
                      f.location[len("@SEG@"):] if
                      f.location.startswith("@SEG@") else "", f.message)
                     for f in _routing_findings(seg, "@SEG@", ctx.hw,
                                                ctx.topology)]
            memo[key] = found
        loc = ctx.loc(i)
        for code, sev, suffix, msg in found:
            yield Finding(code, sev, loc + suffix, msg)


# ---------------------------------------------------------------------------
# fold pass (A005)
# ---------------------------------------------------------------------------


def _span_is_image(seg: SegmentPlan, rseg: SegmentPlan, g: Graph,
                   delta: int) -> bool:
    """True only when ``seg`` is definitively the ``delta``-translated
    image of ``rseg`` — the cheap predicate mirroring what
    ``_translate_span`` rebinds (names) and shares (everything else).
    Any doubt (e.g. value-equal but not identical placement grids from a
    deserialized artifact) returns False; the caller then settles it
    with the materialized translation and ``plan_diffs``.
    """
    if seg.segment != rseg.segment.translate(delta):
        return False
    s0 = seg.segment.start
    if seg.ops != g.ops[s0:s0 + len(rseg.ops)]:
        return False
    if len(seg.dataflows) != len(rseg.dataflows) \
            or len(seg.granularities) != len(rseg.granularities):
        return False
    for df, rdf, op in zip(seg.dataflows, rseg.dataflows, seg.ops):
        if (df.op_name != op.name
                or (df.loop_order is not rdf.loop_order
                    and df.loop_order != rdf.loop_order)
                or (df.tiles is not rdf.tiles and df.tiles != rdf.tiles)
                or df.stationary != rdf.stationary):
            return False
    D = len(seg.ops)
    for gr, rgr, (u, v) in zip(seg.granularities, rseg.granularities,
                               rseg.pipeline_edges):
        if not (0 <= u < D and 0 <= v < D):
            return False
        if (gr.elements != rgr.elements
                or tuple(gr.fused_ranks) != tuple(rgr.fused_ranks)
                or gr.pipelinable != rgr.pipelinable
                or gr.reason != rgr.reason
                or gr.producer != seg.ops[u].name
                or gr.consumer != seg.ops[v].name):
            return False
    # every remaining field is carried over by reference/value verbatim;
    # identity shortcuts settle the heavyweight shared sub-objects
    for f in ("org", "placement", "noc", "cost", "pe_alloc",
              "intra_skips", "skip_in_bytes", "traffic_scale",
              "array_pes", "edges", "branches"):
        a, b = getattr(seg, f), getattr(rseg, f)
        if a is b:
            continue
        try:
            if bool(a != b):
                return False
        except ValueError:
            return False    # ndarray ambiguity -> let plan_diffs decide
    return True


@_register_pass("fold")
def _check_fold(ctx: _Ctx) -> Iterator[Finding]:
    plan, g = ctx.plan, ctx.graph
    if g is None or not plan.strategy.startswith("pipeorgan"):
        return   # folding is a pipeorgan mechanism; baselines never fold
    from .artifact import plan_diffs
    from .planner import _fold_signature, _translate_span
    groups: Dict[Tuple, Tuple[int, SegmentPlan]] = {}
    for i, seg in enumerate(plan.segments):
        try:
            key = (_fold_signature(g, seg.segment), seg.segment.branches)
        except (KeyError, IndexError):
            continue     # malformed span: the graph pass owns that finding
        rep = groups.get(key)
        if rep is None:
            groups[key] = (i, seg)
            continue
        ri, rseg = rep
        delta = seg.segment.start - rseg.segment.start
        # structurally identical spans must carry the identical plan,
        # translated — the fold soundness contract (docs/planner.md).
        # The predicate settles the clean case without materializing the
        # translation; the recursive diff runs only to localize (or
        # dismiss, for value-equal deserialized grids) a violation.
        if _span_is_image(seg, rseg, g, delta):
            continue
        expected = _translate_span(rseg, g, delta)
        diffs = plan_diffs(seg, expected, path="segment")
        if diffs:
            shown = "; ".join(diffs[:4])
            more = f" (+{len(diffs) - 4} more)" if len(diffs) > 4 else ""
            yield Finding(
                "A005", ERROR, ctx.loc(i),
                f"span is fold-equal to segment[{ri}] "
                f"[{rseg.segment.start},{rseg.segment.stop}) but is not "
                f"its translated image: {shown}{more}")


# ---------------------------------------------------------------------------
# artifact passes (A001-A004): schema + identity
# ---------------------------------------------------------------------------


def _schema_findings(doc: dict, kind: str, version: int,
                     loc: str = "artifact") -> List[Finding]:
    out: List[Finding] = []
    got_kind = doc.get("kind")
    if got_kind != kind:
        out.append(Finding("A001", ERROR, loc,
                           f"artifact kind {got_kind!r} != expected "
                           f"{kind!r}"))
    got_ver = doc.get("schema_version")
    if got_ver != version:
        out.append(Finding("A002", ERROR, loc,
                           f"schema version {got_ver!r} != supported "
                           f"v{version} — re-plan and re-save"))
    return out


def _identity_findings(artifact, graph: Optional[Graph],
                       loc: str = "artifact") -> Iterator[Finding]:
    plan = artifact.plan
    request = artifact.request
    token = artifact.token
    if request is None:
        if token is not None:
            yield Finding("A003", ERROR, loc,
                          "artifact carries a token but no request to "
                          "hash it against")
        return
    if token != content_token(request):
        yield Finding("A003", ERROR, loc,
                      f"token {str(token)[:16]}... is not the content "
                      "hash of the stored request — the artifact was "
                      "copied, renamed or edited")
    mism = []
    if request.get("graph_name") != plan.graph_name:
        mism.append(f"graph_name {request.get('graph_name')!r} != "
                    f"{plan.graph_name!r}")
    if request.get("strategy") != plan.strategy:
        mism.append(f"strategy {request.get('strategy')!r} != "
                    f"{plan.strategy!r}")
    if request.get("topology") != plan.topology.value:
        mism.append(f"topology {request.get('topology')!r} != "
                    f"{plan.topology.value!r}")
    if graph is not None and request.get("fingerprint") is not None:
        want = _jsonable(graph_fingerprint(graph))
        if _jsonable(request["fingerprint"]) != want:
            mism.append("graph fingerprint does not match the plan's ops")
    if mism:
        yield Finding("A004", ERROR, loc,
                      "request identity disagrees with the plan it "
                      "wraps: " + "; ".join(mism))


# ---------------------------------------------------------------------------
# tenancy pass (P003 / P004)
# ---------------------------------------------------------------------------


def _tenant_flow_batches(tenant) -> List[FlowBatch]:
    from .multi_tenant import segment_flow_batches
    col0 = tenant.band[0] if tenant.band else 0
    out: List[FlowBatch] = []
    for seg in tenant.plan.segments:
        for fb in segment_flow_batches(seg):
            out.append(offset_flow_batch(fb, 0, col0))
    return out


def _tenancy_findings(mt, hw: HWConfig,
                      topology: Topology) -> Iterator[Finding]:
    tenants = mt.tenants
    if mt.mode != "spatial":
        return    # time-sliced/serialized tenants own the whole array
    spans: List[Tuple[int, int]] = []
    for t in tenants:
        loc = f"tenant[{t.name}]"
        if t.band is None:
            yield Finding("P003", ERROR, loc,
                          "spatial-mode tenant carries no column band")
            continue
        c0, c1 = t.band
        if not (0 <= c0 < c1 <= hw.pe_cols):
            yield Finding("P003", ERROR, loc,
                          f"band [{c0},{c1}) outside the substrate's "
                          f"[0,{hw.pe_cols}) columns")
            continue
        for (o0, o1) in spans:
            if c0 < o1 and o0 < c1:
                yield Finding("P003", ERROR, loc,
                              f"band [{c0},{c1}) overlaps a co-resident "
                              f"band [{o0},{o1})")
        spans.append((c0, c1))
    # link-disjointness: under dimension-ordered X-then-Y routing,
    # column bands share no wire — the congestion-free-co-residency
    # premise the spatial mode prices with (zero interference deltas)
    batches = [_tenant_flow_batches(t) for t in tenants]
    for i, t in enumerate(tenants):
        own = batches[i]
        others = [fb for j, b in enumerate(batches) if j != i for fb in b]
        if not own:
            continue
        own_union = FlowBatch.concat(own)
        solo, shared = interference_channel_load(own_union, others, hw,
                                                 topology)
        if shared > solo + 1e-9:
            yield Finding(
                "P004", ERROR, f"tenant[{t.name}]",
                f"routes share links with co-resident tenants (solo "
                f"load {solo:.3g}, shared {shared:.3g}) — spatial bands "
                "must be link-disjoint under X-then-Y routing")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _selected(passes: Optional[Sequence[str]],
              skip: Sequence[str]) -> List[str]:
    known = set(pass_names())
    for name in list(passes or ()) + list(skip):
        if name not in known:
            raise ValueError(f"unknown verifier pass {name!r}; one of "
                             f"{sorted(known)}")
    names = [n for n in pass_names() if passes is None or n in passes]
    return [n for n in names if n not in skip]


def _run_plan_passes(ctx: _Ctx, names: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for name in names:
        fn = _PASSES.get(name)
        if fn is not None:
            findings.extend(fn(ctx))
    return findings


def verify_segment(seg: SegmentPlan, hw: Optional[HWConfig] = None,
                   topology: Optional[Topology] = None) -> VerifyReport:
    """Verify a single ``SegmentPlan`` (e.g. a span-shelf payload).

    With ``hw`` the full segment-scope pass set runs (placement geometry,
    routing capacity, byte conservation); without it only the
    hardware-independent invariants are checked (slot DAG, granularity
    re-derivation) — the shelf read-through mode, which must work before
    any request context exists.
    """
    plan = PlanResult(f"span[{seg.segment.start},{seg.segment.stop})",
                      "span", topology if topology is not None
                      else (seg.noc.topology if seg.noc is not None
                            else Topology.AMP), [seg])
    names = ["graph", "granularity"]
    if hw is not None:
        names = ["placement", "routing", "graph", "granularity",
                 "conservation"]
    ctx = _Ctx(plan=plan, hw=hw if hw is not None else PAPER_HW,
               topology=plan.topology, graph=None, whole_graph=False)
    findings = _run_plan_passes(ctx, names)
    return VerifyReport(plan.graph_name, tuple(names), findings)


def _hw_from_request(request: Optional[dict]) -> Optional[HWConfig]:
    if not request or not isinstance(request.get("hw"), dict):
        return None
    try:
        return HWConfig(**request["hw"])
    except TypeError:
        return None


def verify_plan(target: Union[PlanResult, SegmentPlan, dict, object],
                hw: Optional[HWConfig] = None,
                topology: Optional[Topology] = None,
                passes: Optional[Sequence[str]] = None,
                skip: Sequence[str] = ()) -> VerifyReport:
    """Statically verify a plan, artifact or multi-tenant plan.

    Runs every registered pass (or the ``passes`` subset, minus
    ``skip``) and returns a ``VerifyReport``; it NEVER invokes the
    simulator.  ``hw``/``topology`` default to what the target itself
    records (an artifact's request, a plan's topology) and finally to
    ``PAPER_HW``.  Raw ``dict`` targets are treated as undecoded
    artifact documents: schema findings are reported rather than raised,
    and a decodable document is verified in full.
    """
    names = _selected(passes, skip)

    # ---- raw artifact documents -------------------------------------------
    if isinstance(target, dict):
        return _verify_doc(target, hw, topology, names)

    # ---- single spans ------------------------------------------------------
    if isinstance(target, SegmentPlan):
        return verify_segment(target, hw, topology)

    # ---- multi-tenant ------------------------------------------------------
    from .multi_tenant import MultiTenantArtifact, MultiTenantPlan
    if isinstance(target, MultiTenantArtifact):
        return _verify_mt_artifact(target, hw, topology, names)
    if isinstance(target, MultiTenantPlan):
        return _verify_mt_plan(target, "mtplan",
                               hw if hw is not None else PAPER_HW,
                               topology if topology is not None
                               else Topology.AMP, names, [])

    # ---- single-graph artifacts -------------------------------------------
    from .artifact import PlanArtifact
    if isinstance(target, PlanArtifact):
        art_hw = hw if hw is not None else _hw_from_request(target.request)
        plan = target.plan
        findings: List[Finding] = []
        if "schema" in names and \
                target.schema_version != _plan_schema_version():
            findings.append(Finding(
                "A002", ERROR, "artifact",
                f"schema version {target.schema_version!r} != supported "
                f"v{_plan_schema_version()}"))
        graph = _rebuild_graph(plan)
        if "identity" in names:
            findings.extend(_identity_findings(target, graph))
        ctx = _Ctx(plan=plan,
                   hw=art_hw if art_hw is not None else PAPER_HW,
                   topology=topology if topology is not None
                   else plan.topology, graph=graph, artifact=target)
        findings.extend(_run_plan_passes(ctx, names))
        return VerifyReport(f"artifact:{plan.graph_name}", tuple(names),
                            findings)

    # ---- plain plans -------------------------------------------------------
    if isinstance(target, PlanResult):
        ctx = _Ctx(plan=target, hw=hw if hw is not None else PAPER_HW,
                   topology=topology if topology is not None
                   else target.topology, graph=_rebuild_graph(target))
        findings = _run_plan_passes(ctx, names)
        return VerifyReport(target.graph_name, tuple(names), findings)

    raise TypeError(f"cannot verify {type(target).__name__}; expected "
                    "PlanResult, PlanArtifact, SegmentPlan, "
                    "MultiTenantPlan, MultiTenantArtifact or dict")


def _plan_schema_version() -> int:
    from .artifact import PLAN_SCHEMA_VERSION
    return PLAN_SCHEMA_VERSION


def _verify_doc(doc: dict, hw: Optional[HWConfig],
                topology: Optional[Topology],
                names: Sequence[str]) -> VerifyReport:
    """Verify an undecoded artifact document (any of the three kinds)."""
    from . import artifact as _art
    from . import multi_tenant as _mt
    kind = doc.get("kind")
    if kind == _mt.MT_ARTIFACT_KIND:
        expected_ver: int = _mt.MT_SCHEMA_VERSION
    elif kind == _art.SPAN_KIND:
        expected_ver = _art.SPAN_SCHEMA_VERSION
    else:
        expected_ver = _art.PLAN_SCHEMA_VERSION
    findings = []
    if "schema" in names:
        # an unrecognized kind is judged against the plan-artifact kind
        # (the only one a bare document could plausibly claim to be)
        want_kind = kind if kind in (_art.ARTIFACT_KIND, _art.SPAN_KIND,
                                     _mt.MT_ARTIFACT_KIND) \
            else _art.ARTIFACT_KIND
        findings = _schema_findings(doc, want_kind, expected_ver)
    if any(f.code == "A001" for f in findings):
        return VerifyReport("document", ("schema",), findings)
    try:
        if kind == _mt.MT_ARTIFACT_KIND:
            decoded: object = _mt.MultiTenantArtifact(
                plan=_mt.mtplan_from_dict(doc["plan"]),
                request=doc.get("request"), token=doc.get("token"),
                schema_version=doc.get("schema_version", -1))
        elif kind == _art.SPAN_KIND:
            seg = _art._segment_plan_from_dict(doc["plan"])
            rep = verify_segment(seg, hw, topology)
            return VerifyReport(rep.target, ("schema",) + rep.passes_run,
                                findings + rep.findings)
        else:
            decoded = _art.PlanArtifact(
                plan=_art.plan_from_dict(doc["plan"]),
                request=doc.get("request"), token=doc.get("token"),
                schema_version=doc.get("schema_version", -1))
    except (KeyError, ValueError, TypeError) as e:
        findings.append(Finding("A002", ERROR, "document",
                                f"artifact body is not decodable ({e})"))
        return VerifyReport("document", ("schema",), findings)
    rep = verify_plan(decoded, hw, topology,
                      passes=[n for n in names if n != "schema"])
    # the dict-level schema check already ran against the declared kind;
    # keep its findings and the decoded verification's together
    return VerifyReport(rep.target, tuple(dict.fromkeys(
        ("schema",) + rep.passes_run)), findings + rep.findings)


def _verify_mt_plan(mt, label: str, hw: HWConfig, topology: Topology,
                    names: Sequence[str],
                    pre: List[Finding]) -> VerifyReport:
    from .multi_tenant import band_hw
    findings = list(pre)
    if "tenancy" in names:
        findings.extend(_tenancy_findings(mt, hw, topology))
    plan_passes = [n for n in names
                   if n not in ("schema", "identity", "tenancy")]
    for t in mt.tenants:
        t_hw = hw
        if t.band is not None:
            try:
                t_hw = band_hw(hw, t.band[1] - t.band[0])
            except ValueError:
                continue    # band geometry findings already emitted
        ctx = _Ctx(plan=t.plan, hw=t_hw, topology=topology,
                   graph=_rebuild_graph(t.plan),
                   prefix=f"tenant[{t.name}].")
        findings.extend(_run_plan_passes(ctx, plan_passes))
    return VerifyReport(label, tuple(names), findings)


def _verify_mt_artifact(art, hw: Optional[HWConfig],
                        topology: Optional[Topology],
                        names: Sequence[str]) -> VerifyReport:
    from .multi_tenant import MT_SCHEMA_VERSION
    pre: List[Finding] = []
    if "schema" in names and art.schema_version != MT_SCHEMA_VERSION:
        pre.append(Finding("A002", ERROR, "artifact",
                           f"schema version {art.schema_version!r} != "
                           f"supported v{MT_SCHEMA_VERSION}"))
    if "identity" in names and art.request is not None \
            and art.token is not None \
            and art.token != content_token(art.request):
        pre.append(Finding("A003", ERROR, "artifact",
                           "token is not the content hash of the stored "
                           "multi-tenant request"))
    art_hw = hw if hw is not None else _hw_from_request(art.request)
    return _verify_mt_plan(art.plan, "mtplan",
                           art_hw if art_hw is not None else PAPER_HW,
                           topology if topology is not None
                           else Topology.AMP, names, pre)
