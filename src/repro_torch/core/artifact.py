"""Serializable plan artifacts: lossless JSON persistence for plans.

``PlanResult`` is a deep tree of dataclasses (segments, ops, dataflows,
granularities, placements with numpy grids, NoC stats, costs, branch
groups and the pipeline slot DAG).  ``PlanArtifact`` round-trips the
whole tree through versioned JSON — *field-identical*, so a plan written
by an offline planning job and loaded by a serving process is
indistinguishable from the freshly planned object: the simulator replays
it, ``validate_plan`` bands it, and the serve loop prices tokens with it
without ever touching the planner.

``PlanStore`` is the directory-of-artifacts layer: plans are filed under
the ``PlanRequest.cache_token()`` (a content hash of the request
identity), so a store lookup is exact-by-construction — same graph
fingerprint, hardware, topology, strategy, objective, constraints and
burst budget, or a miss.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from .dataflow import Dataflow
from .depth import Segment
from .granularity import Granularity
from .graph import Op, OpKind
from .noc import Topology, TrafficStats
from .pipeline_model import SegmentCost
from .plan_api import PlanRequest
from .planner import PlanResult, SegmentPlan
from .spatial import Placement, SpatialOrg

#: bump on any change to the serialized layout; loaders reject mismatches
#: outright (a silently mis-decoded plan would serve wrong estimates).
PLAN_SCHEMA_VERSION = 1

ARTIFACT_KIND = "pipeorgan-plan"


class PlanSchemaError(ValueError):
    """Artifact schema version (or kind) does not match this build."""


PathLike = Union[str, os.PathLike]

#: read-through verification modes shared by ``PlanStore`` and
#: ``SpanShelf`` (mirrors ``core.verify.VERIFY_MODES``).
VERIFY_MODES = ("off", "warn", "strict")


def _check_verify_mode(mode: str) -> str:
    if mode not in VERIFY_MODES:
        raise ValueError(f"verify={mode!r}; expected one of {VERIFY_MODES}")
    return mode


def _apply_verify(report: Any, mode: str) -> None:
    """Enforce a ``VerifyReport`` under ``warn``/``strict`` semantics."""
    if report.ok:
        return
    if mode == "strict":
        report.raise_if_errors()
    from .verify import PlanVerifyWarning
    warnings.warn(f"artifact verification found problems:\n"
                  f"{report.summary()}", PlanVerifyWarning, stacklevel=4)


# ---------------------------------------------------------------------------
# dataclass <-> dict codecs
# ---------------------------------------------------------------------------


def _py(x: Any) -> Any:
    """Coerce numpy scalars leaking out of the analysis layer to plain
    Python so ``json`` round-trips them exactly."""
    if isinstance(x, np.bool_):
        return bool(x)
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    return x


def _op_to_dict(op: Op) -> Dict[str, Any]:
    return {"name": op.name, "kind": op.kind.value,
            "dims": {k: _py(v) for k, v in op.dims.items()},
            "inputs": list(op.inputs), "stride": _py(op.stride)}


def _op_from_dict(d: Dict[str, Any]) -> Op:
    return Op(d["name"], OpKind(d["kind"]), dict(d["dims"]),
              tuple(d["inputs"]), d["stride"])


def _dataflow_to_dict(df: Dataflow) -> Dict[str, Any]:
    return {"op_name": df.op_name, "loop_order": list(df.loop_order),
            "tiles": {k: _py(v) for k, v in df.tiles.items()},
            "stationary": df.stationary}


def _dataflow_from_dict(d: Dict[str, Any]) -> Dataflow:
    return Dataflow(d["op_name"], tuple(d["loop_order"]), dict(d["tiles"]),
                    d["stationary"])


def _gran_to_dict(gr: Granularity) -> Dict[str, Any]:
    return {"producer": gr.producer, "consumer": gr.consumer,
            "elements": _py(gr.elements),
            "fused_ranks": list(gr.fused_ranks),
            "pipelinable": gr.pipelinable, "reason": gr.reason}


def _gran_from_dict(d: Dict[str, Any]) -> Granularity:
    return Granularity(d["producer"], d["consumer"], d["elements"],
                       tuple(d["fused_ranks"]), d["pipelinable"],
                       d["reason"])


def _placement_to_dict(pl: Optional[Placement]) -> Optional[Dict[str, Any]]:
    if pl is None:
        return None
    return {"org": pl.org.value, "grid": pl.grid.tolist(),
            "via_global_buffer": bool(pl.via_global_buffer)}


def _placement_from_dict(d: Optional[Dict[str, Any]]) -> Optional[Placement]:
    if d is None:
        return None
    return Placement(SpatialOrg(d["org"]),
                     np.asarray(d["grid"], dtype=np.int32),
                     d["via_global_buffer"])


def _noc_to_dict(st: Optional[TrafficStats]) -> Optional[Dict[str, Any]]:
    if st is None:
        return None
    return {"topology": st.topology.value,
            "worst_channel_load": _py(st.worst_channel_load),
            "total_hop_words": _py(st.total_hop_words),
            "total_wire_words": _py(st.total_wire_words),
            "max_path_hops": _py(st.max_path_hops),
            "num_links_used": _py(st.num_links_used),
            "link_count": _py(st.link_count)}


def _noc_from_dict(d: Optional[Dict[str, Any]]) -> Optional[TrafficStats]:
    if d is None:
        return None
    return TrafficStats(Topology(d["topology"]), d["worst_channel_load"],
                        d["total_hop_words"], d["total_wire_words"],
                        d["max_path_hops"], d["num_links_used"],
                        d["link_count"])


def _cost_to_dict(c: SegmentCost) -> Dict[str, Any]:
    return {"latency_cycles": _py(c.latency_cycles),
            "compute_cycles": _py(c.compute_cycles),
            "dram_bytes": _py(c.dram_bytes),
            "sram_bytes": _py(c.sram_bytes),
            "noc_hop_energy": _py(c.noc_hop_energy),
            "dram_energy": _py(c.dram_energy),
            "sram_energy": _py(c.sram_energy),
            "interval_delays": [_py(x) for x in c.interval_delays],
            "intervals": [_py(x) for x in c.intervals],
            "congested": bool(c.congested)}


def _cost_from_dict(d: Dict[str, Any]) -> SegmentCost:
    return SegmentCost(d["latency_cycles"], d["compute_cycles"],
                       d["dram_bytes"], d["sram_bytes"],
                       d["noc_hop_energy"], d["dram_energy"],
                       d["sram_energy"], list(d["interval_delays"]),
                       list(d["intervals"]), d["congested"])


def _segment_plan_to_dict(s: SegmentPlan) -> Dict[str, Any]:
    return {
        "segment": {"start": s.segment.start, "stop": s.segment.stop,
                    "branches": [list(b) for b in s.segment.branches]},
        "ops": [_op_to_dict(op) for op in s.ops],
        "dataflows": [_dataflow_to_dict(df) for df in s.dataflows],
        "granularities": [_gran_to_dict(gr) for gr in s.granularities],
        "pe_alloc": [_py(p) for p in s.pe_alloc],
        "org": s.org.value if s.org is not None else None,
        "placement": _placement_to_dict(s.placement),
        "noc": _noc_to_dict(s.noc),
        "cost": _cost_to_dict(s.cost),
        "intra_skips": [[_py(a), _py(b), _py(v)]
                        for a, b, v in s.intra_skips],
        "skip_in_bytes": _py(s.skip_in_bytes),
        "traffic_scale": _py(s.traffic_scale),
        "array_pes": _py(s.array_pes),
        "edges": [list(e) for e in s.edges],
        "branches": [list(b) for b in s.branches],
    }


def _segment_plan_from_dict(d: Dict[str, Any]) -> SegmentPlan:
    seg = d["segment"]
    return SegmentPlan(
        segment=Segment(seg["start"], seg["stop"],
                        tuple(tuple(b) for b in seg["branches"])),
        ops=[_op_from_dict(o) for o in d["ops"]],
        dataflows=[_dataflow_from_dict(x) for x in d["dataflows"]],
        granularities=[_gran_from_dict(x) for x in d["granularities"]],
        pe_alloc=list(d["pe_alloc"]),
        org=SpatialOrg(d["org"]) if d["org"] is not None else None,
        placement=_placement_from_dict(d["placement"]),
        noc=_noc_from_dict(d["noc"]),
        cost=_cost_from_dict(d["cost"]),
        intra_skips=tuple((a, b, v) for a, b, v in d["intra_skips"]),
        skip_in_bytes=d["skip_in_bytes"],
        traffic_scale=d["traffic_scale"],
        array_pes=d["array_pes"],
        edges=tuple(tuple(e) for e in d["edges"]),
        branches=tuple(tuple(b) for b in d["branches"]),
    )


def plan_to_dict(plan: PlanResult) -> Dict[str, Any]:
    return {"graph_name": plan.graph_name, "strategy": plan.strategy,
            "topology": plan.topology.value,
            "segments": [_segment_plan_to_dict(s) for s in plan.segments]}


def plan_from_dict(d: Dict[str, Any]) -> PlanResult:
    return PlanResult(d["graph_name"], d["strategy"],
                      Topology(d["topology"]),
                      [_segment_plan_from_dict(s) for s in d["segments"]])


# ---------------------------------------------------------------------------
# field-identical comparison (ndarray-aware; used by the round-trip tests)
# ---------------------------------------------------------------------------


def plan_diffs(a: Any, b: Any, path: str = "plan") -> List[str]:
    """Recursive field-by-field diff of two plan trees; ``[]`` means the
    trees are identical (exact float equality — artifacts are lossless,
    so there is no tolerance to grant)."""
    if a is b:
        # fold-translated spans share placement/NoC/cost sub-objects by
        # reference; identity settles them without walking the grids
        return []
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        if type(a) is not type(b):
            return [f"{path}: type {type(a).__name__} != "
                    f"{type(b).__name__}"]
        out: List[str] = []
        for f in dataclasses.fields(a):
            out.extend(plan_diffs(getattr(a, f.name), getattr(b, f.name),
                                  f"{path}.{f.name}"))
        return out
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if not (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b)):
            return [f"{path}: ndarray mismatch"]
        return []
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            return [f"{path}: length {len(a)} != {len(b)}"]
        out = []
        for i, (x, y) in enumerate(zip(a, b)):
            out.extend(plan_diffs(x, y, f"{path}[{i}]"))
        return out
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{path}: keys {sorted(a)} != {sorted(b)}"]
        out = []
        for k in a:
            out.extend(plan_diffs(a[k], b[k], f"{path}[{k!r}]"))
        return out
    if _py(a) != _py(b):
        return [f"{path}: {a!r} != {b!r}"]
    return []


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanArtifact:
    """One plan plus the identity of the request that produced it."""
    plan: PlanResult
    request: Optional[Dict[str, Any]] = None   # PlanRequest.to_json_dict()
    token: Optional[str] = None         # PlanRequest.cache_token()
    schema_version: int = PLAN_SCHEMA_VERSION

    @staticmethod
    def from_plan(plan: PlanResult,
                  request: Optional[PlanRequest] = None) -> "PlanArtifact":
        return PlanArtifact(
            plan=plan,
            request=request.to_json_dict() if request is not None else None,
            token=request.cache_token() if request is not None else None)

    def to_json(self) -> str:
        doc = {"kind": ARTIFACT_KIND,
               "schema_version": self.schema_version,
               "token": self.token,
               "request": self.request,
               "plan": plan_to_dict(self.plan)}
        return json.dumps(doc, indent=1, sort_keys=True) + "\n"

    @staticmethod
    def from_json(text: str) -> "PlanArtifact":
        doc = json.loads(text)
        if doc.get("kind") != ARTIFACT_KIND:
            raise PlanSchemaError(
                f"not a plan artifact (kind={doc.get('kind')!r})")
        version = doc.get("schema_version")
        if version != PLAN_SCHEMA_VERSION:
            raise PlanSchemaError(
                f"plan artifact schema v{version} != supported "
                f"v{PLAN_SCHEMA_VERSION}; re-plan and re-save")
        return PlanArtifact(plan=plan_from_dict(doc["plan"]),
                            request=doc.get("request"),
                            token=doc.get("token"),
                            schema_version=version)

    def save(self, path: PathLike) -> Path:
        path = Path(path)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(self.to_json())
        os.replace(tmp, path)           # atomic: a reader never sees half
        return path

    @staticmethod
    def load(path: PathLike) -> "PlanArtifact":
        return PlanArtifact.from_json(Path(path).read_text())


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


class PlanStore:
    """A directory of plan artifacts keyed by request cache token.

    The offline-plan -> online-serve path: a planning job ``save``s the
    artifacts, the serving process ``load``s them — an exact-identity hit
    or ``None`` — so warm startups make *zero* planner invocations.

    ``verify`` turns on read-through static verification
    (``core.verify.verify_plan``): every loaded artifact is checked
    against the plan invariants — ``"warn"`` emits a
    ``PlanVerifyWarning`` on error findings, ``"strict"`` raises
    ``PlanVerifyError``.  Writes are never verified here; gate those at
    the planner (``Planner(verify=...)``).
    """

    SUFFIX = ".plan.json"

    def __init__(self, root: PathLike, verify: str = "off") -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.verify = _check_verify_mode(verify)
        self.hits = 0
        self.misses = 0
        self.saves = 0

    def path_for(self, request: PlanRequest) -> Path:
        safe = "".join(ch if ch.isalnum() or ch in "-_." else "_"
                       for ch in request.graph.name)
        return self.root / (f"{safe}-{request.strategy}-"
                            f"{request.cache_token()[:16]}{self.SUFFIX}")

    def save(self, request: PlanRequest, plan: PlanResult) -> Path:
        self.saves += 1
        return PlanArtifact.from_plan(plan, request).save(
            self.path_for(request))

    def load_artifact(self, request: PlanRequest) -> Optional[PlanArtifact]:
        path = self.path_for(request)
        if not path.exists():
            self.misses += 1
            return None
        art = PlanArtifact.load(path)     # schema mismatch raises
        # the filename only carries a hash prefix; the *full* token must
        # match or a copied/renamed artifact would silently serve a plan
        # it was not planned for
        if art.token != request.cache_token():
            self.misses += 1
            return None
        if self.verify != "off":
            from .verify import verify_plan
            _apply_verify(verify_plan(art), self.verify)
        self.hits += 1
        return art

    def load(self, request: PlanRequest) -> Optional[PlanResult]:
        art = self.load_artifact(request)
        return art.plan if art is not None else None

    def scan(self) -> Dict[str, PlanArtifact]:
        """Every artifact in the store, keyed by its request token.

        Only completed ``*.plan.json`` files are read; in-flight or
        orphaned ``*.tmp`` files (a writer that died mid-``save``) are
        skipped — see :meth:`orphaned_tmp` / :meth:`clean_tmp`.
        """
        out: Dict[str, PlanArtifact] = {}
        for path in sorted(self.root.glob(f"*{self.SUFFIX}")):
            if path.suffix == ".tmp":       # belt and braces: never decode
                continue                    # a half-written artifact
            art = PlanArtifact.load(path)
            out[art.token or path.stem] = art
        return out

    def orphaned_tmp(self) -> List[Path]:
        """Leftover ``*.tmp`` files from writers that died before the
        atomic ``os.replace``; safe to delete at any time."""
        return sorted(self.root.glob("*.tmp"))

    def clean_tmp(self) -> List[Path]:
        """Delete and return the orphaned ``*.tmp`` files."""
        removed: List[Path] = []
        for path in self.orphaned_tmp():
            try:
                path.unlink()
            except OSError:
                continue                    # another cleaner raced us
            removed.append(path)
        return removed

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob(f"*{self.SUFFIX}"))

    def info(self) -> Tuple[int, int, int, int]:
        """(hits, misses, maxsize, currsize); maxsize 0 = unbounded."""
        return (self.hits, self.misses, 0, len(self))


# ---------------------------------------------------------------------------
# the span shelf
# ---------------------------------------------------------------------------

#: bump on any change to the shelved span layout (it reuses the
#: ``SegmentPlan`` codec, so a ``PLAN_SCHEMA_VERSION`` bump implies one
#: here too); mismatches read as misses, never as errors — a stale shelf
#: must only cost a re-solve.
SPAN_SCHEMA_VERSION = 1

SPAN_KIND = "pipeorgan-span"


class SpanShelf:
    """A directory of solved DP spans, content-addressed by span token.

    The persistent tier behind the planner's in-memory span cache
    (``planner.set_span_shelf``): one small JSON file per solved span,
    keyed by the sha256 token of (span signature, hardware, topology,
    engine, DP family).  Same content -> same token -> idempotent
    overwrites, so any number of serve engines may share one shelf
    directory — writes are atomic (unique tmp + ``os.replace``) and a
    reader never sees a half-written file.  Stale or foreign files
    (wrong kind, schema, or token) read as misses, never as errors.

    ``verify`` turns on read-through static verification
    (``core.verify.verify_segment`` — the hardware-independent graph and
    granularity passes): ``"warn"`` emits a ``PlanVerifyWarning`` on
    error findings, ``"strict"`` raises ``PlanVerifyError``.
    """

    SUFFIX = ".span.json"

    def __init__(self, root: PathLike, verify: str = "off") -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.verify = _check_verify_mode(verify)
        self.hits = 0
        self.misses = 0
        self.saves = 0

    def path_for(self, token: str) -> Path:
        return self.root / f"{token}{self.SUFFIX}"

    def save(self, token: str, plan: SegmentPlan) -> Path:
        self.saves += 1
        path = self.path_for(token)
        doc = {"kind": SPAN_KIND, "schema_version": SPAN_SCHEMA_VERSION,
               "token": token, "plan": _segment_plan_to_dict(plan)}
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(doc, sort_keys=True) + "\n")
        os.replace(tmp, path)
        return path

    def load(self, token: str) -> Optional[SegmentPlan]:
        path = self.path_for(token)
        try:
            doc = json.loads(path.read_text())
        except (OSError, ValueError):
            self.misses += 1
            return None
        if (doc.get("kind") != SPAN_KIND
                or doc.get("schema_version") != SPAN_SCHEMA_VERSION
                or doc.get("token") != token):
            self.misses += 1
            return None
        plan = _segment_plan_from_dict(doc["plan"])
        if self.verify != "off":
            from .verify import verify_segment
            _apply_verify(verify_segment(plan), self.verify)
        self.hits += 1
        return plan

    def orphaned_tmp(self) -> List[Path]:
        """Leftover ``*.tmp`` files from writers that died before the
        atomic ``os.replace``; safe to delete at any time."""
        return sorted(self.root.glob("*.tmp"))

    def clean_tmp(self) -> List[Path]:
        """Delete and return the orphaned ``*.tmp`` files."""
        removed: List[Path] = []
        for path in self.orphaned_tmp():
            try:
                path.unlink()
            except OSError:
                continue                    # another cleaner raced us
            removed.append(path)
        return removed

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob(f"*{self.SUFFIX}"))

    def info(self) -> Tuple[int, int, int, int]:
        """(hits, misses, maxsize, currsize); maxsize 0 = unbounded."""
        return (self.hits, self.misses, 0, len(self))
