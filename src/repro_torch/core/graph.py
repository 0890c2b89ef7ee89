"""Operator-DAG IR for PipeOrgan.

The paper treats a DNN as a DAG of einsum-style operators (conv, depthwise
conv, GEMM) plus "complex" non-einsum layers (ROIAlign, pooling, elementwise
adds for skip connections).  Ops carry their full dimension tuples so the
analysis layer can compute activation/weight volumes, MACs and loop-nest
ranks exactly as Sec. II-A describes.

Volumes are in *elements*; multiply by ``bytes_per_word`` (Table III: 1 B)
at the cost-model layer.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class OpKind(enum.Enum):
    CONV = "conv"          # O[n,p,q,k] += I[n,p+r,q+s,c] * W[r,s,c,k]
    DWCONV = "dwconv"      # O[n,p,q,c] += I[n,p+r,q+s,c] * W[r,s,c]
    GEMM = "gemm"          # O[m,n]    += A[m,k] * B[k,n]
    POOL = "pool"          # windowed reduction, no weights
    ADD = "add"            # elementwise (skip-connection join)
    CONCAT = "concat"      # channel concat (DenseNet-style skip join)
    ROIALIGN = "roialign"  # complex layer -> pipeline cut (Sec. IV-A)
    UPSAMPLE = "upsample"  # nearest/bilinear upsample, no weights
    GLOBALPOOL = "globalpool"
    ATTEND = "attend"      # LM token mixer (attention / recurrent scan):
    #                        weightless, reads a resident state (KV cache /
    #                        recurrence state); complex -> pipeline cut,
    #                        like ROIAlign (softmax / the sequential scan
    #                        breaks the producer->consumer stream).
    #                        dims {N,H,W,C} are the output (N query
    #                        streams x H tokens x C head dim) plus S (state
    #                        length: KV context / state width) and G (the
    #                        number of distinct state streams, e.g.
    #                        batch x kv-heads under GQA; defaults to N).


#: kinds at which the depth heuristic must cut the pipeline segment.
COMPLEX_KINDS = frozenset({OpKind.ROIALIGN, OpKind.ATTEND})

#: kinds that carry no weights (pure data movers / reductions).
WEIGHTLESS_KINDS = frozenset(
    {OpKind.POOL, OpKind.ADD, OpKind.CONCAT, OpKind.UPSAMPLE,
     OpKind.GLOBALPOOL, OpKind.ROIALIGN, OpKind.ATTEND}
)


@dataclasses.dataclass(frozen=True)
class Op:
    """One operator node.

    dims for CONV/DWCONV: {N,H,W,C,K,R,S} (output H,W post-stride).
    dims for GEMM:        {M,N,K}.
    ``inputs``: names of producer ops whose *output activation* this op
    consumes.  len(inputs) > 1 encodes a skip-connection join.
    """

    name: str
    kind: OpKind
    dims: Dict[str, int]
    inputs: Tuple[str, ...] = ()
    stride: int = 1

    # ---- volumes (elements) -------------------------------------------------
    def weight_volume(self) -> int:
        d = self.dims
        if self.kind == OpKind.CONV:
            return d["R"] * d["S"] * d["C"] * d["K"]
        if self.kind == OpKind.DWCONV:
            return d["R"] * d["S"] * d["C"]
        if self.kind == OpKind.GEMM:
            return d["K"] * d["N"]
        return 0

    def output_volume(self) -> int:
        # memoized: the planner's DP calls this ~100k times per cold plan
        # (burst counts, PE allocation, span signatures).  Frozen blocks
        # normal assignment but not object.__setattr__; the memo is not a
        # dataclass field, so eq/repr are unaffected.
        v = self.__dict__.get("_output_volume")
        if v is not None:
            return v
        v = self._output_volume_impl()
        object.__setattr__(self, "_output_volume", v)
        return v

    def _output_volume_impl(self) -> int:
        d = self.dims
        if self.kind in (OpKind.CONV,):
            return d["N"] * d["H"] * d["W"] * d["K"]
        if self.kind in (OpKind.DWCONV, OpKind.POOL, OpKind.ADD,
                         OpKind.UPSAMPLE):
            return d["N"] * d["H"] * d["W"] * d["C"]
        if self.kind == OpKind.CONCAT:
            return d["N"] * d["H"] * d["W"] * d["C"]  # C = concat total
        if self.kind == OpKind.GLOBALPOOL:
            return d["N"] * d["C"]
        if self.kind == OpKind.GEMM:
            return d["M"] * d["N"]
        if self.kind in (OpKind.ROIALIGN, OpKind.ATTEND):
            return d["N"] * d["H"] * d["W"] * d["C"]
        raise ValueError(self.kind)

    def input_volume(self) -> int:
        """Volume of the activation(s) consumed (pre-stride spatial)."""
        d = self.dims
        if self.kind == OpKind.CONV:
            return d["N"] * d["H"] * self.stride * d["W"] * self.stride * d["C"]
        if self.kind in (OpKind.DWCONV, OpKind.POOL):
            return d["N"] * d["H"] * self.stride * d["W"] * self.stride * d["C"]
        if self.kind == OpKind.GEMM:
            return d["M"] * d["K"]
        if self.kind in (OpKind.ADD, OpKind.CONCAT):
            return self.output_volume()  # per-input share handled by caller
        if self.kind == OpKind.UPSAMPLE:
            return self.output_volume() // max(1, self.stride * self.stride)
        if self.kind == OpKind.GLOBALPOOL:
            return d["N"] * d["H"] * d["W"] * d["C"]
        if self.kind == OpKind.ROIALIGN:
            return d["N"] * d["H"] * d["W"] * d["C"]
        if self.kind == OpKind.ATTEND:
            # the fresh queries plus the resident state swept per step
            # (G streams of S x C each, read and combined: K and V halves
            # of a KV cache, or the recurrence state matrix)
            return (self.output_volume()
                    + 2 * d.get("G", d["N"]) * d.get("S", 1) * d["C"])
        raise ValueError(self.kind)

    def macs(self) -> int:
        d = self.dims
        if self.kind == OpKind.CONV:
            return d["N"] * d["H"] * d["W"] * d["K"] * d["C"] * d["R"] * d["S"]
        if self.kind == OpKind.DWCONV:
            return d["N"] * d["H"] * d["W"] * d["C"] * d["R"] * d["S"]
        if self.kind == OpKind.GEMM:
            return d["M"] * d["N"] * d["K"]
        if self.kind == OpKind.ATTEND:
            # QK^T + AV (or the equivalent scan update): 2 passes over the
            # state per query token
            return 2 * d["N"] * d["H"] * d["W"] * d.get("S", 1) * d["C"]
        # weightless ops: one "mac" per output element (cheap, keeps the
        # load-balancer from dividing by zero)
        return self.output_volume()

    def activation_volume(self) -> int:
        return self.input_volume() + self.output_volume()

    def aw_ratio(self) -> float:
        w = self.weight_volume()
        if w == 0:
            return float("inf")
        return self.activation_volume() / w

    # ---- loop-nest ranks (Sec. II-A) ---------------------------------------
    def output_ranks(self) -> Tuple[str, ...]:
        if self.kind == OpKind.CONV:
            return ("N", "H", "W", "K")
        if self.kind in (OpKind.DWCONV, OpKind.POOL, OpKind.ADD,
                         OpKind.CONCAT, OpKind.UPSAMPLE):
            return ("N", "H", "W", "C")
        if self.kind == OpKind.GEMM:
            return ("M", "N")
        if self.kind == OpKind.GLOBALPOOL:
            return ("N", "C")
        return ("N", "H", "W", "C")

    def contracted_ranks(self) -> Tuple[str, ...]:
        if self.kind == OpKind.CONV:
            return ("C", "R", "S")
        if self.kind == OpKind.DWCONV:
            return ("R", "S")
        if self.kind == OpKind.GEMM:
            return ("K",)
        return ()

    def all_ranks(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(self.output_ranks() + self.contracted_ranks()))


@dataclasses.dataclass
class Graph:
    """A model DAG in topological order."""

    name: str
    ops: List[Op]

    def __post_init__(self) -> None:
        self._index = {op.name: i for i, op in enumerate(self.ops)}
        if len(self._index) != len(self.ops):
            raise ValueError(f"duplicate op names in graph {self.name}")
        # consumer adjacency, built once: ``consumers`` used to rescan the
        # whole op list per call, which is O(ops) on a hot analysis path
        self._consumers: Dict[str, List[int]] = {op.name: []
                                                 for op in self.ops}
        for op in self.ops:
            for src in op.inputs:
                if src not in self._index:
                    raise ValueError(f"{op.name} consumes unknown op {src}")
                if self._index[src] >= self._index[op.name]:
                    raise ValueError(
                        f"graph {self.name} not topologically ordered: "
                        f"{op.name} <- {src}")
                ci = self._index[op.name]
                if ci not in self._consumers[src]:
                    self._consumers[src].append(ci)

    def index(self, name: str) -> int:
        return self._index[name]

    def op(self, name: str) -> Op:
        return self.ops[self._index[name]]

    def consumers(self, name: str) -> List[Op]:
        """Ops consuming ``name``'s output, in topological order (the
        adjacency map is prebuilt in ``__post_init__``; behavior is pinned
        against the naive scan by an equivalence test).  Unknown names
        yield ``[]``, exactly like the scan did."""
        return [self.ops[i] for i in self._consumers.get(name, ())]

    # ---- skip-connection census (Fig. 6) ------------------------------------
    def skip_edges(self) -> List[Tuple[int, int]]:
        """(producer_idx, consumer_idx) pairs with reuse distance > 1.

        Memoized: ops are fixed after construction, and per-span callers
        (fold signatures, the verifier's segment sweep) would otherwise
        rescan the whole graph once per segment."""
        cached = getattr(self, "_skip_edges", None)
        if cached is not None:
            return list(cached)
        out = []
        for op in self.ops:
            ci = self._index[op.name]
            for src in op.inputs:
                pi = self._index[src]
                if ci - pi > 1:
                    out.append((pi, ci))
        out.sort()
        self._skip_edges: List[Tuple[int, int]] = out
        return list(out)

    def reuse_distances(self) -> List[int]:
        return [c - p for p, c in self.skip_edges()]

    def skip_density(self) -> float:
        if not self.ops:
            return 0.0
        return len(self.skip_edges()) / len(self.ops)

    # ---- totals -------------------------------------------------------------
    def total_macs(self) -> int:
        return sum(op.macs() for op in self.ops)

    def total_weights(self) -> int:
        return sum(op.weight_volume() for op in self.ops)

    # ---- structural digests (periodicity detection) -------------------------
    def op_digest(self, i: int) -> Tuple:
        """Structural digest of ``ops[i]``: everything the planner's span
        signature reads from one op, by value and *modulo slot offset* —
        kind, dims, stride, and the input wiring as relative offsets
        (``i - producer_index``).  Two ops with equal digests are
        interchangeable up to translation: same shapes, same strides, same
        producers at the same relative distances."""
        digests = self._op_digests()
        return digests[i]

    def _op_digests(self) -> List[Tuple]:
        cached = self.__dict__.get("_op_digest_memo")
        if cached is not None and len(cached) == len(self.ops):
            return cached
        out = [
            (op.kind.value, tuple(sorted(op.dims.items())), op.stride,
             tuple(sorted(i - self._index[s] for s in op.inputs)))
            for i, op in enumerate(self.ops)]
        self.__dict__["_op_digest_memo"] = out
        return out

    def max_reuse_distance(self) -> int:
        """Longest producer->consumer index distance over *all* edges
        (direct and skip); 1 for a pure chain, 0 for an edgeless graph.
        Bounds how far an op's wiring environment reaches — the safety
        margin for periodic-run interior reasoning."""
        dist = 0
        for op in self.ops:
            ci = self._index[op.name]
            for src in op.inputs:
                dist = max(dist, ci - self._index[src])
        return dist


# ---------------------------------------------------------------------------
# Periodicity detection: maximal runs of isomorphic blocks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PeriodicRun:
    """A maximal run of isomorphic blocks: ``ops[start : start +
    period*count)`` consists of ``count`` consecutive blocks of ``period``
    ops whose structural digests (``Graph.op_digest``) repeat exactly —
    same shapes/strides/wiring modulo slot offset.  The repeated-layer
    shape of LM stacks."""

    start: int
    period: int
    count: int

    @property
    def stop(self) -> int:
        return self.start + self.period * self.count

    def __contains__(self, idx: int) -> bool:
        return self.start <= idx < self.stop


def periodic_regions(g: Graph, min_count: int = 2,
                     max_period: Optional[int] = None) -> List[PeriodicRun]:
    """Maximal periodic runs of ``g``'s op sequence, by structural digest.

    Scans periods in increasing order and keeps, for each position, the
    smallest-period maximal run covering it (a run wholly inside an
    already-kept run is subsumed — e.g. period 2p repeats inside a period-p
    run).  Runs are cropped to whole blocks, never overlap, and are
    returned sorted by ``start``.  O(n * max_period) digest-id
    comparisons; digests are interned to ints first.
    """
    n = len(g.ops)
    if n == 0:
        return []
    intern: Dict[Tuple, int] = {}
    ids = np.asarray(
        [intern.setdefault(d, len(intern)) for d in g._op_digests()],
        dtype=np.int64)
    if max_period is None:
        max_period = n // max(2, min_count)
    runs: List[PeriodicRun] = []

    def covered(a: int, b: int) -> bool:
        return any(r.start <= a and b <= r.stop for r in runs)

    for period in range(1, max_period + 1):
        # eq[i] <=> ids[i] == ids[i + period]; maximal True runs [a, b)
        # are the periodic stretches (digests periodic over [a, b+period))
        eq = (ids[:-period] == ids[period:]).view(np.int8)
        if not eq.any():
            continue
        step = np.diff(eq)
        starts = np.flatnonzero(step == 1) + 1
        ends = np.flatnonzero(step == -1) + 1
        if eq[0]:
            starts = np.concatenate(([0], starts))
        if eq[-1]:
            ends = np.concatenate((ends, [len(eq)]))
        for a, b in zip(starts.tolist(), ends.tolist()):
            count = (b + period - a) // period  # crop to whole blocks
            if count >= min_count and not covered(a, a + period * count):
                runs.append(PeriodicRun(a, period, count))
    runs.sort(key=lambda r: (r.start, r.period))
    # drop overlaps, preferring earlier starts then smaller periods
    out: List[PeriodicRun] = []
    last_stop = 0
    for r in runs:
        if r.start >= last_stop:
            out.append(r)
            last_stop = r.stop
    return out


# ---------------------------------------------------------------------------
# Series-parallel decomposition (branch-aware planning, CMDS-style regions)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SPBlock:
    """One block of a series-parallel decomposition of an op interval.

    ``branches == ()`` marks a *series* block: a single synchronization op
    (every path through the interval passes through it).  A non-empty
    ``branches`` marks a *parallel* block: the ops in ``[start, stop)`` are
    partitioned into weakly-connected components ("branches") that carry no
    edges between each other, so they can execute concurrently side by side
    on the substrate.  Branch tuples hold absolute op indices in
    topological order.
    """

    start: int
    stop: int  # exclusive
    branches: Tuple[Tuple[int, ...], ...] = ()

    @property
    def is_parallel(self) -> bool:
        return bool(self.branches)


def series_parallel_decomposition(g: Graph, start: int = 0,
                                  stop: Optional[int] = None
                                  ) -> List[SPBlock]:
    """Decompose ``g.ops[start:stop]`` into series ops and parallel regions.

    An op at index ``i`` is a *sync point* iff no edge (p, c) restricted to
    the interval jumps it (``p < i < c``) — every dataflow path through the
    interval is serialized through it.  Maximal runs of non-sync ops
    between two sync points form one parallel block whose branches are the
    weakly connected components of the interior edge set.

    Properties (pinned by the hypothesis suite): the blocks partition
    ``[start, stop)`` in topological order, every interior op lands in
    exactly one branch, and a pure chain degrades to the identity
    decomposition (every op its own series block).
    """
    n = len(g.ops)
    if stop is None:
        stop = n
    if not 0 <= start <= stop <= n:
        raise ValueError(f"bad interval [{start}, {stop}) for {n} ops")
    if start == stop:
        return []

    # coverage[i] > 0 <=> some restricted edge jumps op i (difference array)
    cover = [0] * (stop - start + 1)
    edges: List[Tuple[int, int]] = []
    for op in g.ops[start:stop]:
        ci = g.index(op.name)
        for src in op.inputs:
            pi = g.index(src)
            if pi < start:
                continue
            edges.append((pi, ci))
            if ci - pi > 1:
                cover[pi + 1 - start] += 1
                cover[ci - start] -= 1
    run = 0
    sync = []
    for i in range(start, stop):
        run += cover[i - start]
        if run == 0:
            sync.append(i)

    # union-find over interior ops: edges with both endpoints interior (and
    # inside the same inter-sync gap, which is automatic: an edge spanning a
    # sync point would contradict the sync property) merge branches.
    sync_set = set(sync)
    parent: Dict[int, int] = {}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(start, stop):
        if i not in sync_set:
            parent[i] = i
    for p, c in edges:
        if p in parent and c in parent:
            rp, rc = find(p), find(c)
            if rp != rc:
                parent[rc] = rp

    blocks: List[SPBlock] = []
    i = start
    while i < stop:
        if i in sync_set:
            blocks.append(SPBlock(i, i + 1))
            i += 1
            continue
        j = i
        while j < stop and j not in sync_set:
            j += 1
        comps: Dict[int, List[int]] = {}
        for k in range(i, j):
            comps.setdefault(find(k), []).append(k)
        branches = tuple(sorted((tuple(sorted(v)) for v in comps.values()),
                                key=lambda b: b[0]))
        blocks.append(SPBlock(i, j, branches))
        i = j
    return blocks


@dataclasses.dataclass(frozen=True)
class BranchRegion:
    """A co-placeable fork/branches/join region over a contiguous interval.

    ``ops[start:stop]`` is ``[fork?] + interior + [join]`` in topological
    order: the (optional) fork op feeding every branch head, the parallel
    branches (absolute op indices, ≥ 1 op each), and the join op consuming
    every branch tail.  ``fork_to_join`` marks a direct fork→join data edge
    (a zero-length branch: ResNet identity skips, DenseNet pass-through
    concat inputs).
    """

    start: int
    stop: int  # exclusive; ops[stop - 1] is the join
    branches: Tuple[Tuple[int, ...], ...]
    has_fork: bool
    fork_to_join: bool = False

    @property
    def join(self) -> int:
        return self.stop - 1

    @property
    def fork(self) -> Optional[int]:
        return self.start if self.has_fork else None

    @property
    def depth(self) -> int:
        return self.stop - self.start


def branch_regions(g: Graph, start: int = 0, stop: Optional[int] = None,
                   max_len: Optional[int] = None) -> List[BranchRegion]:
    """Fork/branches/join regions of ``g.ops[start:stop]``.

    One region per parallel block of ``series_parallel_decomposition``
    whose following sync op (the join) lies inside the interval.  The
    preceding sync op, when present, becomes the region's fork.  Regions
    longer than ``max_len`` ops are dropped (they cannot fit a pipeline
    segment anyway).  Edges entering or leaving the region elsewhere are
    *allowed* — the planner accounts them as boundary-crossing skip
    traffic, exactly like linear segments do.
    """
    blocks = series_parallel_decomposition(g, start, stop)
    out: List[BranchRegion] = []
    for bi, blk in enumerate(blocks):
        if not blk.is_parallel:
            continue
        if bi + 1 >= len(blocks) or blocks[bi + 1].is_parallel:
            continue  # no join inside the interval
        join = blocks[bi + 1].start
        has_fork = bi > 0 and not blocks[bi - 1].is_parallel
        rstart = blk.start - 1 if has_fork else blk.start
        if max_len is not None and join + 1 - rstart > max_len:
            continue
        fork_to_join = has_fork and any(
            g.index(s) == rstart for s in g.ops[join].inputs)
        out.append(BranchRegion(rstart, join + 1, blk.branches, has_fork,
                                fork_to_join))
    return out


def chain(name: str, ops: Sequence[Op]) -> Graph:
    """Wire a plain chain (each op consumes its predecessor) into a Graph."""
    wired: List[Op] = []
    prev: Optional[str] = None
    for op in ops:
        if prev is not None and not op.inputs:
            op = dataclasses.replace(op, inputs=(prev,))
        wired.append(op)
        prev = op.name
    return Graph(name, wired)


def conv(name: str, n: int, h: int, w: int, c: int, k: int, r: int = 3,
         s: Optional[int] = None, stride: int = 1,
         inputs: Tuple[str, ...] = ()) -> Op:
    return Op(name, OpKind.CONV,
              dict(N=n, H=h, W=w, C=c, K=k, R=r, S=s if s is not None else r),
              inputs=inputs, stride=stride)


def dwconv(name: str, n: int, h: int, w: int, c: int, r: int = 3,
           stride: int = 1, inputs: Tuple[str, ...] = ()) -> Op:
    return Op(name, OpKind.DWCONV, dict(N=n, H=h, W=w, C=c, R=r, S=r),
              inputs=inputs, stride=stride)


def gemm(name: str, m: int, n: int, k: int,
         inputs: Tuple[str, ...] = ()) -> Op:
    return Op(name, OpKind.GEMM, dict(M=m, N=n, K=k), inputs=inputs)


def add(name: str, n: int, h: int, w: int, c: int,
        inputs: Tuple[str, ...] = ()) -> Op:
    return Op(name, OpKind.ADD, dict(N=n, H=h, W=w, C=c), inputs=inputs)


def concat(name: str, n: int, h: int, w: int, c_total: int,
           inputs: Tuple[str, ...] = ()) -> Op:
    return Op(name, OpKind.CONCAT, dict(N=n, H=h, W=w, C=c_total),
              inputs=inputs)


def attend(name: str, n: int, h: int, c: int, s: int = 1,
           g: Optional[int] = None,
           inputs: Tuple[str, ...] = ()) -> Op:
    """LM token mixer: ``n`` query streams (batch x heads) of ``h`` tokens
    with head dim ``c``, mixing against a resident state of length ``s``
    (KV context for attention, 1 for a recurrent scan) shared across
    ``g`` state streams (batch x kv-heads under GQA; defaults to ``n``)."""
    dims = dict(N=n, H=h, W=1, C=c, S=s)
    if g is not None:
        dims["G"] = g
    return Op(name, OpKind.ATTEND, dims, inputs=inputs)
