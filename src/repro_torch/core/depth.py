"""Stage-1: pipeline-depth heuristic — Sec. III-A / IV-A.

"We determine depth of a segment (starting at layer l) by comparing the
memory footprints A_l + A_{l+D} with sum_{i=l}^{l+D} W_i, increasing the
value of D.  We stop adding more depth the moment sum W_i is greater.  In
case of skip connections we also add additional activations due to skip
connections [to the activation side] ... We also cut the depth if we
encounter a complex layer like ROIAlign.  The depth is also limited by the
size of the substrate: the maximum depth we consider is sqrt(numPEs)."

Branch-aware segments: a ``Segment`` may carry parallel ``branches`` —
disjoint groups of its op indices that execute side by side on the
substrate instead of being serialized in topological order (the
series-parallel regions of ``graph.branch_regions``).  ``branches == ()``
is the ordinary linear segment; the footprint accounting is shared (skip
activations interior to the interval never count against the boundary,
whether the interval is executed as a chain or as co-placed branches).
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from typing import List, Optional, Tuple

from .graph import Graph, COMPLEX_KINDS
from .hwconfig import HWConfig


@dataclasses.dataclass(frozen=True)
class Segment:
    """A pipeline segment: ops[start:stop] (topological indices).

    ``branches`` marks the segment as branch-parallel: each group holds
    *segment-relative* slot indices (0 = ``ops[start]``), topologically
    ordered, of ops placed side by side that converge on the segment's
    final op (the join).  The default ``()`` keeps the linear-chain
    semantics everywhere else.  (``graph.BranchRegion.branches``, by
    contrast, uses absolute op indices — the planner converts when it
    builds the segment.)
    """
    start: int
    stop: int  # exclusive
    branches: Tuple[Tuple[int, ...], ...] = ()

    @property
    def depth(self) -> int:
        return self.stop - self.start

    @property
    def is_branched(self) -> bool:
        return bool(self.branches)

    def __contains__(self, idx: int) -> bool:
        return self.start <= idx < self.stop

    def translate(self, delta: int) -> "Segment":
        """This segment shifted by ``delta`` op slots.  ``branches`` are
        segment-relative, so they carry over unchanged — the shape of the
        plan-folding tile step (plan one period, translate the rest)."""
        return Segment(self.start + delta, self.stop + delta, self.branches)

    def spans_from(self, i: int, max_span: int) -> range:
        """Valid end points j for a sub-segment [i, j) of this segment.

        Used by the planner's cut-point DP: from position i it may cut at
        any j up to ``max_span`` ops away, clipped to the segment end.
        """
        if not self.start <= i < self.stop:
            raise ValueError(f"position {i} outside {self}")
        return range(i + 1, min(i + max_span, self.stop) + 1)


class SkipIndex:
    """Precomputed per-edge structures for skip-crossing queries.

    ``_activation_footprint`` used to re-walk ``g.skip_edges()`` — itself
    an O(ops x inputs) scan — for every (start, stop) candidate the greedy
    depth heuristic probes, a quadratic rescan on skip-dense graphs.  The
    index extracts the (producer, consumer, volume) arrays once; a
    one-off query (``crossing``) is then a single pass over the edges,
    and the dominant access pattern — the greedy sweep holds ``start``
    fixed while ``stop`` grows — touches each edge O(1) times amortized
    through the incremental ``sweep`` cursor.
    """

    def __init__(self, g: Graph):
        self.edges = g.skip_edges()                 # one O(ops) walk, total
        self.vols = [g.ops[p].output_volume() for p, c in self.edges]
        # presorted views so each sweep() is a bisect + slice, not a sort:
        # the greedy heuristic opens one sweep per segment start, and
        # re-sorting the full edge list every time dominated segmentation
        # cost on deep periodic stacks
        pcv = sorted((p, c, v)
                     for (p, c), v in zip(self.edges, self.vols))
        self._by_p = pcv                            # sorted by producer
        self._p_keys = [p for p, _, _ in pcv]
        self._by_c = sorted(pcv, key=lambda t: t[1])  # sorted by consumer
        self._c_keys = [c for _, c, _ in self._by_c]

    def crossing(self, start: int, stop: int) -> int:
        """Total producer volume of skip edges with exactly one endpoint
        inside [start, stop)."""
        total = 0
        for (p, c), v in zip(self.edges, self.vols):
            if (p < start <= c < stop) or (start <= p < stop <= c):
                total += v
        return total

    def sweep(self, start: int):
        """Incremental crossing volumes for a fixed ``start``.

        Returns a callable ``crossing_at(stop)`` that must be invoked with
        non-decreasing ``stop`` values (the greedy heuristic's access
        pattern).  Each edge enters/leaves the crossing set at most once
        across the whole sweep, so a full depth probe costs O(edges)
        instead of O(depth x edges).
        """
        # type-A edges (p < start <= c): enter when stop passes c
        # type-B edges (start <= p): enter when stop passes p, leave when
        # stop passes c.  Both lists come from the presorted views: the
        # consumer-sorted suffix c >= start (filtered to p < start) is
        # already in c-order, and the producer-sorted suffix p >= start is
        # already in p-order.
        a_events = [(c, v)
                    for p, c, v in self._by_c[
                        bisect.bisect_left(self._c_keys, start):]
                    if p < start]
        b_edges = self._by_p
        bi = bisect.bisect_left(self._p_keys, start)
        ai = 0
        acc = 0
        open_heap: List[Tuple[int, int]] = []

        def crossing_at(stop: int) -> int:
            nonlocal ai, bi, acc
            while ai < len(a_events) and a_events[ai][0] < stop:
                acc += a_events[ai][1]
                ai += 1
            while bi < len(b_edges) and b_edges[bi][0] < stop:
                p, c, v = b_edges[bi]
                acc += v
                heapq.heappush(open_heap, (c, v))
                bi += 1
            while open_heap and open_heap[0][0] < stop:
                _, v = heapq.heappop(open_heap)
                acc -= v
            return acc

        return crossing_at


def _activation_footprint(g: Graph, start: int, stop: int,
                          index: Optional[SkipIndex] = None) -> int:
    """A_l + A_{l+D} + skip activations crossing the segment boundary.

    Sec. III-A: activations interior to the segment are forwarded
    producer->consumer (granularity-sized), so only the segment's external
    input, its final output, and every skip-connection activation with one
    endpoint outside (start, stop) count.  This holds for branch-parallel
    intervals too: a co-placed branch's activations are just as interior.
    """
    ops = g.ops
    a_in = ops[start].input_volume()
    a_out = ops[stop - 1].output_volume()
    skips = (index.crossing(start, stop) if index is not None
             else SkipIndex(g).crossing(start, stop))
    return a_in + a_out + skips


def _weight_footprint(g: Graph, start: int, stop: int) -> int:
    return sum(op.weight_volume() for op in g.ops[start:stop])


def segment_graph(g: Graph, hw: HWConfig) -> List[Segment]:
    """Greedy variable-depth segmentation of the model DAG."""
    segs: List[Segment] = []
    n = len(g.ops)
    l = 0
    max_depth = hw.max_depth
    index = SkipIndex(g)
    while l < n:
        # a complex layer runs alone (depth cut on both sides)
        if g.ops[l].kind in COMPLEX_KINDS:
            segs.append(Segment(l, l + 1))
            l += 1
            continue
        stop = l + 1
        crossing_at = index.sweep(l)
        a_in = g.ops[l].input_volume()
        wgt = g.ops[l].weight_volume()
        while stop < n:
            nxt = g.ops[stop]
            if nxt.kind in COMPLEX_KINDS:
                break
            if (stop + 1 - l) > max_depth:
                break
            # the candidate's input must come from inside the segment,
            # otherwise there is no producer->consumer stream to pipeline
            if nxt.inputs and not any(
                    l <= g.index(s) < stop for s in nxt.inputs):
                break
            act = a_in + g.ops[stop].output_volume() + crossing_at(stop + 1)
            wgt += g.ops[stop].weight_volume()
            if wgt > act:
                break  # "the moment sum W_i is greater"
            stop += 1
        segs.append(Segment(l, stop))
        l = stop
    return segs


def segment_depths(g: Graph, hw: HWConfig) -> List[int]:
    """Per-layer depth labels (Fig. 16)."""
    labels = [0] * len(g.ops)
    for seg in segment_graph(g, hw):
        for i in range(seg.start, seg.stop):
            labels[i] = seg.depth
    return labels
