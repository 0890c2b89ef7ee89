"""Cycle-approximate NoC model: mesh, AMP, torus, flattened butterfly.

Automates the traffic analysis drawn by hand in Figs. 8-12: given a
``Placement`` and per-interval communication volumes it derives per-link
channel loads, hop counts, congestion and energy.

Latency rule (Sec. VI-C / Fig. 15): an interval is congestion-free when the
compute interval >= worst-case channel load (in cycles; 1 word/link/cycle).
When congested, "the overall interval delay is worst-case channel load x
compute interval".

Three engines compute the same statistics:

  * ``analyze_batch``      — two-phase batched engine (planner hot path):
    a words-independent ``RouteIncidence`` table is expanded once per flow
    coordinate set and cached, then a whole frontier of candidate flow
    sets is priced in one segment-sum pass over the shared incidence.
  * ``analyze``            — batched numpy path expansion; all flows of one
    set are routed and accumulated onto links at once.
  * ``analyze_reference``  — the original per-flow scalar walk, kept as the
    semantic reference; tests assert all three agree bit-for-bit on every
    topology.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import hashlib
import threading
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .hwconfig import HWConfig
from .spatial import Placement

Coord = Tuple[int, int]
Link = Tuple[Coord, Coord]


class Topology(enum.Enum):
    MESH = "mesh"
    AMP = "amp"
    TORUS = "torus"
    FLATTENED_BUTTERFLY = "flattened_butterfly"


@dataclasses.dataclass(frozen=True)
class Flow:
    src: Coord
    dst: Coord
    words: float  # words per pipeline interval


@dataclasses.dataclass
class TrafficStats:
    topology: Topology
    worst_channel_load: float      # words/interval through the hottest link
    total_hop_words: float         # sum over flows of words * hops
    total_wire_words: float        # sum over flows of words * wire length
    max_path_hops: int
    num_links_used: int
    link_count: int                # total links in the topology

    def interval_comm_delay(self, compute_interval: float) -> float:
        """Paper's Fig. 15 rule, with a physical serialization ceiling.

        Congestion-free when load <= compute interval.  When congested the
        paper models backlog feedback as load x interval (matches its
        worked example: load 8, interval 2 -> delay 16); we cap it at the
        store-and-forward serialization bound load + hops + interval, which
        the backlog cannot physically exceed at 1 word/link/cycle.
        """
        load = self.worst_channel_load
        if load <= compute_interval:
            return compute_interval
        # burst-model loads are O(block height), so the paper's backlog
        # formula stays bounded; retain the store-and-forward ceiling for
        # the rare coarse burst.
        return min(load * max(1.0, compute_interval),
                   max(load * 2.0, load + self.max_path_hops
                       + compute_interval))

    def congested(self, compute_interval: float) -> bool:
        return self.worst_channel_load > compute_interval

    def hop_energy(self, hw: HWConfig) -> float:
        # router traversal + wire energy proportional to physical length
        return hw.e_hop * (0.5 * self.total_hop_words
                           + 0.5 * self.total_wire_words)


def _steps_1d(delta: int, size: int, topology: Topology,
              express: int) -> List[int]:
    """Decompose a 1-D displacement into per-hop strides."""
    steps: List[int] = []
    if topology == Topology.TORUS and abs(delta) > size // 2:
        delta = delta - size * (1 if delta > 0 else -1)
    sign = 1 if delta >= 0 else -1
    rem = abs(delta)
    if topology == Topology.AMP and express > 1:
        while rem >= express:
            steps.append(sign * express)
            rem -= express
    while rem > 0:
        steps.append(sign)
        rem -= 1
    return steps


def route(src: Coord, dst: Coord, rows: int, cols: int,
          topology: Topology, express: int) -> List[Link]:
    """Dimension-ordered (X then Y) routing; returns directed links."""
    links: List[Link] = []
    r, c = src
    if topology == Topology.FLATTENED_BUTTERFLY:
        if c != dst[1]:
            links.append(((r, c), (r, dst[1])))
            c = dst[1]
        if r != dst[0]:
            links.append(((r, c), (dst[0], c)))
        return links
    for s in _steps_1d(dst[1] - c, cols, topology, express):
        nc = (c + s) % cols if topology == Topology.TORUS else c + s
        links.append(((r, c), (r, nc)))
        c = nc
    for s in _steps_1d(dst[0] - r, rows, topology, express):
        nr = (r + s) % rows if topology == Topology.TORUS else r + s
        links.append(((r, c), (nr, c)))
        r = nr
    return links


def _link_len(link: Link, rows: int, cols: int, topology: Topology) -> int:
    (r1, c1), (r2, c2) = link
    dr, dc = abs(r2 - r1), abs(c2 - c1)
    if topology == Topology.TORUS:
        dr = min(dr, rows - dr)
        dc = min(dc, cols - dc)
    return max(dr, dc)


def topology_link_count(rows: int, cols: int, topology: Topology,
                        express: int) -> int:
    mesh = rows * (cols - 1) + cols * (rows - 1)
    if topology == Topology.MESH:
        return mesh
    if topology == Topology.TORUS:
        return mesh + rows + cols
    if topology == Topology.AMP:
        # one express link of length `express` per PE per direction where it
        # fits (Sec. IV-D: < 2x the links of mesh, O(sqrt N) length)
        ex = rows * max(0, cols - express) + cols * max(0, rows - express)
        return mesh + ex
    if topology == Topology.FLATTENED_BUTTERFLY:
        # all-to-all within each row and each column: O(N log N)-ish
        return (rows * cols * (cols - 1) // 2) + (cols * rows * (rows - 1) // 2)
    raise ValueError(topology)


@dataclasses.dataclass
class FlowBatch:
    """Structure-of-arrays flow set for the vectorized NoC engine.

    Carries the same information as a ``Sequence[Flow]`` — ``src[i]`` /
    ``dst[i]`` are (row, col) and ``words[i]`` the per-interval volume —
    but as numpy arrays so ``analyze`` can expand every path at once.
    Order is significant: the adaptive last-hop port arbitration assigns
    ingress ports in flow order, exactly like the scalar engine.
    """
    src: np.ndarray    # int64 [n, 2]
    dst: np.ndarray    # int64 [n, 2]
    words: np.ndarray  # float64 [n]

    def __len__(self) -> int:
        return int(self.words.shape[0])

    @staticmethod
    def empty() -> "FlowBatch":
        return FlowBatch(np.zeros((0, 2), np.int64), np.zeros((0, 2), np.int64),
                         np.zeros(0, np.float64))

    @staticmethod
    def from_flows(flows: Sequence[Flow]) -> "FlowBatch":
        if not flows:
            return FlowBatch.empty()
        return FlowBatch(np.array([f.src for f in flows], np.int64),
                         np.array([f.dst for f in flows], np.int64),
                         np.array([f.words for f in flows], np.float64))

    @staticmethod
    def concat(batches: Sequence["FlowBatch"]) -> "FlowBatch":
        batches = [b for b in batches if len(b)]
        if not batches:
            return FlowBatch.empty()
        if len(batches) == 1:
            return batches[0]
        return FlowBatch(np.concatenate([b.src for b in batches]),
                         np.concatenate([b.dst for b in batches]),
                         np.concatenate([b.words for b in batches]))

    def to_flows(self) -> List[Flow]:
        return [Flow((int(s[0]), int(s[1])), (int(d[0]), int(d[1])), float(w))
                for s, d, w in zip(self.src, self.dst, self.words)]


def _expand(counts: np.ndarray):
    """(flow_idx, step_within_flow) arrays for per-flow step counts."""
    total = int(counts.sum())
    fidx = np.repeat(np.arange(counts.shape[0]), counts)
    starts = np.cumsum(counts) - counts
    t = np.arange(total) - np.repeat(starts, counts)
    return fidx, t


def analyze(flows, hw: HWConfig, topology: Topology) -> TrafficStats:
    """Vectorized traffic analysis over all flows at once.

    Accepts a ``FlowBatch`` or any ``Sequence[Flow]``.  Matches
    ``analyze_reference`` exactly: paths are expanded in (flow, hop) order
    before per-link accumulation, so channel loads — including the
    order-dependent adaptive last-hop port arbitration — come out
    bit-identical to the scalar walk.
    """
    fb = flows if isinstance(flows, FlowBatch) else FlowBatch.from_flows(flows)
    rows, cols = hw.pe_rows, hw.pe_cols
    express = hw.amp_link_len if topology == Topology.AMP else 1
    link_count = topology_link_count(rows, cols, topology, express)

    sr = fb.src[:, 0].astype(np.int64)
    sc = fb.src[:, 1].astype(np.int64)
    dr = fb.dst[:, 0].astype(np.int64)
    dc = fb.dst[:, 1].astype(np.int64)
    w = fb.words.astype(np.float64)
    keep = (w > 0) & ((sr != dr) | (sc != dc))
    sr, sc, dr, dc, w = sr[keep], sc[keep], dr[keep], dc[keep], w[keep]
    n = int(w.shape[0])
    if n == 0:
        return TrafficStats(topology, 0.0, 0.0, 0.0, 0, 0, link_count)

    N = rows * cols
    dstn = dr * cols + dc

    # adaptive last-hop arbitration: the k-th flow converging on a consumer
    # PE takes ingress port k mod 4 — a stable group-cumcount by dst node
    order = np.argsort(dstn, kind="stable")
    sorted_d = dstn[order]
    grp_start = np.flatnonzero(np.r_[True, sorted_d[1:] != sorted_d[:-1]])
    grp_sizes = np.diff(np.r_[grp_start, n])
    cum = np.arange(n) - np.repeat(grp_start, grp_sizes)
    port = np.empty(n, np.int64)
    port[order] = cum % 4

    # ---- batched dimension-ordered path expansion ---------------------------
    phases = []  # (flow_idx, global_step, src_node, dst_node, wire_len)
    if topology == Topology.FLATTENED_BUTTERFLY:
        hasx = sc != dc
        hasy = sr != dr
        fx = np.flatnonzero(hasx)
        phases.append((fx, np.zeros(fx.size, np.int64),
                       sr[fx] * cols + sc[fx], sr[fx] * cols + dc[fx],
                       np.abs(dc[fx] - sc[fx])))
        fy = np.flatnonzero(hasy)
        phases.append((fy, hasx[fy].astype(np.int64),
                       sr[fy] * cols + dc[fy], dr[fy] * cols + dc[fy],
                       np.abs(dr[fy] - sr[fy])))
        path_len = hasx.astype(np.int64) + hasy.astype(np.int64)
    else:
        wrap = topology == Topology.TORUS
        dx = dc - sc
        dy = dr - sr
        if wrap:
            dx = np.where(np.abs(dx) > cols // 2, dx - cols * np.sign(dx), dx)
            dy = np.where(np.abs(dy) > rows // 2, dy - rows * np.sign(dy), dy)
        sx = np.where(dx >= 0, 1, -1)
        sy = np.where(dy >= 0, 1, -1)
        ax, ay = np.abs(dx), np.abs(dy)
        use_express = topology == Topology.AMP and express > 1
        ex = ax // express if use_express else np.zeros_like(ax)
        ey = ay // express if use_express else np.zeros_like(ay)
        ux, uy = ax - ex * express, ay - ey * express
        path_len = ex + ux + ey + uy

        def walk(counts, start, stride, fixed, along_cols, step_off, wlen,
                 size):
            fidx, t = _expand(counts)
            if fidx.size == 0:
                return None
            cur = start[fidx] + stride[fidx] * t
            nxt = cur + stride[fidx]
            if wrap:
                cur, nxt = cur % size, nxt % size
            if along_cols:
                s_node = fixed[fidx] * cols + cur
                d_node = fixed[fidx] * cols + nxt
            else:
                s_node = cur * cols + fixed[fidx]
                d_node = nxt * cols + fixed[fidx]
            return (fidx, step_off[fidx] + t, s_node, d_node,
                    np.full(fidx.size, wlen, np.int64))

        for ph in (walk(ex, sc, sx * express, sr, True,
                        np.zeros(n, np.int64), express, cols),
                   walk(ux, sc + sx * ex * express, sx, sr, True, ex, 1,
                        cols),
                   walk(ey, sr, sy * express, dc, False, ex + ux, express,
                        rows),
                   walk(uy, sr + sy * ey * express, sy, dc, False,
                        ex + ux + ey, 1, rows)):
            if ph is not None:
                phases.append(ph)

    # Scatter every phase into a flow-major layout: link k of flow f lands
    # at path_start[f] + k.  This reproduces the scalar walk's (flow, hop)
    # accumulation order exactly — same float rounding, no sort needed.
    total = int(path_len.sum())
    path_start = np.cumsum(path_len) - path_len
    srcn_all = np.empty(total, np.int64)
    dstn_all = np.empty(total, np.int64)
    wire_all = np.empty(total, np.int64)
    for fidx, step, s_node, d_node, wlen in phases:
        pos = path_start[fidx] + step
        srcn_all[pos] = s_node
        dstn_all[pos] = d_node
        wire_all[pos] = wlen
    fidx_all = np.repeat(np.arange(n), path_len)
    words_l = w[fidx_all]

    is_last = np.zeros(total, bool)
    is_last[path_start + path_len - 1] = True
    codes = np.where(is_last,
                     N * N + dstn[fidx_all] * 4 + port[fidx_all],
                     srcn_all * N + dstn_all)
    code_span = N * N + 4 * N + 4
    if code_span < 2 ** 31:
        codes = codes.astype(np.int32)   # smaller keys sort faster
    if codes.shape[0] > 65536:
        # dense accumulation: one C pass over the code space, no big sort
        loads = np.bincount(codes, weights=words_l, minlength=code_span)
        uniq = np.unique(codes)
        worst = float(loads[uniq].max())
        used = int(uniq.shape[0])
    else:
        uniq, inv = np.unique(codes, return_inverse=True)
        loads = np.bincount(inv, weights=words_l)
        worst = float(loads.max())
        used = int(uniq.shape[0])
    return TrafficStats(
        topology=topology,
        worst_channel_load=worst,
        total_hop_words=float(np.sum(w * path_len)),
        total_wire_words=float(np.sum(words_l * wire_all)),
        max_path_hops=int(path_len.max()),
        num_links_used=used,
        link_count=link_count,
    )


def analyze_reference(flows: Sequence[Flow], hw: HWConfig, topology: Topology
                      ) -> TrafficStats:
    """Scalar per-flow reference walk (the pre-vectorization engine)."""
    rows, cols = hw.pe_rows, hw.pe_cols
    express = hw.amp_link_len if topology == Topology.AMP else 1
    load: Dict[object, float] = defaultdict(float)
    ingress_port: Dict[Coord, int] = defaultdict(int)
    total_hop_words = 0.0
    total_wire_words = 0.0
    max_hops = 0
    for f in flows:
        if f.src == f.dst or f.words <= 0:
            continue
        path = route(f.src, f.dst, rows, cols, topology, express)
        max_hops = max(max_hops, len(path))
        total_hop_words += f.words * len(path)
        for i, link in enumerate(path):
            key: object = link
            if i == len(path) - 1:
                # adaptive last-hop: flows converging on one consumer PE
                # arbitrate across its (up to) 4 ingress ports
                port = ingress_port[f.dst] % 4
                ingress_port[f.dst] += 1
                key = (f.dst, "in", port)
            load[key] += f.words
            total_wire_words += f.words * _link_len(link, rows, cols, topology)
    worst = max(load.values()) if load else 0.0
    return TrafficStats(
        topology=topology,
        worst_channel_load=worst,
        total_hop_words=total_hop_words,
        total_wire_words=total_wire_words,
        max_path_hops=max_hops,
        num_links_used=len(load),
        link_count=topology_link_count(rows, cols, topology, express),
    )


# ---------------------------------------------------------------------------
# Traffic generation from a placement
# ---------------------------------------------------------------------------

def _rowmajor(coords: np.ndarray) -> List[Coord]:
    return [tuple(x) for x in coords[np.lexsort((coords[:, 1], coords[:, 0]))]]


def pair_flows(placement: Placement, src_slot: int, dst_slot: int,
               words_per_interval: float) -> List[Flow]:
    """Producer->consumer unicast flows for one layer pair.

    Fine-grained organizations constrain the consumer's parallelization to
    match the producer's (Sec. IV-B), so each producer PE feeds its
    *nearest* consumer PE — in a striped/checkerboard placement that is the
    adjacent stripe/cell (Fig. 10: congestion-free single hops).
    """
    src_a = placement.pes_of(src_slot)
    dst_a = placement.pes_of(dst_slot)
    if src_a.size == 0 or dst_a.size == 0:
        return []
    # manhattan-nearest consumer for every producer PE (numpy broadcast)
    d = (np.abs(src_a[:, None, 0] - dst_a[None, :, 0])
         + np.abs(src_a[:, None, 1] - dst_a[None, :, 1]))
    nearest = np.argmin(d, axis=1)
    per_src = words_per_interval / len(src_a)
    return [Flow((int(s[0]), int(s[1])),
                 (int(dst_a[j][0]), int(dst_a[j][1])), per_src)
            for s, j in zip(src_a, nearest)]


def multicast_flows(placement: Placement, src_slot: int, dst_slot: int,
                    words_per_interval: float) -> List[Flow]:
    """Blocked-organization traffic: store-and-forward multicast chains.

    With a blocked allocation the consumer keeps its own (flexible)
    intra-op parallelization, so an intermediate word is needed by *many*
    consumer PEs (e.g. an input-stationary consumer spreads output channels
    over its whole block).  Each producer PE's words enter the consumer
    block and are forwarded PE-to-PE down the consumer PEs of its column
    (Figs. 8-9: the long overlapping vertical paths).  Fine-grained
    interleavings instead constrain the consumer to consume exactly what
    its neighbour produced (Sec. IV-B), which is the unicast `pair_flows`.
    """
    src = _rowmajor(placement.pes_of(src_slot))
    dst = placement.pes_of(dst_slot)
    if not src or dst.size == 0:
        return []
    by_col: Dict[int, List[Coord]] = {}
    for r, c in dst:
        by_col.setdefault(int(c), []).append((int(r), int(c)))
    cols = sorted(by_col)
    per_src = words_per_interval / len(src)
    flows: List[Flow] = []
    for s in src:
        col = min(cols, key=lambda c: abs(c - s[1]))
        chain = sorted(by_col[col], key=lambda d: abs(d[0] - s[0]))
        hop_from = s
        # enter at the nearest consumer PE then forward through the rest of
        # the column ordered by distance (a vertical store-and-forward walk)
        for d in chain:
            flows.append(Flow(hop_from, d, per_src))
            hop_from = d
    return flows


def pair_flow_batch(placement: Placement, src_slot: int, dst_slot: int,
                    words_per_interval: float) -> FlowBatch:
    """Batched ``pair_flows``: same flows, same order, as a ``FlowBatch``."""
    src_a = placement.pes_of(src_slot)
    dst_a = placement.pes_of(dst_slot)
    if src_a.size == 0 or dst_a.size == 0:
        return FlowBatch.empty()
    # int32 distance matrix (coordinates are tiny, distances exact) — the
    # n_src x n_dst block is the planner's biggest single allocation, and
    # halving its width roughly halves this function's wall-clock; the
    # in-place += drops one further (n_src, n_dst) temporary.
    s32 = src_a.astype(np.int32)
    t32 = dst_a.astype(np.int32)
    d = np.abs(s32[:, None, 0] - t32[None, :, 0])
    d += np.abs(s32[:, None, 1] - t32[None, :, 1])
    nearest = np.argmin(d, axis=1)
    per_src = words_per_interval / len(src_a)
    return FlowBatch(src_a.astype(np.int64),
                     dst_a[nearest].astype(np.int64),
                     np.full(len(src_a), per_src, np.float64))


def multicast_flow_batch(placement: Placement, src_slot: int, dst_slot: int,
                         words_per_interval: float) -> FlowBatch:
    """Batched ``multicast_flows``: same chains, same order, as arrays.

    The scalar version's tie-breaks are replicated exactly: the nearest
    consumer column resolves ties toward the smaller column (first minimum)
    and each column chain is a *stable* sort of ascending rows by distance.
    """
    src = placement.pes_of(src_slot).astype(np.int64)   # row-major order
    dst = placement.pes_of(dst_slot).astype(np.int64)
    if src.size == 0 or dst.size == 0:
        return FlowBatch.empty()
    n_src = src.shape[0]
    per_src = words_per_interval / n_src
    cols_u, col_inv = np.unique(dst[:, 1], return_inverse=True)
    n_cols = cols_u.shape[0]
    # consumer rows per column as one padded matrix: a stable argsort of
    # the column labels keeps each column's rows in original (row-major)
    # order — the same order the boolean-mask gather produced — and the
    # sentinel (far larger than any grid row) makes padding slots sort
    # after every real row in the per-source distance argsort below.
    order = np.argsort(col_inv, kind="stable")
    rows_sorted = dst[order, 0]
    col_sizes = np.bincount(col_inv).astype(np.int64)   # (n_cols,)
    R = int(col_sizes.max())
    SENTINEL = np.int64(1) << 40
    rows_mat = np.full((n_cols, R), SENTINEL, np.int64)
    cidx, pos_in_col = _expand(col_sizes)
    rows_mat[cidx, pos_in_col] = rows_sorted
    # per-source nearest consumer column (first minimum = smaller column,
    # replicating the scalar min() tie-break) and its distance-ordered
    # chain; stable argsort keeps equal-distance rows in column order.
    col_idx = np.argmin(np.abs(cols_u[None, :] - src[:, 1:2]), axis=1)
    my_rows = rows_mat[col_idx]                         # (n_src, R)
    ordm = np.argsort(np.abs(my_rows - src[:, 0:1]), axis=1, kind="stable")
    chain_rows = np.take_along_axis(my_rows, ordm, axis=1)
    # scatter every chain hop into source-major order: hop t of source f
    # goes from hop t-1's consumer (the source PE itself for t = 0) to
    # chain position t — the vertical store-and-forward walk.
    chain_len = col_sizes[col_idx]
    fidx, t = _expand(chain_len)
    o_dr = chain_rows[fidx, t]
    o_dc = cols_u[col_idx][fidx]
    o_sr = np.where(t == 0, src[fidx, 0], chain_rows[fidx, np.maximum(t - 1, 0)])
    o_sc = np.where(t == 0, src[fidx, 1], o_dc)
    total = int(chain_len.sum())
    return FlowBatch(np.stack([o_sr, o_sc], axis=1),
                     np.stack([o_dr, o_dc], axis=1),
                     np.full(total, per_src, np.float64))


# ---------------------------------------------------------------------------
# Cross-component flow-batch cache
# ---------------------------------------------------------------------------
#
# The planner's cut-point DP, the event simulator and ``Planner.validate``
# all re-derive the *same* pair flow sets: a pair's flows are a pure
# function of (placement grid, src slot, dst slot, words, fine/multicast).
# ``cached_flow_batch`` memoizes them once per process so the three
# engines stop paying the generation cost (the shared hot allocation
# between planner.py and simulator.py).  Callers must treat the returned
# ``FlowBatch`` as immutable.


class LRUCache:
    """Minimal ordered-dict LRU with hit/miss statistics.

    Not a decorator (unlike ``functools.lru_cache``) so callers can key on
    derived signatures — e.g. a placement grid's bytes — instead of the
    raw arguments, and so the stats are inspectable by name from
    ``Planner.cache_info``.  Thread-safe like the facade's plan cache: a
    racing miss may generate the value twice (last insert wins), never a
    wrong answer.
    """

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            try:
                val = self._data[key]
            except KeyError:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return val

    def put(self, key, val) -> None:
        with self._lock:
            self._data[key] = val
            self._data.move_to_end(key)
            while len(self._data) > self.maxsize:
                self._data.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def info(self) -> Tuple[int, int, int, int]:
        """(hits, misses, maxsize, currsize)."""
        with self._lock:
            return (self.hits, self.misses, self.maxsize, len(self._data))

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = 0
            self.misses = 0


_FLOW_BATCH_CACHE = LRUCache(maxsize=8192)

#: coordinate-level sibling of ``_FLOW_BATCH_CACHE``: both generators give
#: every flow of a pair the SAME per-flow volume (``words / n_src``), so a
#: pair's (src, dst) arrays are independent of the word count.  Re-pricing
#: a placement pair with new words — the DP does it constantly — then
#: costs one ``np.full`` instead of a full chain/nearest regeneration.
_FLOW_COORD_CACHE = LRUCache(maxsize=8192)


def placement_key(placement: Placement) -> Tuple:
    """Hashable identity of a placement's flow-relevant content.

    The grid bytes subsume (org, pe_alloc, substrate shape): two
    placements with identical slot grids generate identical flows whatever
    produced them.  ``via_global_buffer`` is deliberately excluded — it
    gates *whether* flows enter the NoC, not what they are.
    """
    return (placement.org.value, placement.grid.shape,
            placement.grid.tobytes())


def cached_flow_batch(placement: Placement, src_slot: int, dst_slot: int,
                      words_per_interval: float, fine: bool) -> FlowBatch:
    """Memoized ``pair_flow_batch`` / ``multicast_flow_batch``.

    Exact-key caching (words included verbatim, no unit-scaling) so a hit
    is bit-identical to a regeneration — the differential parity contracts
    downstream rely on that.
    """
    pkey = placement_key(placement)
    key = (pkey, src_slot, dst_slot, float(words_per_interval), bool(fine))
    fb = _FLOW_BATCH_CACHE.get(key)
    if fb is None:
        ckey = (pkey, src_slot, dst_slot, bool(fine))
        coords = _FLOW_COORD_CACHE.get(ckey)
        if coords is None:
            gen = pair_flow_batch if fine else multicast_flow_batch
            fb = gen(placement, src_slot, dst_slot, words_per_interval)
            n_src = int(placement.pes_of(src_slot).shape[0])
            _FLOW_COORD_CACHE.put(ckey, (fb.src, fb.dst, n_src))
        else:
            src_a, dst_a, n_src = coords
            if n_src == 0:
                fb = FlowBatch.empty()
            else:
                # words / n_src is the exact expression both generators
                # evaluate, so the refill is bit-identical to regenerating
                fb = FlowBatch(src_a, dst_a,
                               np.full(src_a.shape[0],
                                       words_per_interval / n_src,
                                       np.float64))
        _FLOW_BATCH_CACHE.put(key, fb)
    return fb


def flow_batch_cache_info() -> Tuple[int, int, int, int]:
    return _FLOW_BATCH_CACHE.info()


def flow_batch_cache_clear() -> None:
    _FLOW_BATCH_CACHE.clear()
    _FLOW_COORD_CACHE.clear()


# ---------------------------------------------------------------------------
# Batched cross-candidate analysis: RouteIncidence + analyze_batch
# ---------------------------------------------------------------------------
#
# Routes are a pure function of flow *coordinates* — bytes only scale the
# per-link accumulation.  The planner's DP re-prices the same coordinate
# sets with different byte vectors constantly (every (cut, org, staging)
# candidate on the same grid), so ``analyze`` pays the expensive half
# (path expansion, port arbitration, link-code dedup) over and over.
# ``RouteIncidence`` precomputes that half once per coordinate set as
# CSR-style incidence arrays; ``analyze_batch`` then prices a whole
# frontier of flow sets in one segment-sum pass over the cached tables,
# bit-identical to per-set ``analyze`` calls (same step order, same
# per-bin accumulation order, same pairwise sums).


@dataclasses.dataclass
class RouteIncidence:
    """Words-independent half of ``analyze`` for one flow coordinate set.

    ``fidx[s]`` / ``inv[s]`` map expanded step ``s`` (flow-major, the
    scalar walk's (flow, hop) order) to its kept-flow index and compact
    link id; ``uniq[l]`` is link ``l``'s global code (``src_node * N +
    dst_node`` for wires, ``N*N + dst_node*4 + port`` for the adaptive
    last-hop ingress ports).  Valid for any byte vector that keeps the
    same flows ``analyze`` would keep — i.e. every coordinate-kept flow
    has positive words (``valid_for``); zero-word flows shift the
    flow-order port arbitration, so those batches fall back to
    ``analyze``.
    """
    rows: int
    cols: int
    topology: Topology
    express: int
    keep: np.ndarray        # bool [n_flows]: src != dst (coordinate keep)
    path_len: np.ndarray    # int64 [n_kept] hops per kept flow
    fidx: np.ndarray        # intp  [n_steps] kept-flow index per step
    inv: np.ndarray         # intp  [n_steps] compact link id per step
    wire: np.ndarray        # int64 [n_steps] physical wire length per step
    uniq: np.ndarray        # int64 [n_links] sorted global link codes
    max_path_hops: int
    link_count: int
    _link_keys: Optional[List[object]] = dataclasses.field(
        default=None, repr=False)

    @property
    def n_links(self) -> int:
        return int(self.uniq.shape[0])

    def valid_for(self, words: np.ndarray) -> bool:
        """True when this table prices ``words`` exactly (no kept flow
        would be dropped by ``analyze``'s ``words > 0`` filter)."""
        return bool(np.all(words[self.keep] > 0))

    def link_keys(self) -> List[object]:
        """Decoded link keys aligned with ``uniq`` — the same objects the
        scalar engines key their load maps on (``route()`` links, plus
        ``(dst, "in", port)`` ingress keys), lazily cached."""
        if self._link_keys is None:
            N = self.rows * self.cols
            cols = self.cols
            keys: List[object] = []
            for code in self.uniq.tolist():
                if code < N * N:
                    s, d = divmod(code, N)
                    keys.append(((s // cols, s % cols),
                                 (d // cols, d % cols)))
                else:
                    d, port = divmod(code - N * N, 4)
                    keys.append(((d // cols, d % cols), "in", port))
            self._link_keys = keys
        return self._link_keys


def _build_incidence(src: np.ndarray, dst: np.ndarray, rows: int, cols: int,
                     topology: Topology, express: int) -> RouteIncidence:
    """Expand one coordinate set's routes (``analyze`` phases 1-2, words
    stripped).  Step order, port arbitration and link codes replicate
    ``analyze`` exactly — the bit-parity contract every consumer rides."""
    link_count = topology_link_count(rows, cols, topology, express)
    sr0, sc0 = src[:, 0], src[:, 1]
    dr0, dc0 = dst[:, 0], dst[:, 1]
    keep = (sr0 != dr0) | (sc0 != dc0)
    sr, sc, dr, dc = sr0[keep], sc0[keep], dr0[keep], dc0[keep]
    n = int(sr.shape[0])
    if n == 0:
        z = np.zeros(0, np.int64)
        return RouteIncidence(rows, cols, topology, express, keep,
                              z, z, z, z, z, 0, link_count)

    N = rows * cols
    dstn = dr * cols + dc

    # adaptive last-hop arbitration: the k-th kept flow converging on a
    # consumer PE takes ingress port k mod 4 (stable group-cumcount)
    order = np.argsort(dstn, kind="stable")
    sorted_d = dstn[order]
    grp_start = np.flatnonzero(np.r_[True, sorted_d[1:] != sorted_d[:-1]])
    grp_sizes = np.diff(np.r_[grp_start, n])
    cum = np.arange(n) - np.repeat(grp_start, grp_sizes)
    port = np.empty(n, np.int64)
    port[order] = cum % 4

    phases = []  # (flow_idx, global_step, src_node, dst_node, wire_len)
    if topology == Topology.FLATTENED_BUTTERFLY:
        hasx = sc != dc
        hasy = sr != dr
        fx = np.flatnonzero(hasx)
        phases.append((fx, np.zeros(fx.size, np.int64),
                       sr[fx] * cols + sc[fx], sr[fx] * cols + dc[fx],
                       np.abs(dc[fx] - sc[fx])))
        fy = np.flatnonzero(hasy)
        phases.append((fy, hasx[fy].astype(np.int64),
                       sr[fy] * cols + dc[fy], dr[fy] * cols + dc[fy],
                       np.abs(dr[fy] - sr[fy])))
        path_len = hasx.astype(np.int64) + hasy.astype(np.int64)
    else:
        wrap = topology == Topology.TORUS
        dx = dc - sc
        dy = dr - sr
        if wrap:
            dx = np.where(np.abs(dx) > cols // 2, dx - cols * np.sign(dx), dx)
            dy = np.where(np.abs(dy) > rows // 2, dy - rows * np.sign(dy), dy)
        sx = np.where(dx >= 0, 1, -1)
        sy = np.where(dy >= 0, 1, -1)
        ax, ay = np.abs(dx), np.abs(dy)
        use_express = topology == Topology.AMP and express > 1
        ex = ax // express if use_express else np.zeros_like(ax)
        ey = ay // express if use_express else np.zeros_like(ay)
        ux, uy = ax - ex * express, ay - ey * express
        path_len = ex + ux + ey + uy

        def walk(counts, start, stride, fixed, along_cols, step_off, wlen,
                 size):
            fidx, t = _expand(counts)
            if fidx.size == 0:
                return None
            cur = start[fidx] + stride[fidx] * t
            nxt = cur + stride[fidx]
            if wrap:
                cur, nxt = cur % size, nxt % size
            if along_cols:
                s_node = fixed[fidx] * cols + cur
                d_node = fixed[fidx] * cols + nxt
            else:
                s_node = cur * cols + fixed[fidx]
                d_node = nxt * cols + fixed[fidx]
            return (fidx, step_off[fidx] + t, s_node, d_node,
                    np.full(fidx.size, wlen, np.int64))

        for ph in (walk(ex, sc, sx * express, sr, True,
                        np.zeros(n, np.int64), express, cols),
                   walk(ux, sc + sx * ex * express, sx, sr, True, ex, 1,
                        cols),
                   walk(ey, sr, sy * express, dc, False, ex + ux, express,
                        rows),
                   walk(uy, sr + sy * ey * express, sy, dc, False,
                        ex + ux + ey, 1, rows)):
            if ph is not None:
                phases.append(ph)

    total = int(path_len.sum())
    path_start = np.cumsum(path_len) - path_len
    srcn_all = np.empty(total, np.int64)
    dstn_all = np.empty(total, np.int64)
    wire_all = np.empty(total, np.int64)
    for fidx, step, s_node, d_node, wlen in phases:
        pos = path_start[fidx] + step
        srcn_all[pos] = s_node
        dstn_all[pos] = d_node
        wire_all[pos] = wlen
    fidx_all = np.repeat(np.arange(n), path_len)

    is_last = np.zeros(total, bool)
    is_last[path_start + path_len - 1] = True
    codes = np.where(is_last,
                     N * N + dstn[fidx_all] * 4 + port[fidx_all],
                     srcn_all * N + dstn_all)
    uniq, inv = np.unique(codes, return_inverse=True)
    return RouteIncidence(rows, cols, topology, express, keep, path_len,
                          fidx_all, inv.reshape(-1), wire_all, uniq,
                          int(path_len.max()), link_count)


def _build_incidence_batch(coords: Sequence[Tuple[np.ndarray, np.ndarray]],
                           rows: int, cols: int, topology: Topology,
                           express: int) -> List[RouteIncidence]:
    """Vectorized ``_build_incidence`` over MANY coordinate sets at once.

    A cold DP frontier misses hundreds of distinct coordinate sets whose
    individual builds are dominated by fixed numpy call overhead (~30
    array ops each on a few-thousand-step set).  Concatenating the sets
    with a set-id prefix runs the same ops once over the union:

      * port arbitration sorts on ``sid * N + dstn`` — a stable set-major
        key, so each set's group-cumcount is untouched by its neighbours;
      * the route walk and link codes are elementwise per flow;
      * one ``np.unique`` over ``sid * CODE_SPACE + code`` yields every
        set's sorted link table as a contiguous slice (the quotient is
        the set id, the remainder the in-set code — and within a set the
        combined order IS the code order).

    Each returned table is bit-identical to ``_build_incidence`` on its
    set, which the batch-vs-scalar parity tests pin.
    """
    nsets = len(coords)
    link_count = topology_link_count(rows, cols, topology, express)
    raw_counts = np.array([int(s.shape[0]) for s, _ in coords], np.int64)
    roff = np.cumsum(raw_counts) - raw_counts
    src = np.concatenate([s for s, _ in coords]) if nsets else \
        np.zeros((0, 2), np.int64)
    dst = np.concatenate([d for _, d in coords]) if nsets else \
        np.zeros((0, 2), np.int64)
    sr0, sc0 = src[:, 0], src[:, 1]
    dr0, dc0 = dst[:, 0], dst[:, 1]
    keep = (sr0 != dr0) | (sc0 != dc0)
    sid_raw = np.repeat(np.arange(nsets), raw_counts)
    sid = sid_raw[keep]
    sr, sc, dr, dc = sr0[keep], sc0[keep], dr0[keep], dc0[keep]
    n = int(sr.shape[0])
    kept_counts = np.bincount(sid, minlength=nsets).astype(np.int64)
    foff = np.cumsum(kept_counts) - kept_counts

    def _zero(s: int) -> RouteIncidence:
        z = np.zeros(0, np.int64)
        ks = keep[roff[s]:roff[s] + raw_counts[s]]
        return RouteIncidence(rows, cols, topology, express, ks,
                              z, z, z, z, z, 0, link_count)

    if n == 0:
        return [_zero(s) for s in range(nsets)]

    N = rows * cols
    dstn = dr * cols + dc

    # per-set adaptive last-hop arbitration (see _build_incidence)
    order = np.argsort(sid * N + dstn, kind="stable")
    sorted_k = (sid * N + dstn)[order]
    grp_start = np.flatnonzero(np.r_[True, sorted_k[1:] != sorted_k[:-1]])
    grp_sizes = np.diff(np.r_[grp_start, n])
    cum = np.arange(n) - np.repeat(grp_start, grp_sizes)
    port = np.empty(n, np.int64)
    port[order] = cum % 4

    phases = []
    if topology == Topology.FLATTENED_BUTTERFLY:
        hasx = sc != dc
        hasy = sr != dr
        fx = np.flatnonzero(hasx)
        phases.append((fx, np.zeros(fx.size, np.int64),
                       sr[fx] * cols + sc[fx], sr[fx] * cols + dc[fx],
                       np.abs(dc[fx] - sc[fx])))
        fy = np.flatnonzero(hasy)
        phases.append((fy, hasx[fy].astype(np.int64),
                       sr[fy] * cols + dc[fy], dr[fy] * cols + dc[fy],
                       np.abs(dr[fy] - sr[fy])))
        path_len = hasx.astype(np.int64) + hasy.astype(np.int64)
    else:
        wrap = topology == Topology.TORUS
        dx = dc - sc
        dy = dr - sr
        if wrap:
            dx = np.where(np.abs(dx) > cols // 2, dx - cols * np.sign(dx), dx)
            dy = np.where(np.abs(dy) > rows // 2, dy - rows * np.sign(dy), dy)
        sx = np.where(dx >= 0, 1, -1)
        sy = np.where(dy >= 0, 1, -1)
        ax, ay = np.abs(dx), np.abs(dy)
        use_express = topology == Topology.AMP and express > 1
        ex = ax // express if use_express else np.zeros_like(ax)
        ey = ay // express if use_express else np.zeros_like(ay)
        ux, uy = ax - ex * express, ay - ey * express
        path_len = ex + ux + ey + uy

        def walk(counts, start, stride, fixed, along_cols, step_off, wlen,
                 size):
            fidx, t = _expand(counts)
            if fidx.size == 0:
                return None
            cur = start[fidx] + stride[fidx] * t
            nxt = cur + stride[fidx]
            if wrap:
                cur, nxt = cur % size, nxt % size
            if along_cols:
                s_node = fixed[fidx] * cols + cur
                d_node = fixed[fidx] * cols + nxt
            else:
                s_node = cur * cols + fixed[fidx]
                d_node = nxt * cols + fixed[fidx]
            return (fidx, step_off[fidx] + t, s_node, d_node,
                    np.full(fidx.size, wlen, np.int64))

        for ph in (walk(ex, sc, sx * express, sr, True,
                        np.zeros(n, np.int64), express, cols),
                   walk(ux, sc + sx * ex * express, sx, sr, True, ex, 1,
                        cols),
                   walk(ey, sr, sy * express, dc, False, ex + ux, express,
                        rows),
                   walk(uy, sr + sy * ey * express, sy, dc, False,
                        ex + ux + ey, 1, rows)):
            if ph is not None:
                phases.append(ph)

    total = int(path_len.sum())
    path_start = np.cumsum(path_len) - path_len
    srcn_all = np.empty(total, np.int64)
    dstn_all = np.empty(total, np.int64)
    wire_all = np.empty(total, np.int64)
    for fidx, step, s_node, d_node, wlen in phases:
        pos = path_start[fidx] + step
        srcn_all[pos] = s_node
        dstn_all[pos] = d_node
        wire_all[pos] = wlen
    fidx_all = np.repeat(np.arange(n), path_len)

    is_last = np.zeros(total, bool)
    is_last[path_start + path_len - 1] = True
    codes = np.where(is_last,
                     N * N + dstn[fidx_all] * 4 + port[fidx_all],
                     srcn_all * N + dstn_all)
    code_space = N * N + 4 * N
    uniq_c, inv_c = np.unique(sid[fidx_all] * code_space + codes,
                              return_inverse=True)
    inv_c = inv_c.reshape(-1)
    bounds = np.searchsorted(uniq_c // code_space, np.arange(nsets + 1))
    uniq_local = uniq_c % code_space
    step_tot = np.zeros(nsets, np.int64)
    np.add.at(step_tot, sid, path_len)
    soff = np.cumsum(step_tot) - step_tot

    out: List[RouteIncidence] = []
    for s in range(nsets):
        ns = int(kept_counts[s])
        if ns == 0:
            out.append(_zero(s))
            continue
        f0, s0, s1 = foff[s], soff[s], soff[s] + step_tot[s]
        pl = path_len[f0:f0 + ns]
        out.append(RouteIncidence(
            rows, cols, topology, express,
            keep[roff[s]:roff[s] + raw_counts[s]], pl,
            fidx_all[s0:s1] - f0, inv_c[s0:s1] - bounds[s],
            wire_all[s0:s1], uniq_local[bounds[s]:bounds[s + 1]],
            int(pl.max()), link_count))
    return out


_ROUTE_INCIDENCE_CACHE = LRUCache(maxsize=4096)


def route_incidence(fb: FlowBatch, hw: HWConfig, topology: Topology,
                    token: Optional[Tuple] = None) -> RouteIncidence:
    """Memoized incidence table for a flow batch's coordinate set.

    Keyed on (grid shape, topology, express, coordinate digest) — the
    byte vector is deliberately excluded, which is the whole point: every
    candidate re-pricing the same placement pair hits one table.

    ``token``: an optional hashable identity the *caller* guarantees
    determines the coordinate set (e.g. the planner's (placement key,
    slot, skip pairs) tuple).  When given, a warm lookup skips hashing
    the coordinate arrays entirely — the digest is the dominant per-call
    cost once tables are warm.  A token miss falls through to the
    content-addressed entry and ALIASES it (two dict entries, one shared
    table), so distinct tokens over identical coordinates — overlapping
    DP spans, re-planned orgs — never build the table twice.
    """
    express = hw.amp_link_len if topology == Topology.AMP else 1
    tkey = None
    if token is not None:
        tkey = (hw.pe_rows, hw.pe_cols, topology.value, express,
                "tok", token)
        inc = _ROUTE_INCIDENCE_CACHE.get(tkey)
        if inc is not None:
            return inc
    src = np.ascontiguousarray(fb.src, np.int64)
    dst = np.ascontiguousarray(fb.dst, np.int64)
    digest = hashlib.blake2b(src.tobytes() + dst.tobytes(),
                             digest_size=16).digest()
    key = (hw.pe_rows, hw.pe_cols, topology.value, express,
           int(src.shape[0]), digest)
    inc = _ROUTE_INCIDENCE_CACHE.get(key)
    if inc is None:
        inc = _build_incidence(src, dst, hw.pe_rows, hw.pe_cols, topology,
                               express)
        _ROUTE_INCIDENCE_CACHE.put(key, inc)
    if tkey is not None:
        _ROUTE_INCIDENCE_CACHE.put(tkey, inc)
    return inc


def route_incidence_cache_info() -> Tuple[int, int, int, int]:
    return _ROUTE_INCIDENCE_CACHE.info()


def route_incidence_cache_clear() -> None:
    _ROUTE_INCIDENCE_CACHE.clear()


def _incidence_stats(inc: RouteIncidence, w_kept: np.ndarray,
                     topology: Topology) -> TrafficStats:
    """Price one byte vector over a prebuilt incidence (phase 2)."""
    if inc.path_len.shape[0] == 0:
        return TrafficStats(topology, 0.0, 0.0, 0.0, 0, 0, inc.link_count)
    words_l = w_kept[inc.fidx]
    loads = np.bincount(inc.inv, weights=words_l, minlength=inc.n_links)
    return TrafficStats(
        topology=topology,
        worst_channel_load=float(loads.max()),
        total_hop_words=float(np.sum(w_kept * inc.path_len)),
        total_wire_words=float(np.sum(words_l * inc.wire)),
        max_path_hops=inc.max_path_hops,
        num_links_used=inc.n_links,
        link_count=inc.link_count,
    )


def analyze_cached(flows, hw: HWConfig, topology: Topology) -> TrafficStats:
    """Incidence-cached ``analyze``: bit-identical results, route
    expansion amortized across every byte vector on the same coordinates."""
    fb = flows if isinstance(flows, FlowBatch) else FlowBatch.from_flows(flows)
    inc = route_incidence(fb, hw, topology)
    w = fb.words.astype(np.float64)
    if not inc.valid_for(w):
        return analyze(fb, hw, topology)
    return _incidence_stats(inc, w[inc.keep], topology)


def analyze_batch(batches: Sequence, hw: HWConfig, topology: Topology,
                  tokens: Optional[Sequence[Optional[Tuple]]] = None
                  ) -> List[TrafficStats]:
    """Price a whole frontier of flow sets in one vectorized pass.

    Equivalent to ``[analyze(fb, hw, topology) for fb in batches]`` —
    bit-identical, gated by the parity suites — but the per-set route
    expansion comes from the shared ``RouteIncidence`` cache and the
    per-link accumulation of every set runs as a single ``np.bincount``
    over offset link ids (per-set code blocks are disjoint, so each
    link's float accumulation order is unchanged).  Sets with zero-word
    flows (which shift port arbitration) fall back to plain ``analyze``.

    ``tokens`` optionally provides one ``route_incidence`` cache token per
    batch (None entries fall back to the content digest).
    """
    express = hw.amp_link_len if topology == Topology.AMP else 1
    link_count = topology_link_count(hw.pe_rows, hw.pe_cols, topology,
                                     express)
    base = (hw.pe_rows, hw.pe_cols, topology.value, express)
    fbs = [flows if isinstance(flows, FlowBatch)
           else FlowBatch.from_flows(flows) for flows in batches]

    # resolve every batch's incidence table: token hit -> digest hit ->
    # batch-build ALL misses in one vectorized _build_incidence_batch pass
    # (deduped by content digest, so identical coordinate sets appearing
    # under several tokens share one table)
    incs: List[Optional[RouteIncidence]] = [None] * len(fbs)
    waiting: dict = {}          # digest key -> [(batch idx, token key)]
    build_keys: List[Tuple] = []
    build_coords: List[Tuple[np.ndarray, np.ndarray]] = []
    for b, fb in enumerate(fbs):
        token = tokens[b] if tokens is not None else None
        tkey = base + ("tok", token) if token is not None else None
        if tkey is not None:
            inc = _ROUTE_INCIDENCE_CACHE.get(tkey)
            if inc is not None:
                incs[b] = inc
                continue
        src = np.ascontiguousarray(fb.src, np.int64)
        dst = np.ascontiguousarray(fb.dst, np.int64)
        digest = hashlib.blake2b(src.tobytes() + dst.tobytes(),
                                 digest_size=16).digest()
        key = base + (int(src.shape[0]), digest)
        inc = _ROUTE_INCIDENCE_CACHE.get(key)
        if inc is not None:
            incs[b] = inc
            if tkey is not None:
                _ROUTE_INCIDENCE_CACHE.put(tkey, inc)
            continue
        ent = waiting.get(key)
        if ent is None:
            waiting[key] = [(b, tkey)]
            build_keys.append(key)
            build_coords.append((src, dst))
        else:
            ent.append((b, tkey))
    if build_coords:
        for key, inc in zip(build_keys,
                            _build_incidence_batch(
                                build_coords, hw.pe_rows, hw.pe_cols,
                                topology, express)):
            _ROUTE_INCIDENCE_CACHE.put(key, inc)
            for b, tkey in waiting[key]:
                incs[b] = inc
                if tkey is not None:
                    _ROUTE_INCIDENCE_CACHE.put(tkey, inc)

    out: List[Optional[TrafficStats]] = [None] * len(batches)
    vec: List[Tuple[int, RouteIncidence, np.ndarray]] = []
    for b, fb in enumerate(fbs):
        inc = incs[b]
        w = fb.words.astype(np.float64)
        if not inc.valid_for(w):
            out[b] = analyze(fb, hw, topology)
        elif inc.path_len.shape[0] == 0:
            out[b] = TrafficStats(topology, 0.0, 0.0, 0.0, 0, 0, link_count)
        else:
            vec.append((b, inc, w[inc.keep]))
    if not vec:
        return out  # type: ignore[return-value]

    nlinks = np.array([inc.n_links for _, inc, _ in vec], np.int64)
    off = np.cumsum(nlinks) - nlinks
    per_words = [w_kept[inc.fidx] for _, inc, w_kept in vec]
    codes_all = np.concatenate([inc.inv.astype(np.int64) + o
                                for (_, inc, _), o in zip(vec, off)])
    loads = np.bincount(codes_all, weights=np.concatenate(per_words),
                        minlength=int(nlinks.sum()))
    worsts = np.maximum.reduceat(loads, off)
    for (b, inc, w_kept), words_l, worst in zip(vec, per_words, worsts):
        out[b] = TrafficStats(
            topology=topology,
            worst_channel_load=float(worst),
            total_hop_words=float(np.sum(w_kept * inc.path_len)),
            total_wire_words=float(np.sum(words_l * inc.wire)),
            max_path_hops=inc.max_path_hops,
            num_links_used=inc.n_links,
            link_count=inc.link_count,
        )
    return out  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Join-aware flows (branch-parallel segments)
# ---------------------------------------------------------------------------


def join_flow_batch(placement: Placement, src_slots: Sequence[int],
                    dst_slot: int, words_each: Sequence[float],
                    fine: bool) -> FlowBatch:
    """Converging flows: several producer regions feeding one consumer.

    A branch-parallel segment's join (the ADD/CONCAT op) absorbs every
    branch tail *in the same pipeline interval*, so its ingress contention
    is a property of the union of the per-edge flow sets: concatenating
    the batches in producer order and analyzing them as one keeps the
    4-ingress-port arbitration shared across all converging producers —
    the scalar walk and ``analyze`` assign ports in flow order, so the
    union models two tails racing for the join region's ports where
    per-edge analysis would give each tail its own private ports.
    """
    return FlowBatch.concat([
        cached_flow_batch(placement, s, dst_slot, w, fine)
        for s, w in zip(src_slots, words_each)])


# ---------------------------------------------------------------------------
# Cross-tenant flows (multi-tenant substrate partitions)
# ---------------------------------------------------------------------------


def offset_flow_batch(fb: FlowBatch, drow: int = 0, dcol: int = 0
                      ) -> FlowBatch:
    """Translate a flow set into another coordinate frame.

    A tenant planned on a column band carries band-local placements; its
    flows must be shifted by the band origin before they share a link
    map with co-resident tenants on the full substrate.
    """
    if not len(fb) or (drow == 0 and dcol == 0):
        return fb
    shift = np.array([drow, dcol], np.int64)
    return FlowBatch(fb.src + shift, fb.dst + shift, fb.words.copy())


def union_flow_batch(batches: Sequence[FlowBatch]) -> FlowBatch:
    """The union of several flow sets sharing one substrate.

    The cross-tenant generalization of ``join_flow_batch``: concatenating
    the batches in tenant order keeps link loads accumulated on one map
    and the 4-ingress-port arbitration assigned in flow order across
    every co-resident producer, exactly as the join case shares ports
    across converging branch tails.
    """
    return FlowBatch.concat(list(batches))


def interference_channel_load(own: FlowBatch,
                              others: Sequence[FlowBatch],
                              hw: HWConfig, topology: Topology
                              ) -> Tuple[float, float]:
    """Worst per-interval load over the links ``own`` traffic uses.

    Returns ``(solo, shared)``: the hottest of own's links counting only
    own flows, and counting every co-resident flow set accumulated onto
    the same link-load map (``others`` walk first, matching
    ``union_flow_batch`` order, so ingress-port arbitration is shared).
    ``shared - solo`` is the interference price a co-resident tenant
    pays on its hottest shared channel; it is exactly zero when the
    tenants' routes are link-disjoint (e.g. column bands under
    dimension-ordered routing with no overlapping columns).

    Runs on the shared ``RouteIncidence`` table (the union batch's steps
    keep others-then-own order, so per-link accumulation and the scalar
    subtraction come out bit-identical to the reference walk below);
    zero-word flows fall back to the scalar engine.
    """
    if not len(own):
        return 0.0, 0.0
    union = FlowBatch.concat([*others, own])
    inc = route_incidence(union, hw, topology)
    w = union.words.astype(np.float64)
    if not inc.valid_for(w):
        return interference_channel_load_reference(own, others, hw, topology)
    if inc.path_len.shape[0] == 0:
        return 0.0, 0.0
    n_other = len(union) - len(own)
    w_kept = w[inc.keep]
    words_l = w_kept[inc.fidx]
    # own's steps are exactly the tail kept-flow indices
    n_other_kept = int(np.count_nonzero(inc.keep[:n_other]))
    own_step = inc.fidx >= n_other_kept
    if not np.any(own_step):
        return 0.0, 0.0
    loads = np.bincount(inc.inv, weights=words_l, minlength=inc.n_links)
    base = np.bincount(inc.inv[~own_step], weights=words_l[~own_step],
                       minlength=inc.n_links)
    own_links = np.unique(inc.inv[own_step])
    shared = float(loads[own_links].max())
    solo = float((loads[own_links] - base[own_links]).max())
    return solo, shared


def interference_channel_load_reference(own: FlowBatch,
                                        others: Sequence[FlowBatch],
                                        hw: HWConfig, topology: Topology
                                        ) -> Tuple[float, float]:
    """Scalar reference walk for ``interference_channel_load`` (also the
    fallback for batches the incidence table cannot price exactly)."""
    if not len(own):
        return 0.0, 0.0
    rows, cols = hw.pe_rows, hw.pe_cols
    express = hw.amp_link_len if topology == Topology.AMP else 1
    load: Dict[object, float] = defaultdict(float)
    ingress_port: Dict[Coord, int] = defaultdict(int)
    own_keys: set = set()

    def walk(fb: FlowBatch, mine: bool) -> None:
        for s, d, w in zip(fb.src, fb.dst, fb.words):
            src = (int(s[0]), int(s[1]))
            dst = (int(d[0]), int(d[1]))
            w = float(w)
            if w <= 0 or src == dst:
                continue
            path = route(src, dst, rows, cols, topology, express)
            for i, link in enumerate(path):
                key: object = link
                if i == len(path) - 1:
                    port = ingress_port[dst] % 4
                    ingress_port[dst] += 1
                    key = (dst, "in", port)
                load[key] += w
                if mine:
                    own_keys.add(key)

    for fb in others:
        walk(fb, mine=False)
    shared_base = dict(load)
    walk(own, mine=True)
    shared = max((load[k] for k in own_keys), default=0.0)
    solo = max((load[k] - shared_base.get(k, 0.0) for k in own_keys),
               default=0.0)
    return solo, shared


def segment_flows(placement: Placement,
                  interval_words: Sequence[float],
                  skip_pairs: Iterable[Tuple[int, int, float]] = ()
                  ) -> List[Flow]:
    """All flows of a pipeline segment.

    interval_words[i]: words/interval from slot i to slot i+1.
    skip_pairs: (src_slot, dst_slot, words/interval) for skip connections.
    """
    flows: List[Flow] = []
    for i, w in enumerate(interval_words):
        flows.extend(pair_flows(placement, i, i + 1, w))
    for s, t, w in skip_pairs:
        flows.extend(pair_flows(placement, s, t, w))
    return flows
