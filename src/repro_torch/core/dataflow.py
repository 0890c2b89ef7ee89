"""Stage-1: intra-operator dataflow (loop-order) selection — Sec. IV-A.

"In case of larger weights, we use weight stationary dataflow, where ranks
from weights form the outermost loop ... for the activation-heavy layers we
choose the activation stationary dataflow.  Depending on how large the
activation is compared to the weight we decide whether to make the dataflow
completely activation stationary (e.g. NHWKCRS) or we allow some reuse on
weights (e.g. NHKCWRS)."

A ``Dataflow`` is a loop order (outermost-first rank tuple) plus per-rank
tile sizes.  Tiles default to the full extent except the ranks we tile to
fit the on-chip buffer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from .graph import Op, OpKind
from .hwconfig import HWConfig


@dataclasses.dataclass(frozen=True)
class Dataflow:
    op_name: str
    loop_order: Tuple[str, ...]      # outermost first
    tiles: Dict[str, int]            # tile size per rank (<= extent)
    stationary: str                  # 'weight' | 'activation' | 'mixed' | 'output'

    def tile(self, rank: str) -> int:
        return self.tiles.get(rank, 1)


# thresholds on A/W separating the three regimes (log-scale midpoints of the
# XR-bench span in Fig. 5)
_WEIGHT_HEAVY_BELOW = 0.3
_ACT_HEAVY_ABOVE = 30.0


#: identity-keyed memo: ``Op`` carries a dims dict (unhashable), but ops are
#: long-lived graph nodes and the planner's overlapping DP spans re-derive
#: the same (op, budget) dataflow thousands of times per plan.  Values keep
#: a strong ref to the op so id() can never be recycled under the key.
_DF_CACHE: Dict[Tuple[int, HWConfig, Optional[int]],
                Tuple[Op, Dataflow]] = {}
_DF_CACHE_MAX = 65536


def choose_dataflow(op: Op, hw: HWConfig,
                    sram_budget: Optional[int] = None) -> Dataflow:
    """Pick a loop order from the op's A/W ratio (paper heuristic).

    ``sram_budget``: bytes of on-chip buffer available to THIS op's tiles
    (the whole SRAM when running layer-by-layer, SRAM/depth inside a
    pipeline segment — Sec. III-A: deeper pipelines shrink the tile space).

    Pure in its arguments; results are memoized by op identity, so the
    returned ``Dataflow`` (and its ``tiles`` dict) must be treated as
    immutable by callers.
    """
    key = (id(op), hw, sram_budget)
    hit = _DF_CACHE.get(key)
    if hit is not None and hit[0] is op:
        return hit[1]
    df = _choose_dataflow(op, hw, sram_budget)
    if len(_DF_CACHE) >= _DF_CACHE_MAX:
        _DF_CACHE.clear()
    _DF_CACHE[key] = (op, df)
    return df


def _choose_dataflow(op: Op, hw: HWConfig,
                     sram_budget: Optional[int]) -> Dataflow:
    ratio = op.aw_ratio()
    budget_bytes = hw.sram_bytes if sram_budget is None else max(1, sram_budget)
    d = op.dims
    if op.kind in (OpKind.CONV, OpKind.DWCONV):
        ranks_w = ("K", "C", "R", "S") if op.kind == OpKind.CONV else ("C", "R", "S")
        if ratio < _WEIGHT_HEAVY_BELOW:
            # weight stationary: weight ranks outermost
            order = ranks_w + ("N", "H", "W")
            stat = "weight"
        elif ratio > _ACT_HEAVY_ABOVE:
            # fully activation stationary: NHWKCRS
            order = (("N", "H", "W", "K", "C", "R", "S")
                     if op.kind == OpKind.CONV else ("N", "H", "W", "C", "R", "S"))
            stat = "activation"
        else:
            # mixed: some weight reuse (NHKCWRS)
            order = (("N", "H", "K", "C", "W", "R", "S")
                     if op.kind == OpKind.CONV else ("N", "H", "C", "W", "R", "S"))
            stat = "mixed"
        tiles = _conv_tiles(op, order, hw, budget_bytes)
        return Dataflow(op.name, order, tiles, stat)

    if op.kind == OpKind.GEMM:
        if ratio < _WEIGHT_HEAVY_BELOW:
            order = ("N", "K", "M")       # weight (B[k,n]) stationary
            stat = "weight"
        elif ratio > _ACT_HEAVY_ABOVE:
            order = ("M", "N", "K")       # activation/output stationary
            stat = "activation"
        else:
            order = ("M", "K", "N")
            stat = "mixed"
        tiles = _gemm_tiles(op, order, hw, budget_bytes)
        return Dataflow(op.name, order, tiles, stat)

    # weightless ops stream in production order and are tile-flexible
    order = op.output_ranks()
    tiles = {r: d.get(r, 1) for r in order}
    return Dataflow(op.name, order, tiles, "activation")


def _conv_tiles(op: Op, order: Tuple[str, ...], hw: HWConfig,
                budget_bytes: int) -> Dict[str, int]:
    d = op.dims
    tiles = {r: 1 for r in order}
    # innermost ranks get full extent; walk inner->outer growing the tile
    # until the working set no longer fits in the buffer share.
    budget = budget_bytes // hw.bytes_per_word
    for r in reversed(order):
        extent = d.get(r, 1)
        tiles[r] = extent
        if _conv_working_set(op, tiles) > budget:
            # shrink back to largest power-of-two tile that fits
            t = extent
            while t > 1 and _conv_working_set(op, {**tiles, r: t}) > budget:
                t //= 2
            tiles[r] = max(1, t)
            break
    return tiles


def _conv_working_set(op: Op, tiles: Dict[str, int]) -> int:
    g = lambda r: tiles.get(r, 1)
    if op.kind == OpKind.CONV:
        w = g("R") * g("S") * g("C") * g("K")
        i = g("N") * (g("H") + g("R") - 1) * (g("W") + g("S") - 1) * g("C")
        o = g("N") * g("H") * g("W") * g("K")
    else:
        w = g("R") * g("S") * g("C")
        i = g("N") * (g("H") + g("R") - 1) * (g("W") + g("S") - 1) * g("C")
        o = g("N") * g("H") * g("W") * g("C")
    return w + i + o


def _gemm_tiles(op: Op, order: Tuple[str, ...], hw: HWConfig,
                budget_bytes: int) -> Dict[str, int]:
    d = op.dims
    tiles = {r: 1 for r in order}
    budget = budget_bytes // hw.bytes_per_word
    for r in reversed(order):
        extent = d.get(r, 1)
        tiles[r] = extent
        ws = (tiles["M"] * tiles["K"] + tiles["K"] * tiles["N"]
              + tiles["M"] * tiles["N"])
        if ws > budget:
            t = extent
            while t > 1:
                t //= 2
                tiles[r] = t
                ws = (tiles["M"] * tiles["K"] + tiles["K"] * tiles["N"]
                      + tiles["M"] * tiles["N"])
                if ws <= budget:
                    break
            tiles[r] = max(1, tiles[r])
            break
    return tiles


def best_case_arithmetic_intensity(op: Op, hw: HWConfig) -> float:
    """AI with only cold misses (footnote 3): MACs / unique bytes touched."""
    bytes_touched = (op.weight_volume() + op.input_volume()
                     + op.output_volume()) * hw.bytes_per_word
    if bytes_touched == 0:
        return float("inf")
    return op.macs() / bytes_touched


def achieved_arithmetic_intensity(op: Op, df: Dataflow, hw: HWConfig) -> float:
    """AI achieved by the chosen tiling: MACs / DRAM bytes moved.

    DRAM traffic model: each tensor is re-fetched once per iteration of the
    loops *above* the outermost rank of that tensor that is tiled at full
    extent (classic tiled-loop-nest reuse analysis).
    """
    d = op.dims
    refetch = _refetch_factors(op, df)
    w_traffic = op.weight_volume() * refetch["w"]
    i_traffic = op.input_volume() * refetch["i"]
    o_traffic = op.output_volume() * max(1.0, refetch["o"])
    total = (w_traffic + i_traffic + o_traffic) * hw.bytes_per_word
    if total == 0:
        return float("inf")
    return op.macs() / total


def _refetch_factors(op: Op, df: Dataflow) -> Dict[str, float]:
    """# of times each tensor streams from DRAM under the loop order."""
    d = op.dims
    if op.kind == OpKind.GEMM:
        rank_tensors = {"M": {"i", "o"}, "N": {"w", "o"}, "K": {"i", "w"}}
    elif op.kind == OpKind.CONV:
        rank_tensors = {"N": {"i", "o"}, "H": {"i", "o"}, "W": {"i", "o"},
                        "K": {"w", "o"}, "C": {"i", "w"},
                        "R": {"w"}, "S": {"w"}}
    elif op.kind == OpKind.DWCONV:
        rank_tensors = {"N": {"i", "o"}, "H": {"i", "o"}, "W": {"i", "o"},
                        "C": {"i", "w", "o"}, "R": {"w"}, "S": {"w"}}
    else:
        return {"w": 0.0, "i": 1.0, "o": 1.0}
    out = {}
    for t in ("w", "i", "o"):
        factor = 1.0
        for r in df.loop_order:
            extent = d.get(r, 1)
            trips = max(1, math.ceil(extent / max(1, df.tiles.get(r, extent))))
            if t not in rank_tensors.get(r, set()):
                # loop r re-iterates over tensor t -> refetch unless the
                # remaining working set below r is buffered; conservatively
                # count trips of irrelevant loops *above* the tensor's loops.
                factor *= trips
            else:
                break
        out[t] = factor
    return out
