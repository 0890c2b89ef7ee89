"""Stage-2: spatial organization strategies — Sec. IV-B and Fig. 2.

A spatial organization assigns every PE of the array to one layer of the
pipeline segment.  The paper's class of strategies:

  * BLOCKED_1D      — contiguous row-bands per layer (prior work default)
  * BLOCKED_2D      — contiguous rectangular quadrants (depth >= 4)
  * FINE_STRIPED_1D — row-interleaved stripes (producer/consumer co-located)
  * CHECKERBOARD_2D — PE-granular 2-D interleaving (finest)

Selection rule (Sec. IV-B):
  if RF_total(producer) < granularity: move through the Global Buffer,
  always BLOCKED.  Otherwise the finer the granularity relative to the
  per-PE RF, the finer the interleaving; 1-D vs 2-D by segment depth.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .hwconfig import HWConfig


class SpatialOrg(enum.Enum):
    BLOCKED_1D = "blocked_1d"
    BLOCKED_2D = "blocked_2d"
    FINE_STRIPED_1D = "fine_striped_1d"
    CHECKERBOARD_2D = "checkerboard_2d"


@dataclasses.dataclass(frozen=True)
class Placement:
    """grid[r, c] = layer slot (0..depth-1) owning PE (r, c)."""
    org: SpatialOrg
    grid: np.ndarray          # int32 [rows, cols]
    via_global_buffer: bool   # coarse pipelining moves data through the GB

    @property
    def depth(self) -> int:
        return int(self.grid.max()) + 1

    def pes_of(self, slot: int) -> np.ndarray:
        """[(row, col)] coordinates owned by a layer slot.

        Memoized per instance (the grid is immutable once placed); the
        returned array is shared and marked read-only — callers copy
        before mutating.
        """
        memo = self.__dict__.get("_pes_memo")
        if memo is None:
            memo = {}
            object.__setattr__(self, "_pes_memo", memo)
        arr = memo.get(slot)
        if arr is None:
            arr = np.argwhere(self.grid == slot)
            arr.setflags(write=False)
            memo[slot] = arr
        return arr


def allocate_pes(mac_ratios: Sequence[float], num_units: int) -> List[int]:
    """Split ``num_units`` PEs across layers proportional to MACs.

    Largest-remainder apportionment; every layer gets >= 1 unit.
    """
    n = len(mac_ratios)
    if n > num_units:
        raise ValueError(f"more layers ({n}) than PEs ({num_units})")
    total = float(sum(mac_ratios)) or 1.0
    raw = [r / total * num_units for r in mac_ratios]
    alloc = [max(1, int(x)) for x in raw]
    # fix the sum: shave the biggest overshoot (only decrementable slots),
    # then top up the biggest remainders
    while sum(alloc) > num_units:
        cands = [j for j in range(n) if alloc[j] > 1]
        i = max(cands, key=lambda j: (alloc[j] - raw[j], alloc[j]))
        alloc[i] -= 1
    order = sorted(range(n), key=lambda i: raw[i] - alloc[i], reverse=True)
    k = 0
    while sum(alloc) < num_units:
        alloc[order[k % n]] += 1
        k += 1
    return alloc


def _units_to_rows(alloc_pes: Sequence[int], rows: int, cols: int) -> List[int]:
    """Convert PE counts to whole-row counts (for 1-D organizations)."""
    n = len(alloc_pes)
    raw = [a / cols for a in alloc_pes]
    r = [max(1, round(x)) for x in raw]
    while sum(r) > rows:
        cands = [j for j in range(n) if r[j] > 1]
        if not cands:
            raise ValueError("depth exceeds row count")
        i = max(cands, key=lambda j: (r[j] - raw[j], r[j]))
        r[i] -= 1
    while sum(r) < rows:
        i = min(range(n), key=lambda j: (r[j] - raw[j], -raw[j]))
        r[i] += 1
    return r


def place(org: SpatialOrg, mac_ratios: Sequence[float], hw: HWConfig,
          via_global_buffer: bool = False) -> Placement:
    rows, cols = hw.pe_rows, hw.pe_cols
    depth = len(mac_ratios)
    grid = np.zeros((rows, cols), dtype=np.int32)

    if org == SpatialOrg.BLOCKED_1D:
        r_alloc = _units_to_rows(allocate_pes(mac_ratios, rows * cols),
                                 rows, cols)
        r0 = 0
        for slot, nr in enumerate(r_alloc):
            grid[r0:r0 + nr, :] = slot
            r0 += nr

    elif org == SpatialOrg.FINE_STRIPED_1D:
        r_alloc = _units_to_rows(allocate_pes(mac_ratios, rows * cols),
                                 rows, cols)
        # interleave rows round-robin in proportion: build the smallest
        # repeating pattern then tile it down the array.
        g = math.gcd(*r_alloc) if depth > 1 else r_alloc[0]
        pattern: List[int] = []
        unit = [a // g for a in r_alloc]
        for _ in range(g):
            for slot, u in enumerate(unit):
                pattern.extend([slot] * u)
        for r in range(rows):
            grid[r, :] = pattern[r % len(pattern)]

    elif org == SpatialOrg.BLOCKED_2D:
        # rectangular tiling: split rows into bands of ~sqrt(depth) and
        # columns within each band, snake-ordered so consecutive slots abut.
        brows = max(1, int(math.isqrt(depth)))
        bcols = math.ceil(depth / brows)
        rb = rows // brows
        cb = cols // bcols
        slot = 0
        for b in range(brows):
            cols_iter = range(bcols) if b % 2 == 0 else range(bcols - 1, -1, -1)
            for c in cols_iter:
                if slot >= depth:
                    break
                r_end = rows if b == brows - 1 else (b + 1) * rb
                c_end = cols if c == bcols - 1 else (c + 1) * cb
                grid[b * rb:r_end, c * cb:c_end] = slot
                slot += 1
        # any PEs left at default 0 in incomplete tiling are fine (slot 0)

    elif org == SpatialOrg.CHECKERBOARD_2D:
        # PE-granular 2-D interleave: slot = (r + c) mod depth scaled by
        # MAC ratios via repetition counts.
        alloc = np.asarray(allocate_pes(mac_ratios, rows * cols), np.int64)
        # lay slots down a space-filling (boustrophedon) order so equal-count
        # slots form a checkerboard-like interleave.  The round-robin
        # emission order — round t emits every slot with alloc > t, slots
        # ascending within a round — is exactly a stable sort of the
        # (round, slot) pairs, so the whole sequence builds in numpy.
        slots = np.repeat(np.arange(depth, dtype=np.int64), alloc)
        rnd = (np.arange(rows * cols, dtype=np.int64)
               - np.repeat(np.cumsum(alloc) - alloc, alloc))
        order = np.argsort(rnd * depth + slots, kind="stable")
        grid = slots[order].astype(np.int32).reshape(rows, cols)
        grid[1::2, :] = grid[1::2, ::-1].copy()    # boustrophedon rows
    else:
        raise ValueError(org)

    return Placement(org, grid, via_global_buffer)


def _band_rows(work: Sequence[float], rows: int) -> List[int]:
    """Whole-row allocation proportional to work, every entry >= 1."""
    n = len(work)
    if n > rows:
        raise ValueError(f"{n} slots need more than {rows} rows")
    total = float(sum(work)) or 1.0
    raw = [w / total * rows for w in work]
    r = [max(1, round(x)) for x in raw]
    while sum(r) > rows:
        cands = [j for j in range(n) if r[j] > 1]
        i = max(cands, key=lambda j: (r[j] - raw[j], r[j]))
        r[i] -= 1
    while sum(r) < rows:
        i = min(range(n), key=lambda j: (r[j] - raw[j], -raw[j]))
        r[i] += 1
    return r


def _fill_branch_band(grid: np.ndarray, r0: int, r1: int, c0: int, c1: int,
                      slots: Sequence[int], work: Sequence[float],
                      org: SpatialOrg) -> None:
    """Lay one branch's slots into its [r0:r1, c0:c1] column band.

    The organization controls the *intra-branch* interleaving, mirroring
    the whole-array styles: blocked orgs give each slot a contiguous row
    sub-band, fine orgs interleave rows (striped) or cells (checkerboard)
    so producer/consumer PEs of consecutive slots abut.
    """
    rows = r1 - r0
    if org in (SpatialOrg.BLOCKED_1D, SpatialOrg.BLOCKED_2D):
        alloc = _band_rows(work, rows)
        r = r0
        for slot, nr in zip(slots, alloc):
            grid[r:r + nr, c0:c1] = slot
            r += nr
    elif org == SpatialOrg.FINE_STRIPED_1D:
        alloc = _band_rows(work, rows)
        g = math.gcd(*alloc) if len(alloc) > 1 else alloc[0]
        pattern: List[int] = []
        unit = [a // g for a in alloc]
        for _ in range(g):
            for slot, u in zip(slots, unit):
                pattern.extend([slot] * u)
        for r in range(r0, r1):
            grid[r, c0:c1] = pattern[(r - r0) % len(pattern)]
    elif org == SpatialOrg.CHECKERBOARD_2D:
        cells = rows * (c1 - c0)
        counts = allocate_pes(list(work), cells)
        seq: List[int] = []
        rem = list(counts)
        while any(x > 0 for x in rem):
            for k, slot in enumerate(slots):
                if rem[k] > 0:
                    seq.append(slot)
                    rem[k] -= 1
        k = 0
        for r in range(r0, r1):
            cs = (range(c0, c1) if (r - r0) % 2 == 0
                  else range(c1 - 1, c0 - 1, -1))
            for c in cs:
                grid[r, c] = seq[k]
                k += 1
    else:
        raise ValueError(org)


def place_branches(org: SpatialOrg, slot_work: Sequence[float],
                   branches: Sequence[Sequence[int]],
                   fork_slot: Optional[int], join_slot: int, hw: HWConfig,
                   via_global_buffer: bool = False) -> Placement:
    """Branch-parallel placement: concurrent branches side by side.

    The substrate splits into per-branch *column* bands sized by branch
    work, so concurrent branches occupy disjoint regions instead of being
    stacked in serialized order.  The fork and join land differently by
    organization style:

      * blocked orgs — full-width fork band on top and join band at the
        bottom; each branch band stacks its slots as contiguous row
        sub-bands in between (every head adjacent to the fork band, every
        tail adjacent to the join band);
      * fine orgs — the fork's and join's PEs are *split across* the
        branch bands (proportionally to branch work) and interleaved with
        the branch slots inside each band, so the producer/consumer
        adjacency that makes fine interleavings congestion-free
        (Sec. IV-B) holds within every branch too.
    """
    rows, cols = hw.pe_rows, hw.pe_cols
    if len(branches) > cols:
        raise ValueError(f"{len(branches)} branches exceed {cols} columns")
    if not branches or any(len(b) == 0 for b in branches):
        raise ValueError("every branch needs at least one slot")
    fine = org in (SpatialOrg.FINE_STRIPED_1D, SpatialOrg.CHECKERBOARD_2D)
    grid = np.full((rows, cols), join_slot, dtype=np.int32)

    br_work = [max(1e-9, sum(slot_work[s] for s in b)) for b in branches]
    bcols = _band_rows(br_work, cols)   # whole-column bands, one per branch

    if fine:
        # fork/join interleaved into every branch band: band b holds
        # [fork?] + branch_b + [join], with the fork's/join's work split
        # across bands by branch-work share.
        c = 0
        for bi, (b, nc) in enumerate(zip(branches, bcols)):
            share = br_work[bi] / sum(br_work)
            slots = list(b)
            work = [max(1e-9, slot_work[s]) for s in b]
            if fork_slot is not None:
                slots = [fork_slot] + slots
                work = [max(1e-9, slot_work[fork_slot] * share)] + work
            slots = slots + [join_slot]
            work = work + [max(1e-9, slot_work[join_slot] * share)]
            _fill_branch_band(grid, 0, rows, c, c + nc, slots, work, org)
            c += nc
        return Placement(org, grid, via_global_buffer)

    longest = max(len(b) for b in branches)
    band_work = []
    if fork_slot is not None:
        band_work.append(max(1e-9, slot_work[fork_slot]))
    band_work.append(max(1e-9, sum(br_work)))
    band_work.append(max(1e-9, slot_work[join_slot]))
    band_alloc = _band_rows(band_work, rows)
    # the interior must fit the longest branch's row sub-bands
    mid = len(band_alloc) - 2
    while band_alloc[mid] < longest:
        donor = max((i for i in range(len(band_alloc)) if i != mid),
                    key=lambda i: band_alloc[i])
        if band_alloc[donor] <= 1:
            raise ValueError("substrate too short for branch depth")
        band_alloc[donor] -= 1
        band_alloc[mid] += 1

    r = 0
    if fork_slot is not None:
        grid[: band_alloc[0], :] = fork_slot
        r = band_alloc[0]
    mid_rows = band_alloc[mid]
    c = 0
    for b, nc in zip(branches, bcols):
        _fill_branch_band(grid, r, r + mid_rows, c, c + nc, list(b),
                          [max(1e-9, slot_work[s]) for s in b], org)
        c += nc
    # rows below the interior stay at the join slot (the grid default)
    return Placement(org, grid, via_global_buffer)


def choose_spatial_org(depth: int, granularity_bytes: int,
                       producer_pes: int, hw: HWConfig
                       ) -> Tuple[SpatialOrg, bool]:
    """Sec. IV-B selection rule -> (organization, via_global_buffer)."""
    if depth <= 1:
        return SpatialOrg.BLOCKED_1D, True
    rf_total = producer_pes * hw.rf_bytes_per_pe
    if rf_total < granularity_bytes:
        # coarse pipelining through the global buffer: always blocked
        org = SpatialOrg.BLOCKED_2D if depth >= 4 else SpatialOrg.BLOCKED_1D
        return org, True
    # fine-grained: how fine is the granularity relative to a PE's RF?
    pes_per_interval = max(1, granularity_bytes // hw.rf_bytes_per_pe)
    frac = pes_per_interval / max(1, producer_pes)
    if frac >= 0.5:
        # granularity ~ the producer's whole RF: blocked is fine
        org = SpatialOrg.BLOCKED_2D if depth >= 4 else SpatialOrg.BLOCKED_1D
        return org, False
    if depth >= 4:
        return SpatialOrg.CHECKERBOARD_2D, False
    return SpatialOrg.FINE_STRIPED_1D, False
