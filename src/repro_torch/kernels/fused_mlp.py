"""Fused SwiGLU MLP — PipeOrgan's fine-grained inter-op pipelining on Hopper.

Port of ``repro.kernels.fused_mlp``.  ``fused_mlp`` launches the CUDA
kernels in ``csrc/fused_mlp.cu``.  The intermediate ``silu(x Wg) * (x Wu)``
is handed from the two producer products to the down product on chip and
never reaches device memory.  Three regimes, chosen by ``choose_regime``
from T, D and the dtype (the source's header says what bounds each):

* ``wgmma``, bf16 prefill (at least ``PREFILL_MIN_T`` rows) past one row
  tile, or at D > 2560: warpgroup MMA (``wgmma``) fed by TMA, a producer
  warpgroup and two consumer warpgroups a CTA, across a cluster of
  ``wgmma_ctas(D)`` CTAs (8, or 16 where 8 slices of ``WGMMA_MAX_DC``
  columns do not cover D) that each own a 64-column-aligned slice of D
  (up to ``WGMMA_MAX_DC``, so D <= 10240; a wider D raises) and share h
  through distributed shared memory;
* ``cluster``, bf16 prefill of one row tile (``PREFILL_MIN_T`` to
  ``CLUSTER_BT`` rows) at D <= 2560: the same hand-off on ``mma.sync``,
  which streams the weights of such a call faster (``PERF.md``);
* ``rows``, bf16 with fewer rows (decode) and float32 at every T: a
  bandwidth-bound kernel that splits F over the SMs and reads the weights
  once with 16-byte loads (float32 on the CUDA cores, fp32 products).

Where F is split over blocks, each split writes its fp32 partial into a
workspace and the partials are summed in a fixed order, so two calls on
the same inputs give the same bits.  TMA reads rows on 16-byte pitches:
for the ``wgmma`` regime a D or F that is not a multiple of 8, or an input
not 16-byte aligned, is zero-padded into a copy first (no model has such
a width).

On a CPU tensor the wrapper computes the plain version, ``fused_mlp_ref``
(the port of ``repro.kernels.ref.fused_mlp_ref``); on a CUDA tensor it
launches the kernel or raises.  ``fused_mlp.launches`` counts calls that
launched: one per call, though a call may run two CUDA functions, the
regime's kernel and the ordered reduction of its splits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.distributed.hints import dtensor_local

from . import build

#: kernel dtype codes of ``fused_mlp_launch``
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: regime codes of ``fused_mlp_launch``
_REGIMES = {"rows": 0, "wgmma": 1, "cluster": 2}

#: F columns per chunk, every regime (``kBF`` in the source)
BF = 64
#: CTAs per cluster and rows per cluster tile (``kC``, ``kBT``), both
#: cluster regimes
CLUSTER = 8
CLUSTER_BT = 64
#: the widest D-slice a CTA of the ``wgmma`` regime owns (``kMaxDC``): its
#: out slice, 64 x 640 fp32, takes 160 of each consumer thread's 232
#: registers, and its x slice and weight rings fill its shared memory.
#: Slices are multiples of 64 columns (a TMA box, a wgmma tile)
WGMMA_MAX_DC = 640
#: CTAs a ``wgmma`` cluster may take: 8 (portable) up to D = 5120, then
#: 16, the most Hopper runs as one cluster, up to D = 10240; a wider D
#: raises
WGMMA_CLUSTERS = (8, 16)
#: D-slice widths the ``cluster`` (mma.sync) kernel is built for: a CTA's
#: slice of D, D / 8 rounded up to 16 bytes, is padded to the smallest
#: that holds it (D <= 2560)
CLUSTER_DC_TILES = (64, 128, 256, 320)
#: a cluster's start (its x slice, the first stripes), in chunks' time
CLUSTER_START_CHUNKS = 2
#: bf16 rows from which a cluster regime runs.  Its time hardly grows
#: with T up to one 64-row tile, while the rows regime reads the weights
#: once per ``ROWS_BT`` rows; on the H100 the rows regime wins only for
#: one 4-row tile, the serve path's 4 slots (PERF.md)
PREFILL_MIN_T = 5
#: rows per block of the rows regime (``kRowsBtBf16``, ``kRowsBtF32``)
ROWS_BT = {torch.bfloat16: 4, torch.float32: 8}
#: the rows regime's splits of F: from one wave of blocks up to this many,
#: the count that fills its last wave best, and no split narrower than
#: ``ROWS_MIN_COLS`` columns
ROWS_WAVES = 4
ROWS_MIN_COLS = 16


def wgmma_dc(D: int, ctas: int = CLUSTER) -> int:
    """Columns of D each CTA of a ``ctas``-CTA ``wgmma`` cluster owns: D /
    ctas rounded up to a multiple of 64 (128 bytes of bf16), so that the
    slices never overlap; the last ones may lie partly or wholly past D,
    where TMA reads zeros."""
    per_cta = -(-D // ctas)
    return -(-per_cta // 64) * 64


def wgmma_ctas(D: int) -> int:
    """CTAs of a ``wgmma`` cluster at width D: the fewest of
    ``WGMMA_CLUSTERS`` whose slices are at most ``WGMMA_MAX_DC`` wide
    (so D <= 5120 keeps its 8-CTA clusters); raises past the widest."""
    for ctas in WGMMA_CLUSTERS:
        if wgmma_dc(D, ctas) <= WGMMA_MAX_DC:
            return ctas
    top = WGMMA_CLUSTERS[-1]
    raise ValueError(
        f"fused_mlp: bf16 prefill at D={D} needs "
        f"{wgmma_dc(D, top)}-column D-slices even in {top}-CTA clusters, "
        f"wider than the wgmma regime's {WGMMA_MAX_DC} "
        f"(D <= {top * WGMMA_MAX_DC})")


def cluster_dc(D: int) -> int:
    """Columns of D each CTA of a ``cluster`` (mma.sync) cluster owns:
    D / CLUSTER rounded up to a multiple of 8 (16 bytes of bf16)."""
    per_cta = -(-D // CLUSTER)
    return -(-per_cta // 8) * 8


def choose_regime(T: int, D: int, bf16: bool) -> Tuple[str, int]:
    """(regime, D-slice width) for a call.  bf16 with ``T >=
    PREFILL_MIN_T``: ``("cluster", tile)`` for one row tile (``T <=
    CLUSTER_BT``) whose ``cluster_dc(D)`` fits a ``CLUSTER_DC_TILES``
    tile, else ``("wgmma", wgmma_dc(D, wgmma_ctas(D)))``; past D = 10240
    ``wgmma_ctas`` raises (no regime of this card takes it: the rows
    regime re-reads the weights every 4 rows).  Otherwise ``("rows",
    0)``."""
    if bf16 and T >= PREFILL_MIN_T:
        if T <= CLUSTER_BT:
            fits = [t for t in CLUSTER_DC_TILES if t >= cluster_dc(D)]
            if fits:
                return "cluster", fits[0]
        return "wgmma", wgmma_dc(D, wgmma_ctas(D))
    return "rows", 0


def rows_splits(row_tiles: int, F: int, slots: int) -> int:
    """Splits of F for the rows regime, where ``slots`` blocks fit the
    card at once.  Each split takes an even share of F, so a call's time
    follows its fullest wave: take the count, between one and
    ``ROWS_WAVES`` waves of blocks, whose last wave is fullest (the
    smallest such), one split when the row tiles fill a wave alone."""
    if row_tiles >= slots:
        return 1
    lo = -(-slots // row_tiles)
    hi = -(-ROWS_WAVES * slots // row_tiles)
    # the smallest count that fills whole waves, where there is one
    whole = slots // math.gcd(row_tiles, slots)
    best = -(-lo // whole) * whole
    if best > hi:
        def fill(n):
            waves = row_tiles * n / slots
            return waves / math.ceil(waves)

        best = max(range(lo, hi + 1), key=lambda n: (fill(n), -n))
    return max(1, min(best, F // ROWS_MIN_COLS))


def split_f(row_tiles: int, F: int, slots: int) -> Tuple[int, int]:
    """(splits, chunks per split) of F's ``BF``-wide chunks for a
    cluster regime, where ``slots`` clusters fit the card at once.  A
    call takes about (waves of clusters) x (chunks a cluster sweeps +
    ``CLUSTER_START_CHUNKS``); take the split count that makes this
    least, the smallest such; one split where the row tiles fill a wave
    alone (more would add a reduction for little).  No split is empty."""
    chunks = -(-F // BF)
    if row_tiles >= slots:               # the tiles fill a wave alone
        return 1, chunks

    def cost(n):
        per = -(-chunks // n)
        return -(-row_tiles * n // slots) * (per + CLUSTER_START_CHUNKS)

    n_split = min(range(1, chunks + 1), key=lambda n: (cost(n), n))
    per = -(-chunks // n_split)
    return -(-chunks // per), per


def fused_mlp_ref(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: fp32 products, h rounded to ``x.dtype``."""
    g = x.float() @ w_gate.float()
    u = x.float() @ w_up.float()
    h = torch.nn.functional.silu(g) * u
    return (h.to(x.dtype).float() @ w_down.float()).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("fused_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                     i, p]
    lib.fused_mlp_launch.restype = i
    lib.fused_mlp_max_active_clusters.argtypes = [i, i]
    lib.fused_mlp_max_active_clusters.restype = i
    lib.fused_mlp_rows_blocks_per_sm.argtypes = [i, i]
    lib.fused_mlp_rows_blocks_per_sm.restype = i
    lib.fused_mlp_max_t.argtypes = []
    lib.fused_mlp_max_t.restype = i
    lib.fused_mlp_error_string.argtypes = [i]
    lib.fused_mlp_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _cluster_slots(index: int, regime: int, tile: int) -> int:
    """Clusters that fit card ``index`` at once: of the ``wgmma`` kernel
    of ``tile`` CTAs, or of the ``cluster`` kernel's D-slice tile
    ``tile``."""
    with torch.cuda.device(index):
        n = _library().fused_mlp_max_active_clusters(regime, tile)
    if n <= 0:
        raise RuntimeError(f"fused_mlp: no cluster of the prefill kernel "
                           f"(regime {regime}, tile {tile}) fits this "
                           f"card ({n})")
    return n


@functools.cache
def _rows_slots(index: int, dtype: torch.dtype, D: int) -> int:
    """Blocks of the rows kernel that fit card ``index`` at once."""
    with torch.cuda.device(index):
        n = _library().fused_mlp_rows_blocks_per_sm(_DTYPES[dtype], D)
    if n <= 0:
        raise RuntimeError(f"fused_mlp: no block of the rows kernel fits "
                           f"an SM at D={D} ({n})")
    return n * _sm_count(index)


@functools.lru_cache(maxsize=1024)
def _plan(index: int, T: int, D: int, F: int, dtype: torch.dtype):
    """(regime code, tile, splits, chunks per split, workspace floats) of
    a call: the tile is the ``cluster`` regime's D-slice tile, the
    ``wgmma`` regime's CTAs a cluster; a cluster call with one split
    needs no workspace."""
    regime, dc = choose_regime(T, D, dtype == torch.bfloat16)
    tile = (dc if regime == "cluster" else
            wgmma_ctas(D) if regime == "wgmma" else 0)
    if regime == "rows":
        n_split, per = rows_splits(-(-T // ROWS_BT[dtype]), F,
                                   _rows_slots(index, dtype, D)), 0
        ws = n_split * T * D
    else:
        n_split, per = split_f(-(-T // CLUSTER_BT), F,
                               _cluster_slots(index, _REGIMES[regime],
                                              tile))
        ws = 0 if n_split == 1 else n_split * T * D
    return _REGIMES[regime], tile, n_split, per, ws


def pad_for_tma(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor):
    """The inputs as the ``wgmma`` regime's TMA reads them: as given where
    D and F are multiples of 8 and every tensor starts on 16 bytes, else
    zero-padded copies of D and F rounded up to multiples of 8 (the padding
    adds zeros to every sum)."""
    T, D = x.shape
    F = w_gate.shape[1]
    if D % 8 == 0 and F % 8 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (x, w_gate, w_up, w_down)):
        return x, w_gate, w_up, w_down
    D8, F8 = -(-D // 8) * 8, -(-F // 8) * 8

    def pad(t, rows, cols):
        out = t.new_zeros(rows, cols)
        out[:t.shape[0], :t.shape[1]] = t
        return out

    return (pad(x, T, D8), pad(w_gate, D8, F8), pad(w_up, D8, F8),
            pad(w_down, F8, D8))


@dtensor_local([("batch", None), (None, "model"), (None, "model"),
                ("model", None)], [("batch", None)])
def fused_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """x: (T, D); w_gate/w_up: (D, F); w_down: (F, D) -> (T, D) in x.dtype.

    Given DTensors (a mesh), each rank runs the kernel on its rows (T
    over the data axes) and its slice of F (over the model axis, where F
    divides it; the weights' FSDP shards gathered first), and the
    output is the sum of the model ranks' parts."""
    if x.ndim != 2 or w_gate.ndim != 2 or w_up.ndim != 2 or w_down.ndim != 2:
        raise ValueError("fused_mlp takes x (T, D), w_gate/w_up (D, F) and "
                         "w_down (F, D)")
    T, D = x.shape
    F = w_gate.shape[1]
    if (tuple(w_gate.shape) != (D, F) or tuple(w_up.shape) != (D, F)
            or tuple(w_down.shape) != (F, D)):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_up {tuple(w_up.shape)}, "
                         f"w_down {tuple(w_down.shape)}")
    tensors = (x, w_gate, w_up, w_down)
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_mlp inputs must lie on one device")
    if x.device.type == "cpu":
        return fused_mlp_ref(x, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp runs on cuda or cpu, not {x.device}")
    build.refuse_grad("fused_mlp", *tensors)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("fused_mlp takes float32 or bfloat16 inputs of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp takes contiguous (row-major) inputs")
    lib = _library()
    if not 0 < T <= lib.fused_mlp_max_t():
        raise ValueError(f"T={T} is outside one launch's 1.."
                         f"{lib.fused_mlp_max_t()} rows")
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    if choose_regime(T, D, x.dtype == torch.bfloat16)[0] == "wgmma":
        x, w_gate, w_up, w_down = pad_for_tma(x, w_gate, w_up, w_down)
    Dk, Fk = x.shape[1], w_gate.shape[1]
    regime, tile, n_split, per, n_ws = _plan(index, T, Dk, Fk, x.dtype)
    # per-split fp32 partials, summed in a fixed order by the kernel
    ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
    out = torch.empty((T, Dk), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), ws.data_ptr(), out.data_ptr(), T, Dk, Fk,
            _DTYPES[x.dtype], regime, tile, n_split, per,
            torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        err = lib.fused_mlp_launch(*args)
    else:
        with torch.cuda.device(index):
            err = lib.fused_mlp_launch(*args)
    if err != 0:
        raise RuntimeError("fused_mlp launch failed: "
                           + lib.fused_mlp_error_string(err).decode())
    fused_mlp.launches += 1
    return out if Dk == D else out[:, :D].contiguous()


fused_mlp.launches = 0


def mlp_block(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor) -> torch.Tensor:
    """(B, S, D) SwiGLU through ``fused_mlp`` (``repro.kernels.ops``)."""
    B, S, D = x.shape
    y = fused_mlp(x.reshape(B * S, D), w_gate, w_up, w_down)
    return y.reshape(B, S, D)
