"""Candidate pricing kernel of the torch planning engine.

``price_rows`` prices every DP candidate of one planner call with the
CUDA kernel in ``csrc/price_rows.cu``: the Fig. 3 interval recurrence of
``repro.core.pipeline_model_jax._make_price_fn`` per candidate, one
thread a row, built without fused multiply-adds so that its float64
results are the host's to the last bit.  Rows of any edge count share
one launch.  With ``device="cpu"`` the wrapper computes the plain
version ``price_rows_plain``; with ``cuda`` it launches the kernel or
raises.  ``price_rows.launches`` counts launches.

The ragged layout (B rows, N edges in all, M incoming entries):

  floats     (7, N) float64  t_prod, t_cons, n, fill, load, hops, hop_unit
  mem_stall  (B,)   float64
  row_ptr    (B + 1,) int32  row b's edges are [row_ptr[b], row_ptr[b + 1])
  flags      (N,)   uint8    bit 0: the edge has NoC stats (``sp``),
                             bit 1: it drains into the sink (``fin``)
  in_ptr     (N + 1,) int32  the incoming edges of edge e's producer slot
  in_idx     (M,)   int32    are in_idx[in_ptr[e]:in_ptr[e + 1]], as
                             indices within e's row, each below e's own

and the output, packed so that it comes back in one copy:
``(3 B + N,)`` float64, latency (B), hop energy (B), congested (B; 1.0
or 0.0) and the deltas (N).  ``layout`` places the inputs in one staging
tensor, and ``price_rows`` takes that tensor: on the card one C call
copies it up, launches and copies the output back.

``price_rows_ref`` is the reference's ``one`` line by line, batched over
candidates on padded (B, E) tensors; the plain version pads each edge
bucket and calls it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import build


def price_rows_ref(t_prod: torch.Tensor, t_cons: torch.Tensor,
                   n: torch.Tensor, fill: torch.Tensor, load: torch.Tensor,
                   hops: torch.Tensor, hop_unit: torch.Tensor,
                   sp: torch.Tensor, fin: torch.Tensor, inc: torch.Tensor,
                   mem_stall: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """The reference's ``one``, batched over candidates: (B, E) float64
    rows, (B, E) bool ``sp``/``fin``, (B, E, E) bool ``inc`` (``inc[b, k,
    d]``: edge d is incoming to edge k's producer slot), (B,) float64
    ``mem_stall`` -> latency (B,), congested (B,) bool, hop energy (B,),
    deltas (B, E)."""
    B, E = t_prod.shape
    deltas = torch.zeros_like(t_prod)
    pfill = torch.zeros_like(t_prod)
    congested = torch.zeros(B, dtype=torch.bool, device=t_prod.device)
    max_hops = torch.zeros(B, dtype=t_prod.dtype, device=t_prod.device)
    hop_e = torch.zeros(B, dtype=t_prod.dtype, device=t_prod.device)
    for k in range(E):
        nk = n[:, k]
        prod_side = torch.where(inc[:, k], deltas * (n / nk[:, None]),
                                0.0).amax(dim=1)
        ci = torch.maximum(t_prod[:, k],
                           torch.maximum(t_cons[:, k], prod_side))
        over = sp[:, k] & (load[:, k] > ci)
        capped = torch.minimum(
            load[:, k] * torch.clamp(ci, min=1.0),
            torch.maximum(load[:, k] * 2.0, load[:, k] + hops[:, k] + ci))
        comm = torch.where(over, capped, ci)
        congested = congested | over
        max_hops = torch.maximum(max_hops,
                                 torch.where(sp[:, k], hops[:, k], 0.0))
        hop_e = hop_e + torch.where(sp[:, k], hop_unit[:, k] * nk, 0.0)
        delta = torch.maximum(ci, comm) + mem_stall / nk
        upstream = torch.where(inc[:, k], pfill, 0.0).amax(dim=1)
        deltas[:, k] = delta
        pfill[:, k] = upstream + delta * fill[:, k]
    latency = (torch.where(fin, pfill + n * deltas, -torch.inf).amax(dim=1)
               + max_hops)
    return latency, congested, hop_e, deltas


def bucket_edges(E: int) -> int:
    """The reference's edge bucket: E padded to a power of two, floor 2."""
    return max(2, 1 << (E - 1).bit_length())


def price_rows_plain(floats: torch.Tensor, mem_stall: torch.Tensor,
                     row_ptr: torch.Tensor, flags: torch.Tensor,
                     in_ptr: torch.Tensor, in_idx: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of the ragged function: each edge bucket's rows
    padded to (B_g, E_pad) and priced by ``price_rows_ref``.

    Padding is exact: a padded edge (t = 0, n = 1, masks off, no incoming
    edge) is incoming to no real edge, drains into nothing and adds +0.0
    to the hop energy, and its delta is dropped, so every real edge's
    result is the one the unpadded recurrence gives."""
    B, N = mem_stall.shape[0], floats.shape[1]
    dev = floats.device
    out = torch.empty(3 * B + N, dtype=torch.float64, device=dev)
    if B == 0:
        return out
    rp = row_ptr.long()
    ip = in_ptr.long()
    ix = in_idx.long()
    sp_all = (flags & 1).bool()
    fin_all = (flags & 2).bool()
    E = rp[1:] - rp[:-1]
    buckets = torch.tensor([bucket_edges(e) for e in E.tolist()],
                           device=dev)
    for e_pad in sorted(set(buckets.tolist())):
        rows = torch.nonzero(buckets == e_pad).flatten()
        Bg = rows.numel()
        k = torch.arange(e_pad, device=dev)
        real = k < E[rows, None]                             # (Bg, e_pad)
        edge = torch.where(real, rp[rows, None] + k, 0)
        g = torch.where(real, floats[:, edge], 0.0)          # (7, Bg, e_pad)
        g[2] = torch.where(real, g[2], 1.0)
        sp = real & sp_all[edge]
        fin = real & fin_all[edge]
        # incidence from the incoming lists of the real edges
        slot = torch.nonzero(real.flatten()).flatten()      # b * e_pad + k
        e = edge.flatten()[slot]
        deg = ip[e + 1] - ip[e]
        owner = torch.repeat_interleave(slot, deg)
        first = torch.repeat_interleave(ip[e] - (torch.cumsum(deg, 0) - deg),
                                        deg)
        j = first + torch.arange(owner.numel(), device=dev)
        inc = torch.zeros(Bg * e_pad, e_pad, dtype=torch.bool, device=dev)
        inc[owner, ix[j]] = True
        lat, cong, hop_e, deltas = price_rows_ref(
            *g, sp, fin, inc.view(Bg, e_pad, e_pad), mem_stall[rows])
        out[rows] = lat
        out[B + rows] = hop_e
        out[2 * B + rows] = cong.double()
        out[3 * B + edge[real]] = deltas[real]
    return out


# ---------------------------------------------------------------------------
# the staging tensor
# ---------------------------------------------------------------------------


class Layout(NamedTuple):
    """Byte offsets of the ragged inputs in one staging tensor, each
    8-byte aligned so that every part views as its own dtype, and of the
    room after them where the card's packed output lands."""
    B: int
    N: int
    M: int
    floats: int
    mem_stall: int
    row_ptr: int
    flags: int
    in_ptr: int
    in_idx: int
    out: int
    nbytes: int


def layout(B: int, N: int, M: int) -> Layout:
    sizes = (56 * N, 8 * B, 4 * (B + 1), N, 4 * (N + 1), 4 * M,
             8 * (3 * B + N))
    offsets, at = [], 0
    for size in sizes:
        offsets.append(at)
        at += -(-size // 8) * 8
    return Layout(B, N, M, *offsets, at)


def unstage(stage: torch.Tensor, lay: Layout) -> Tuple[torch.Tensor, ...]:
    """The six inputs as views of a uint8 staging tensor."""
    def part(at, n, dtype, size):
        return stage[at:at + n * size].view(dtype)

    return (part(lay.floats, 7 * lay.N, torch.float64, 8).view(7, lay.N),
            part(lay.mem_stall, lay.B, torch.float64, 8),
            part(lay.row_ptr, lay.B + 1, torch.int32, 4),
            part(lay.flags, lay.N, torch.uint8, 1),
            part(lay.in_ptr, lay.N + 1, torch.int32, 4),
            part(lay.in_idx, lay.M, torch.int32, 4))


class Plan(NamedTuple):
    """How a launch splits its rows over blocks (``price_rows_plan`` in
    the CUDA source): rows a block, dynamic shared memory a block, the
    blocks, and the blocks whose rows stage in global scratch."""
    rows_per_block: int
    smem_bytes: int
    blocks: int
    global_blocks: int

    @property
    def regime(self) -> str:
        if self.global_blocks == 0:
            return "shared"
        return "global" if self.global_blocks == self.blocks else "mixed"


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("price_rows")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.price_rows_plan.argtypes = [p, p, i, p]
    lib.price_rows_plan.restype = i
    lib.price_rows_round_trip.argtypes = [p, ll, p, i, i, i, p, ll, ll, p,
                                          p, p, p]
    lib.price_rows_round_trip.restype = i
    lib.price_rows_error_string.argtypes = [i]
    lib.price_rows_error_string.restype = ctypes.c_char_p
    return lib


def _check(stage: torch.Tensor, lay: Layout) -> None:
    if (stage.device.type != "cpu" or stage.dtype != torch.uint8
            or not stage.is_contiguous() or stage.numel() < lay.nbytes):
        raise ValueError(
            "price_rows takes a contiguous uint8 host staging tensor of at "
            f"least {lay.nbytes} bytes, got {stage.dtype} "
            f"{tuple(stage.shape)} on {stage.device}")
    if lay.B < 1:
        raise ValueError("price_rows takes at least one row")


def block_plan(stage: torch.Tensor, lay: Layout) -> Plan:
    """The block plan the card's launch takes for the rows staged in
    ``stage``: ``price_rows_plan`` of the built library on the staged
    row_ptr and in_ptr (host code, no launch)."""
    _check(stage, lay)
    lib = _library()
    plan = (ctypes.c_int * 4)()
    host = stage.data_ptr()
    err = lib.price_rows_plan(host + lay.row_ptr, host + lay.in_ptr, lay.B,
                              plan)
    if err != 0:
        raise RuntimeError("price_rows plan failed: "
                           + lib.price_rows_error_string(err).decode())
    return Plan(*plan)


#: cudaErrorMemoryAllocation: the round trip's device buffer is too small
_OUT_OF_ROOM = 2


def price_rows(stage: torch.Tensor, lay: Layout, device: torch.device
               ) -> np.ndarray:
    """Price the rows staged in ``stage`` (a host uint8 tensor laid out
    by ``lay``, pinned for the card) on ``device`` -> the packed
    (3 B + N,) float64 output on the host.

    On ``cuda``: one call into the library (``price_rows_round_trip``)
    takes the block plan from the staged host copy, copies the inputs to
    the card once, launches once on addresses inside that copy, copies
    the output back into the staging tensor's room for it, and waits for
    the stream; a failed build, copy or launch raises.  On ``cpu``: the
    plain version on views of the same tensor, no launch.  Any other
    device raises."""
    _check(stage, lay)
    if device.type == "cpu":
        return price_rows_plain(*unstage(stage, lay)).numpy()
    if device.type != "cuda":
        raise ValueError(f"price_rows runs on cuda or cpu, not {device}")
    lib = _library()
    n_out = 3 * lay.B + lay.N
    out_at = -(-lay.out // 16) * 16
    at = (ctypes.c_longlong * 6)(lay.floats, lay.mem_stall, lay.row_ptr,
                                 lay.flags, lay.in_ptr, lay.in_idx)
    plan = (ctypes.c_int * 4)()
    need = ctypes.c_longlong(out_at + 8 * n_out)
    host = stage.data_ptr()
    while True:      # a second pass only where global blocks need scratch
        work = torch.empty(need.value, dtype=torch.uint8, device=device)
        dev = work.device
        with build.on_device(dev):
            err = lib.price_rows_round_trip(
                host, lay.out, at, lay.B, lay.N, lay.M, work.data_ptr(),
                need.value, out_at, host + lay.out,
                build.launch_stream(dev), plan, ctypes.byref(need))
        if err != _OUT_OF_ROOM or need.value <= work.numel():
            break
    if err != 0:
        raise RuntimeError("price_rows round trip failed: "
                           + lib.price_rows_error_string(err).decode())
    price_rows.launches += 1
    return stage.numpy()[lay.out:lay.out + 8 * n_out].view(
        np.float64).copy()


price_rows.launches = 0
