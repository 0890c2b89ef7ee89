"""RG-LRU diagonal recurrence on Hopper (port of ``repro.kernels.rglru_scan``).

  h_t = a_t * h_{t-1} + b_t      (per batch row and channel),
  h_{-1} = h0 (zero by default)

``rglru_chunked`` launches the CUDA kernel in ``csrc/rglru_scan.cu`` in
one of two regimes, by ``choose_regime(T)``: ``"step"`` below
``SPLIT_MIN`` steps (every decode call: one thread per row and channel,
h in a register along T) and ``"split"`` from ``SPLIT_MIN`` on (T cut
into segments of ``SEG_LEN`` steps, one warp's lanes along channels a
segment, each segment folded into a pair (A, B) whose carries cross the
segments in shared memory, then rerun from its carry-in;
``split_plan(B, T, W, sms)`` sizes the channel group and the segments).
The step regime is bound by the launch at T = 1, the split regime by
bytes plus one tile's latency chain; the source's header says more.
Unlike the reference kernel it takes a starting state ``h0`` (the
model's decode carries one) and any T (the reference asserts
``T % chunk == 0``).

On a CPU tensor the wrapper computes the plain version ``rglru_ref`` (the
sequential recurrence of ``repro.kernels.ref.rglru_ref``, with ``h0``); on
a CUDA tensor it launches the kernel or raises.
``rglru_chunked.launches`` counts launches.  The step regime is bit-equal
to ``rglru_ref``; the split regime rounds its carry-ins differently and
is bit-equal to ``rglru_split_ref``, which repeats its arithmetic in
PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.distributed.hints import dtensor_local

from . import build

#: on a mesh each rank runs its rows (over the data axes) and its
#: channels (over the model axis): the recurrence is diagonal
_CHANNELS = dtensor_local(
    [("batch", None, "model"), ("batch", None, "model"),
     lambda h0: ("batch", "model") if h0.ndim == 2
     else ("batch", None, "model")],
    [("batch", None, "model")] * 2)

#: calls of fewer steps (every decode call) run the step regime
SPLIT_MIN = 64
#: steps a segment of the split regime (2 SEG_LEN registers of a thread)
SEG_LEN = 16
#: segments a tile of the split regime (a block's threads along T)
MAX_SEGMENTS = 16
#: split blocks an SM holds, by channel group (the kernel's launch bounds:
#: 1024 threads' worth, 64 registers a thread), widest group first; 32
#: channels are one warp's 128-byte line a step
BLOCKS_PER_SM = {32: 2, 16: 4}
_REGIMES = {"step": 0, "split": 1}


def choose_regime(T: int) -> str:
    """The kernel regime of a call: ``"step"`` for T < ``SPLIT_MIN``
    (decode), ``"split"`` from ``SPLIT_MIN`` steps on."""
    return "split" if T >= SPLIT_MIN else "step"


def segments(T: int) -> int:
    """Segments a tile of the split regime: as many of ``SEG_LEN`` steps
    as cover T, at most ``MAX_SEGMENTS`` (longer T loops over tiles)."""
    return min(MAX_SEGMENTS, -(-T // SEG_LEN))


def split_plan(B: int, T: int, W: int, sms: int) -> Tuple[int, int]:
    """(channel group, segments a tile) of a split launch on a card of
    ``sms`` streaming multiprocessors: the widest group whose grid of
    B ceil(W / group) blocks fills one wave (``sms`` times the blocks an
    SM holds, ``BLOCKS_PER_SM``), else the narrowest, whose smaller
    blocks spread the work over more SMs; and ``segments(T)``."""
    groups = list(BLOCKS_PER_SM)
    fits = [g for g in groups if B * -(-W // g) >= sms * BLOCKS_PER_SM[g]]
    return (fits[0] if fits else groups[-1]), segments(T)


@_CHANNELS
def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: the recurrence step by step, in float32."""
    B, T, W = a.shape
    a, b = a.float(), b.float()
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float().reshape(B, W))
    hs = []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h[:, None, :]


def rglru_split_ref(a: torch.Tensor, b: torch.Tensor,
                    h0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split regime's arithmetic in PyTorch, in float32, one
    elementwise operation at a time (no ``cumprod`` or ``cumsum``, whose
    order is a tree on the card): tiles of ``segments(T)`` segments of
    ``SEG_LEN`` steps; per tile each segment's pair (A = prod a, B = its
    end state from zero), the carry across the segments c = A c + B, then
    each segment rerun from its carry-in; the next tile starts from this
    tile's last h."""
    B, T, W = a.shape
    a, b = a.float(), b.float()
    c = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float().reshape(B, W))
    tile = segments(T) * SEG_LEN
    hs = []
    for t0 in range(0, T, tile):
        spans = [range(s, min(s + SEG_LEN, T))
                 for s in range(t0, t0 + tile, SEG_LEN)]
        pairs = []
        for span in spans:
            pa = torch.ones_like(c)
            pb = torch.zeros_like(c)
            for t in span:
                pa = pa * a[:, t]
                pb = a[:, t] * pb + b[:, t]
            pairs.append((pa, pb))
        carry_in = []
        for pa, pb in pairs:
            carry_in.append(c)
            c = pa * c + pb
        for x, span in zip(carry_in, spans):
            for t in span:
                x = a[:, t] * x + b[:, t]
                hs.append(x)
        c = hs[-1]
    return torch.stack(hs, dim=1), hs[-1][:, None, :]


def _doubling(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0, by doubling
    (Hillis-Steele): after the round of distance d, (A_t, B_t) is the map
    of steps t - 2d + 1 .. t, so log2 T rounds of elementwise ops; every
    A is a product of a's.  Products and sums are separate ops (no fused
    multiply-add), so a channel's bits do not depend on how many channels
    a call holds (a mesh rank's share, say)."""
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1)
        if 2 * d < T:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return b


class _Scan(torch.autograd.Function):
    """``_doubling`` with h0 folded into the first step (in the inputs'
    dtype, as ``rglru_ref``'s first step), and its backward as the same
    scan reversed in time: g_t = dL/dh_t + a_{t+1} g_{t+1}, da_t = g_t
    h_{t-1}, db_t = g_t, dh0 = a_0 g_0.  Both scans run their rounds in
    float64 and round once to the inputs' dtype: a doubling round rounds
    every h again, and in float32 that noise reached a train step's Adam
    moments at the 1e-5 the mesh tests hold (the step loop's own rounding
    sat just below it).  It saves a, h and h0, no intermediate of the
    rounds."""

    @staticmethod
    def forward(ctx, a, b, h0):
        first = b[:, :1] if h0 is None else a[:, :1] * h0[:, None] + b[:, :1]
        h = _doubling(a.double(), torch.cat([first, b[:, 1:]], 1).double()
                      ).to(a.dtype)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, gh):
        a, h, h0 = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
        g = _doubling(a_next.double().flip(1), gh.double().flip(1)
                      ).flip(1).to(gh.dtype)
        prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                          else h0[:, None], h[:, :-1]], 1)
        return g * prev, g, None if h0 is None else a[:, 0] * g[:, 0]


@_CHANNELS
def rglru_doubling(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The models' plain path: the recurrence by doubling, log2 T rounds
    of elementwise ops over all of T, in float32 out (float64 inputs stay
    float64; the rounds run in float64), differentiable through
    ``_Scan``.  The first step is
    ``rglru_ref``'s a_0 h0 + b_0, so T = 1 (decode) gives its bits;
    ``rglru_ref`` is the step-by-step witness it is held to."""
    B, T, W = a.shape
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    h = _Scan.apply(a.to(dt), b.to(dt),
                    None if h0 is None else h0.to(dt).reshape(B, W))
    return h, h[:, -1:]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.rglru_launch.restype = i
    lib.rglru_error_string.argtypes = [i]
    lib.rglru_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@_CHANNELS
def rglru_chunked(a: torch.Tensor, b: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a, b: (B, T, W); h0: (B, W), (B, 1, W) or None
    -> (h (B, T, W), h_last (B, 1, W)), both float32.  On the card both
    are views of one allocation."""
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError("rglru_chunked takes a, b of one (B, T, W) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    B, T, W = a.shape
    if h0 is not None and (h0.numel() != B * W or h0.shape[0] != B):
        raise ValueError(f"h0 must be (B, W) or (B, 1, W) with B={B}, "
                         f"W={W}, got {tuple(h0.shape)}")
    if T == 0:
        raise ValueError("rglru_chunked needs T >= 1")
    # the checks are written out, not looped: each is on the launch path
    dev = a.device
    if b.device != dev or (h0 is not None and h0.device != dev):
        raise ValueError("rglru_chunked inputs must lie on one device")
    if dev.type == "cpu":
        return rglru_ref(a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"rglru_chunked runs on cuda or cpu, not {dev}")
    build.refuse_grad("rglru_chunked", a, b, h0)
    f32 = torch.float32
    if a.dtype != f32 or b.dtype != f32 or (h0 is not None
                                            and h0.dtype != f32):
        raise TypeError("rglru_chunked takes float32 inputs, got "
                        f"{[t.dtype for t in (a, b, h0) if t is not None]}")
    if not (a.is_contiguous() and b.is_contiguous()
            and (h0 is None or h0.is_contiguous())):
        raise ValueError("rglru_chunked takes contiguous inputs")
    if B > 65535:
        raise ValueError(f"B={B} exceeds one launch's 65535 rows")
    out = _launch(a, b, h0, choose_regime(T))
    rglru_chunked.launches += 1
    return out


rglru_chunked.launches = 0


def _launch(a, b, h0, regime: str):
    """One launch of the kernel in ``regime`` on checked CUDA inputs; no
    launch count.  ``rglru_chunked`` calls it, and ``chip_smoke.py`` times
    the step kernel on the split rows through it.  h and h_last are views
    of one allocation."""
    B, T, W = a.shape
    dev = a.device
    group, n_seg = (split_plan(B, T, W, _sm_count(dev.index))
                    if regime == "split" else (0, 0))
    n = B * T * W
    out = a.new_empty(n + B * W)
    lib = _library()
    with build.on_device(dev):
        err = lib.rglru_launch(
            a.data_ptr(), b.data_ptr(),
            None if h0 is None else h0.data_ptr(), out.data_ptr(),
            out.data_ptr() + 4 * n, B, T, W, _REGIMES[regime], group, n_seg,
            build.launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"rglru_chunked {regime} launch failed: "
                           + lib.rglru_error_string(err).decode())
    return (out.as_strided((B, T, W), (T * W, W, 1)),
            out.as_strided((B, 1, W), (W, W, 1), n))
