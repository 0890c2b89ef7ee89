"""Batched serving loop with continuous batching.

Port of ``repro.runtime.serve_loop.ServeEngine``: a fixed pool of B decode
slots over one shared decode cache (KV for attention, recurrent state for
RWKV and RG-LRU; the engine only calls ``init_cache``, ``decode_step`` and
``zero_cache_slot``, so every ported family serves alike).  Requests
(prompt + max_new_tokens) queue up; a slot that finishes (EOS or budget)
is refilled with the next request, whose prompt is prefilled in the
decode slot token by token.  Per-slot state lives in host numpy arrays;
the device runs one decode step per tick over every slot, idle ones
included.  A vlm (qwen2-vl-2b) serves text only, as the reference's
decode takes no patches.  The encoder-decoder (whisper-medium) does not
serve: the reference's ``ServeEngine`` has no enc-dec path either
(``require_servable``).

The reference jits the device step, argmax included; on a CUDA device the
port captures it in a CUDA graph (``cuda_graph``, the default there) at
the first tick and replays that graph once a tick: embedding, every
layer, the logits and the argmax as one launch from the host.  Its inputs
are two device buffers that live as long as the engine (tokens and
per-slot cursors), filled from one pinned host buffer by one copy a tick;
its output is a static device tensor read back by the tick's one
``.cpu()``.  The cache is written in place, so the graph holds its
storage; the slot wipe and the plan hooks act on that storage between
replays.  The eager engine (``cuda_graph=False``) runs the same step op
by op from the same buffers.

Tracing (``runtime.telemetry``): a tick runs inside the host spans
``serve.step`` > ``serve.refill``, ``serve.feed``, ``serve.launch``,
``serve.readback``, ``serve.marks``, ``serve.book``, which only a
running profiler records.  Beside the plain graph the engine captures an
instrumented one, with a CUDA event at each decoder section's mark, in
the plain graph's memory pool; a tick replays it only while a profiler
runs (every other tick there), and books each section's device ms from
its events while the next tick's step runs.  Every engine keeps a
``telemetry.ServeLog`` (``log``): counters, a row a tick, a row a
request; ``stats()`` includes the counters.

The planner hooks are the reference's: ``decode_graph`` lowers the
decode step to a planner graph, ``ServeEngine(plan_request=,
plan_store=)`` attaches its accelerator plan (store first, then the
shared ``Planner``), and ``AdmissionScheduler`` drives one engine per
tenant in the mode a ``MultiTenantPlan`` resolves.  A request priced by
the torch engine plans where its ``device`` says (``None``: ``cuda``).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import (Graph, HWConfig, PlanAPIDeprecationWarning,
                              PlanRequest, PlanSchemaError, PlanStore,
                              Topology, gemm, get_planner)
from repro_torch.models.common import DeviceLike, ModelConfig, resolve_device
from repro_torch.models.transformer import (decode_step, init_cache,
                                            zero_cache_slot)
from repro_torch.runtime import telemetry
from repro_torch.runtime.telemetry import span


def decode_graph(cfg: ModelConfig) -> Graph:
    """One decode step of the transformer as an operator DAG.

    Per layer: QKV projection, attention output projection, MLP up and
    down GEMMs (M=1: a single token), then the LM head — the shapes the
    PipeOrgan planner needs to place the decode step on an accelerator.
    """
    hd = cfg.hd
    ops = []
    prev = None

    def g_(name: str, n: int, k: int) -> None:
        nonlocal prev
        ops.append(gemm(name, 1, n, k,
                        inputs=(prev,) if prev is not None else ()))
        prev = name

    for layer in range(cfg.n_layers):
        g_(f"l{layer}.qkv", hd * (cfg.n_heads + 2 * cfg.n_kv_heads),
           cfg.d_model)
        g_(f"l{layer}.attn_out", cfg.d_model, cfg.n_heads * hd)
        g_(f"l{layer}.mlp_up", cfg.d_ff, cfg.d_model)
        g_(f"l{layer}.mlp_down", cfg.d_model, cfg.d_ff)
    g_("lm_head", cfg.vocab, cfg.d_model)
    return Graph(f"{cfg.name}-decode", ops)


def _clone(tree):
    """A copy of a cache's tree of tensors."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def require_servable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for the encoder-decoder family, which
    the reference's ``ServeEngine`` does not serve (it has no enc-dec
    path: no encoded frames per slot, no ``whisper_decode_step``)."""
    if cfg.arch_kind == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the reference's ServeEngine has no enc-dec path, "
            "so neither has the port's; run encode_frames, whisper_forward "
            "and whisper_decode_step instead")


#: eager device steps run, on a side stream and on a copy of the cache,
#: before a CUDA graph is captured (they load the kernel libraries and
#: make the one-time attribute and occupancy calls outside the capture)
GRAPH_WARMUP_STEPS = 1


class ServeEngine:
    """Continuous-batching engine over a fixed slot pool, on ``device``
    (``cuda`` unless the caller passes another).  ``params`` must already
    lie on that device.  ``cuda_graph``: replay the device step as one
    captured CUDA graph a tick (default: on a CUDA device); True on any
    other device raises, and a capture that fails raises."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_len: int, device: DeviceLike = None,
                 plan_request: Optional[PlanRequest] = None,
                 plan_store: Optional[PlanStore] = None,
                 plan_hw: Optional[HWConfig] = None,
                 plan_topology: Topology = Topology.AMP,
                 cuda_graph: Optional[bool] = None):
        require_servable(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        on_cuda = self.device.type == "cuda"
        self.cuda_graph = on_cuda if cuda_graph is None else bool(cuda_graph)
        if self.cuda_graph and not on_cuda:
            raise ValueError(f"cuda_graph=True needs a CUDA device, not "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, batch_slots, max_len, device=self.device)
        # the step's inputs, rows (tokens, cursors), filled by one copy a
        # tick from a host buffer (pinned on the card), and its output
        self._host_feed = torch.zeros((2, batch_slots), dtype=torch.int64,
                                      pin_memory=on_cuda)
        self._feed = torch.zeros((2, batch_slots), dtype=torch.int64,
                                 device=self.device)
        self._next: Optional[torch.Tensor] = None
        self.logits: Optional[torch.Tensor] = None    # last tick's, (B, V)
        # the plain and the instrumented graph, each with its outputs
        # (logits, argmax); the section marks' (name, event) in order
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._igraph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Tuple[torch.Tensor, ...] = ()
        self._iout: Tuple[torch.Tensor, ...] = ()
        self._marks: List[Tuple[str, torch.cuda.Event]] = []
        self._mark_at = 0
        self.log = telemetry.new_serve_log()
        self.queue: Deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * batch_slots
        # per-slot cursors
        self.pos = np.zeros(batch_slots, np.int64)        # next cache index
        self.remaining_prompt: List[List[int]] = [[] for _ in range(batch_slots)]
        self.generated = np.zeros(batch_slots, np.int32)
        self.ticks = 0
        self.truncated = False
        # optional accelerator plan for this model's decode step.  The
        # resolution order is the offline-plan -> online-serve path:
        #   1. a ``plan_store`` artifact matching ``plan_request`` exactly
        #      (zero planner invocations on a warm store);
        #   2. the shared ``Planner`` facade (identical engines hit the
        #      LRU plan cache instead of re-planning), after which the
        #      plan is saved back to the store for the next process.
        # ``plan_hw``/``plan_topology`` are the deprecated pre-request
        # knobs, kept as a shim; its request prices on the engine's device.
        if plan_hw is not None:
            if plan_request is not None:
                raise TypeError("pass plan_request or the deprecated "
                                "plan_hw/plan_topology, not both")
            warnings.warn(
                "ServeEngine(plan_hw=..., plan_topology=...) is "
                "deprecated; pass plan_request=PlanRequest(decode_graph("
                "cfg), hw=..., topology=...) (see docs/api.md)",
                PlanAPIDeprecationWarning, stacklevel=2)
            plan_request = PlanRequest(decode_graph(cfg), hw=plan_hw,
                                       topology=plan_topology,
                                       device=self.device.type)
        self.plan = None
        self.plan_source: Optional[str] = None
        self.plan_request = plan_request
        if plan_request is not None:
            if plan_store is not None:
                try:
                    self.plan = plan_store.load(plan_request)
                except PlanSchemaError:
                    self.plan = None   # stale-schema artifact: re-plan
                self.plan_source = "store" if self.plan is not None else None
            if self.plan is None:
                self.plan = get_planner().plan(plan_request)
                self.plan_source = "planner"
                if plan_store is not None:
                    plan_store.save(plan_request, self.plan)

    # -- device program ------------------------------------------------------
    @torch.inference_mode()
    def _device_step(self, cache) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step of every slot from the feed buffer, ``cache``
        written in place: (last logits (B, V), argmax (B,))."""
        tokens, index = self._feed[0][:, None], self._feed[1]
        logits, _ = decode_step(self.params, self.cfg, tokens, cache, index)
        logits = logits[:, -1, :]
        nxt = torch.argmax(logits, dim=-1)
        telemetry.mark(telemetry.END)
        return logits, nxt

    def _mark(self, section: str) -> None:
        """The section marks' sink: records the next of ``_marks``'
        events on the current stream (a new event the first time round,
        outside any capture; a captured step holds an event node)."""
        i = self._mark_at
        if i == len(self._marks):
            self._marks.append(
                (section, torch.cuda.Event(enable_timing=True,
                                           external=True)))
        elif self._marks[i][0] != section:
            raise RuntimeError(f"mark {i} is {section!r}, was "
                               f"{self._marks[i][0]!r}")
        self._marks[i][1].record()
        self._mark_at = i + 1

    def _marked_step(self, cache) -> Tuple[torch.Tensor, torch.Tensor]:
        """``_device_step`` with an event at each mark."""
        self._mark_at = 0
        with telemetry.marking(self._mark):
            return self._device_step(cache)

    def _capture(self) -> None:
        """Capture ``_device_step`` on the engine's cache in a CUDA graph
        with a private memory pool (freed with the engine), and the
        instrumented step (``_marked_step``) in a second graph in the same
        pool, after ``GRAPH_WARMUP_STEPS`` eager marked steps on a side
        stream: those run on a copy of the cache, since a step advances
        recurrent states.  The plain graph's outputs stay alive, so the
        second capture never reuses their memory; its own outputs may
        lie where the plain graph keeps its temporaries, and are read
        only right after its own replay."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            scratch = _clone(self.cache)
            for _ in range(GRAPH_WARMUP_STEPS):
                self._marked_step(scratch)
        torch.cuda.current_stream(self.device).wait_stream(side)
        del scratch
        graph, igraph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self._device_step(self.cache)
        with torch.cuda.graph(igraph, pool=graph.pool()):
            self._iout = self._marked_step(self.cache)
        self._graph, self._igraph = graph, igraph
        self.log.captures += 2

    # -- scheduling ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.log.submitted(req.rid, time.perf_counter(), len(req.prompt))
        self.queue.append(req)

    def _refill(self) -> None:
        for slot in range(self.B):
            if self.active[slot] is None and self.queue:
                req = self.queue.popleft()
                # every tick decodes every slot, idle ones too, so once a
                # tick has run a slot's rows are written: wipe them, so the
                # request neither attends to old keys nor carries old
                # recurrent state (the reference wipes only slots that held
                # a request, and an idle slot's state leaks into its first
                # request; ROADMAP.md Queue 3)
                if self.ticks:
                    self.cache = zero_cache_slot(self.cfg, self.cache, slot)
                    self.log.wiped += 1
                self.active[slot] = req
                self.remaining_prompt[slot] = list(req.prompt)
                self.pos[slot] = 0
                self.generated[slot] = 0
                self.log.admit(req.rid, time.perf_counter())

    @property
    def graph_replays(self) -> int:
        """Replays of the captured step, plain and instrumented."""
        return self.log.replays + self.log.instrumented_replays

    def step(self) -> List[Request]:
        """One engine tick: feed each slot its next token (prompt token if
        still prefilling, else the model's own last sample); returns any
        requests completed this tick."""
        start = time.perf_counter()
        with span("serve.step"):
            return self._step(start)

    def _step(self, start: float) -> List[Request]:
        log = self.log
        with span("serve.refill"):
            self._refill()
        self.ticks += 1
        with span("serve.feed"):
            feed = np.zeros((self.B, 1), np.int64)
            live = []
            prompt = 0
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                live.append(slot)
                if self.remaining_prompt[slot]:
                    feed[slot, 0] = self.remaining_prompt[slot].pop(0)
                    prompt += 1
                elif req.output:
                    feed[slot, 0] = req.output[-1]
                else:
                    # empty prompt: nothing to condition on — feed token 0
                    # (BOS convention) so generation starts from position 0
                    feed[slot, 0] = req.prompt[-1] if req.prompt else 0
            output = len(live) - prompt
            positions = int(self.pos[live].sum())

            # each slot decodes at its own cursor: the per-slot index
            # vector keeps a refilled slot's writes and causal mask at
            # *its* fill level, not the pool-wide maximum.  The host
            # buffer is free again: the last tick ended in a sync.
            self._host_feed[0] = torch.from_numpy(feed[:, 0])
            self._host_feed[1] = torch.from_numpy(self.pos)
            self._feed.copy_(self._host_feed, non_blocking=True)
        # section timings only under a profiler and on the card, every
        # other tick: a timed tick's events are read in the next tick,
        # while its step runs, and only then recorded again
        timed = (telemetry.profiling() and self.device.type == "cuda"
                 and not log.pending)
        with span("serve.launch"):
            if self.cuda_graph:
                if self._graph is None:
                    self._capture()
                if timed:
                    self._igraph.replay()
                    log.instrumented_replays += 1
                    self.logits, self._next = self._iout
                else:
                    self._graph.replay()
                    log.replays += 1
                    self.logits, self._next = self._out
            elif timed:
                self.logits, self._next = self._marked_step(self.cache)
            else:
                self.logits, self._next = self._device_step(self.cache)
        if log.pending:
            with span("serve.marks"):
                log.flush()
        with span("serve.readback"):
            nxt = self._next.cpu().numpy()

        with span("serve.book"):
            finished, firsts = [], []
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                self.pos[slot] += 1
                if self.remaining_prompt[slot]:
                    continue                     # still prefilling
                tok = int(nxt[slot])
                req.output.append(tok)
                if len(req.output) == 1:
                    firsts.append(req.rid)
                self.generated[slot] += 1
                hit_eos = req.eos_id is not None and tok == req.eos_id
                if (self.generated[slot] >= req.max_new_tokens or hit_eos
                        or self.pos[slot] >= self.max_len - 1):
                    req.done = True
                    finished.append(req)
                    self.active[slot] = None
            end = time.perf_counter()
            for rid in firsts:
                log.first_token(rid, end)
            for req in finished:
                log.finish(req.rid, end, len(req.output))
            row = log.tick(start, end, prompt, output,
                           self.B - prompt - output, positions)
            if timed:
                log.pend(row, self._marks)
        return finished

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        done: List[Request] = []
        ticks = 0
        self.truncated = False
        while (self.queue or any(self.active)) and ticks < max_ticks:
            done.extend(self.step())
            ticks += 1
        if self.queue or any(r is not None for r in self.active):
            self.truncated = True
            warnings.warn(
                f"ServeEngine.run() stopped at max_ticks={max_ticks} with "
                f"{len(self.queue)} queued and "
                f"{sum(r is not None for r in self.active)} active "
                "requests unfinished; results are truncated "
                '(see stats()["truncated"])', RuntimeWarning, stacklevel=2)
        return done

    def stats(self) -> Dict[str, float]:
        """Engine + (when planned) accelerator-model serving estimates."""
        out: Dict[str, float] = {
            "ticks": float(self.ticks),
            "queued": float(len(self.queue)),
            "active": float(sum(r is not None for r in self.active)),
            "truncated": float(self.truncated),
        }
        out.update((k, float(v)) for k, v in self.log.counters().items()
                   if k != "ticks")
        if self.plan is not None:
            cyc = self.plan.latency_cycles
            out["planned_cycles_per_token"] = cyc
            out["planned_dram_bytes_per_token"] = self.plan.dram_bytes
            out["planned_cycles_total"] = cyc * self.ticks
        return out


@dataclasses.dataclass
class Lane:
    """One tenant's serving lane: its engine plus scheduling weights.

    ``share`` weights the time-multiplexed round-robin; ``priority``
    orders admission (higher first).  ``deficit`` is the weighted
    round-robin credit counter (internal).
    """
    name: str
    engine: ServeEngine
    share: float = 1.0
    priority: int = 0
    deficit: float = dataclasses.field(default=0.0, compare=False)

    def __post_init__(self) -> None:
        if self.share <= 0:
            raise ValueError("lane share must be > 0")


class AdmissionScheduler:
    """Maps bursty request streams onto tenant lanes over one substrate.

    The execution-side counterpart of ``core.multi_tenant``: a resolved
    ``MultiTenantPlan`` says *how* the tenants share the array, and this
    scheduler drives their ``ServeEngine``s accordingly —

      * ``"spatial"`` — tenants sit on disjoint column bands, so every
        lane with work ticks each round (true concurrency);
      * ``"time"`` — one lane ticks per round, chosen by share-weighted
        deficit round-robin (each round every backlogged lane earns
        ``share`` credit; the largest credit runs and pays the total
        active share), so long-term tick rates converge to the shares;
      * ``"serialized"`` — strict priority order, shortest queue first
        within a priority level; a lane runs until it drains.

    Requests enter per-lane *pending* queues (``submit``) and are
    admitted into an engine only when it has a free decode slot — the
    engine-side queue never grows beyond the slot pool, so a burst on
    one tenant cannot occupy another tenant's admission window.
    """

    MODES = ("spatial", "time", "serialized")

    def __init__(self, lanes: List[Lane], mode: str = "spatial"):
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {self.MODES}")
        names = [l.name for l in lanes]
        if len(set(names)) != len(names):
            raise ValueError(f"lane names must be unique: {names}")
        self.lanes: Dict[str, Lane] = {l.name: l for l in lanes}
        self.mode = mode
        self.pending: Dict[str, Deque[Request]] = {n: deque() for n in names}
        self.done: Dict[str, List[Request]] = {n: [] for n in names}
        self.finish_tick: Dict[int, int] = {}      # rid -> scheduler tick
        self.ticks = 0
        self.truncated = False

    @classmethod
    def from_plan(cls, plan, engines: Dict[str, ServeEngine]
                  ) -> "AdmissionScheduler":
        """Build the scheduler a resolved ``MultiTenantPlan`` prescribes:
        one lane per tenant (its share/priority) in the plan's mode."""
        lanes = [Lane(t.name, engines[t.name], t.share, t.priority)
                 for t in plan.tenants]
        return cls(lanes, mode=plan.mode)

    # -- admission -----------------------------------------------------------
    def submit(self, lane: str, req: Request) -> None:
        self.pending[lane].append(req)

    def _admit(self) -> None:
        """Admit pending requests into engines with free decode slots, in
        lane priority order (higher first) so a high-priority tenant's
        burst is never starved by a lower-priority backlog."""
        for lane in sorted(self.lanes.values(),
                           key=lambda l: (-l.priority, l.name)):
            pend = self.pending[lane.name]
            eng = lane.engine
            free = (sum(r is None for r in eng.active) - len(eng.queue))
            while pend and free > 0:
                eng.submit(pend.popleft())
                free -= 1

    # -- scheduling ----------------------------------------------------------
    def _backlogged(self) -> List[Lane]:
        return [l for l in self.lanes.values()
                if self.pending[l.name] or l.engine.queue
                or any(r is not None for r in l.engine.active)]

    def _pick_time_sliced(self, ready: List[Lane]) -> Lane:
        for l in ready:
            l.deficit += l.share
        pick = max(ready, key=lambda l: (l.deficit, l.share, l.name))
        pick.deficit -= sum(l.share for l in ready)
        return pick

    def _pick_serialized(self, ready: List[Lane]) -> Lane:
        return min(ready, key=lambda l: (-l.priority, l.name))

    def step(self) -> List[Request]:
        """One scheduler round; returns requests completed this round."""
        self._admit()
        self.ticks += 1
        ready = self._backlogged()
        if not ready:
            return []
        if self.mode == "spatial":
            running = ready
        elif self.mode == "time":
            running = [self._pick_time_sliced(ready)]
        else:
            running = [self._pick_serialized(ready)]
        finished: List[Request] = []
        for lane in running:
            for req in lane.engine.step():
                self.done[lane.name].append(req)
                self.finish_tick[req.rid] = self.ticks
                finished.append(req)
        return finished

    def run(self, max_ticks: int = 100_000) -> Dict[str, List[Request]]:
        self.truncated = False
        ticks = 0
        while self._backlogged() and ticks < max_ticks:
            self.step()
            ticks += 1
        left = self._backlogged()
        if left:
            self.truncated = True
            warnings.warn(
                f"AdmissionScheduler.run() stopped at max_ticks="
                f"{max_ticks} with lanes {[l.name for l in left]} still "
                "backlogged; results are truncated "
                '(see stats()["truncated"])', RuntimeWarning, stacklevel=2)
        return self.done

    def stats(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "ticks": float(self.ticks),
            "truncated": float(self.truncated),
            "completed": float(sum(len(v) for v in self.done.values())),
        }
        for name, lane in sorted(self.lanes.items()):
            done = self.done[name]
            out[f"{name}.completed"] = float(len(done))
            out[f"{name}.pending"] = float(len(self.pending[name]))
            out[f"{name}.engine_ticks"] = float(lane.engine.ticks)
            if done:
                out[f"{name}.mean_finish_tick"] = float(
                    np.mean([self.finish_tick[r.rid] for r in done]))
        return out
