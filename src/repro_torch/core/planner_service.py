"""Planner facade: one entry point for all planning, keyed on PlanRequest.

Every call site — benchmarks, examples, the serving loop — plans through a
``Planner``.  A plan is a pure function of its ``PlanRequest`` (graph
fingerprint, hardware, topology, strategy, objective, constraints,
``sim_check``, burst budget), so the facade caches ``PlanResult``s under
the request itself: repeated planning of the same workload (figure sweeps
re-planning each task, a serving loop re-admitting the same model) becomes
a dictionary hit, which is what makes the planner cheap enough to run
inline rather than only offline.

    >>> from repro_torch.core import PlanRequest, Planner, PAPER_HW, Topology
    >>> planner = Planner(maxsize=64)
    >>> request = PlanRequest(graph, hw=PAPER_HW, topology=Topology.AMP)
    >>> plan = planner.plan(request)
    >>> planner.plan(request).latency_cycles   # cache hit, no re-planning

An attached ``PlanStore`` extends the cache to disk (the offline-plan ->
online-serve path): an LRU miss first consults the store, so a process
that inherits pre-planned artifacts never invokes a strategy function.

The legacy positional signature ``plan(graph, hw, topology, strategy,
sim_check)`` survives as a thin shim that emits
``PlanAPIDeprecationWarning`` and builds the equivalent request — same
cache, same results, one release of grace.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import warnings
from typing import Dict, Mapping, Optional, Tuple, Union

from .artifact import PlanSchemaError, PlanStore, SpanShelf
from .graph import Graph
from .hwconfig import HWConfig, PAPER_HW
from .noc import Topology, flow_batch_cache_info
from .plan_api import (PlanAPIDeprecationWarning, PlanRequest,
                       get_strategy, register_cache)
from .plan_api import cache_registry as _global_cache_registry
from . import planner as _planner  # noqa: F401  (registers the built-ins)
from .planner import PlanResult
from .simulator import (DEFAULT_MAX_BURSTS, ValidationReport, validate_plan)

CacheInfo = collections.namedtuple("CacheInfo",
                                   ["hits", "misses", "maxsize", "currsize"])

# the NoC flow-batch cache cannot register itself (noc.py sits below
# plan_api in the import DAG), so the facade module publishes it
register_cache("flow_batch", flow_batch_cache_info)


def _legacy_warn(what: str, instead: str) -> None:
    warnings.warn(
        f"{what} is deprecated; {instead} (see docs/api.md)",
        PlanAPIDeprecationWarning, stacklevel=3)


class Planner:
    """LRU-cached planning facade over the strategy registry.

    Thread-safe for lookups/insertions; a miss plans outside the lock, so
    two threads racing on the same key may both plan (last insert wins) —
    wasted work, never a wrong answer.
    """

    def __init__(self, maxsize: int = 128,
                 store: Optional[PlanStore] = None,
                 span_shelf: Optional[Union[SpanShelf, str]] = None,
                 verify: str = "off"):
        if verify not in ("off", "warn", "strict"):
            raise ValueError(f"verify={verify!r}; expected 'off', 'warn' "
                             "or 'strict'")
        self.maxsize = maxsize
        self.store = store
        self.verify = verify
        if span_shelf is not None:
            # the span shelf backs the DP's process-wide span cache, so
            # installing it here installs it for every planner in the
            # process (it is a content-addressed tier: different facades
            # sharing it can only ever help each other)
            if not isinstance(span_shelf, SpanShelf):
                span_shelf = SpanShelf(span_shelf)
            _planner.set_span_shelf(span_shelf)
        self._cache: "collections.OrderedDict[PlanRequest, PlanResult]" = \
            collections.OrderedDict()
        self._validate_cache: \
            "collections.OrderedDict[PlanRequest, ValidationReport]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._store_hits = 0

    # -- planning ------------------------------------------------------------
    def plan(self, request: Union[PlanRequest, Graph],
             hw: Optional[HWConfig] = None,
             topology: Optional[Topology] = None,
             strategy: Optional[str] = None,
             sim_check: Optional[bool] = None,
             verify: Optional[str] = None) -> PlanResult:
        """Plan one ``PlanRequest`` through the LRU cache (and the
        attached ``PlanStore``, if any).

        ``verify`` gates the static post-condition check
        (``core.verify.verify_plan`` — placement, routing, slot-DAG,
        byte-conservation and fold invariants; never the simulator):
        ``"off"`` skips it, ``"warn"`` emits a ``PlanVerifyWarning`` on
        error-severity findings, ``"strict"`` raises ``PlanVerifyError``.
        ``None`` defers to the planner-wide default set at construction.
        Only freshly planned or store-loaded results are verified — an
        LRU hit was already checked when it entered the cache.

        Passing a ``Graph`` plus the old positional knobs still works but
        is deprecated: the shim builds the equivalent request, so legacy
        and request-style calls share cache entries.
        """
        if isinstance(request, PlanRequest):
            if not (hw is None and topology is None and strategy is None
                    and sim_check is None):
                raise TypeError("pass either a PlanRequest or the legacy "
                                "(graph, hw, topology, strategy, sim_check) "
                                "arguments, not both")
            return self._plan_request(request, verify=verify)
        _legacy_warn("Planner.plan(graph, hw, topology, strategy, "
                     "sim_check)", "pass a PlanRequest")
        return self._plan_request(PlanRequest(
            graph=request, hw=hw if hw is not None else PAPER_HW,
            topology=topology,
            strategy=strategy if strategy is not None else "pipeorgan",
            sim_check=bool(sim_check)), verify=verify)

    def _plan_request(self, request: PlanRequest,
                      verify: Optional[str] = None) -> PlanResult:
        mode = self.verify if verify is None else verify
        if mode not in ("off", "warn", "strict"):
            raise ValueError(f"verify={mode!r}; expected 'off', 'warn' "
                             "or 'strict'")
        with self._lock:
            if request in self._cache:
                self._cache.move_to_end(request)
                self._hits += 1
                return self._cache[request]
            self._misses += 1
        result = None
        if self.store is not None:
            try:
                result = self.store.load(request)
            except PlanSchemaError:
                result = None     # stale-schema artifact: re-plan, don't die
            if result is not None:
                self._store_hits += 1
        if result is None:
            result = get_strategy(request.strategy).plan(request)
        if mode != "off":
            self._verify_result(result, request, mode)
        with self._lock:
            self._cache[request] = result
            self._cache.move_to_end(request)
            while len(self._cache) > self.maxsize:
                self._cache.popitem(last=False)
        return result

    @staticmethod
    def _verify_result(result: PlanResult, request: PlanRequest,
                       mode: str) -> None:
        from .verify import PlanVerifyWarning, verify_plan
        report = verify_plan(result, hw=request.hw,
                             topology=request.topology)
        if report.ok:
            return
        if mode == "strict":
            report.raise_if_errors()
        warnings.warn(f"plan verification found problems:\n"
                      f"{report.summary()}", PlanVerifyWarning,
                      stacklevel=4)

    def plan_all(self, graphs: Mapping[str, Graph],
                 template: Optional[PlanRequest] = None,
                 hw: Optional[HWConfig] = None,
                 topology: Optional[Topology] = None,
                 strategy: Optional[str] = None,
                 sim_check: Optional[bool] = None
                 ) -> Dict[str, PlanResult]:
        """Plan a workload suite (e.g. ``all_tasks()``) through the cache.

        ``template`` is a ``PlanRequest`` whose graph is replaced per
        task — every other knob (objective, constraints, ``sim_check``,
        burst budget) is honored as-is, which fixes the historical bug of
        this method silently dropping ``sim_check``.  The legacy keyword
        form still works (deprecated) and now forwards ``sim_check`` too.
        """
        if template is not None:
            if not (hw is None and topology is None and strategy is None
                    and sim_check is None):
                raise TypeError("pass either a template PlanRequest or "
                                "the legacy keywords, not both")
            return {name: self._plan_request(
                        dataclasses.replace(template, graph=g))
                    for name, g in graphs.items()}
        _legacy_warn("Planner.plan_all(graphs, hw, topology, strategy)",
                     "pass a template PlanRequest")
        return {name: self._plan_request(PlanRequest(
                    graph=g, hw=hw if hw is not None else PAPER_HW,
                    topology=topology,
                    strategy=strategy if strategy is not None
                    else "pipeorgan",
                    sim_check=bool(sim_check)))
                for name, g in graphs.items()}

    # -- differential validation ---------------------------------------------
    def validate(self, target, hw: Optional[HWConfig] = None,
                 topology: Optional[Topology] = None,
                 strategy: Optional[str] = None,
                 max_bursts: Optional[int] = None) -> ValidationReport:
        """Differential-test a plan against the event-driven simulator.

        Accepts a ``PlanRequest`` (planned through the cache, validated
        with the request's hardware and burst budget, and the report
        cached under the request), a ``PlanResult`` (simulated as-is), or
        — deprecated — a ``Graph`` plus the legacy knobs.  The report
        carries the declared error-band contract
        (``simulator.LATENCY_BAND``) plus per-segment analytical-vs-
        simulated latency, link-load and congestion verdicts.
        """
        if isinstance(target, PlanRequest):
            # plan identity normalizes max_bursts out under sim_check=False
            # (PlanRequest.plan_max_bursts), but validation budgets differ,
            # so the report cache keys on the actual budget too
            vkey = (target, target.max_bursts)
            with self._lock:
                if vkey in self._validate_cache:
                    self._validate_cache.move_to_end(vkey)
                    return self._validate_cache[vkey]
            plan = self._plan_request(target)
            report = validate_plan(plan, request=target)
            with self._lock:
                self._validate_cache[vkey] = report
                while len(self._validate_cache) > self.maxsize:
                    self._validate_cache.popitem(last=False)
            return report
        if isinstance(target, PlanResult):
            return validate_plan(
                target, hw if hw is not None else PAPER_HW,
                max_bursts if max_bursts is not None
                else DEFAULT_MAX_BURSTS)
        _legacy_warn("Planner.validate(graph, hw, topology, strategy)",
                     "pass a PlanRequest")
        return self.validate(PlanRequest(
            graph=target, hw=hw if hw is not None else PAPER_HW,
            topology=topology,
            strategy=strategy if strategy is not None else "pipeorgan",
            max_bursts=max_bursts))

    # -- cache management ----------------------------------------------------
    def cache_registry(self) -> Dict[str, object]:
        """Every cache provider visible to this planner: its own plan LRU,
        everything published through ``plan_api.register_cache`` (the DP's
        memoization layers, the NoC flow-batch cache, the simulator's
        transport programs, any strategy plugin's caches), and the
        attached ``PlanStore``.  Each provider is a zero-arg callable
        returning ``(hits, misses, maxsize, currsize)``.
        """
        reg: Dict[str, object] = {"plan": self._plan_cache_info}
        reg.update(_global_cache_registry())
        if self.store is not None:
            reg["plan_store"] = self.store.info
        return reg

    def _plan_cache_info(self) -> Tuple[int, int, int, int]:
        with self._lock:
            return (self._hits, self._misses, self.maxsize,
                    len(self._cache))

    @property
    def store_hits(self) -> int:
        """Plans served from the attached ``PlanStore`` instead of a
        strategy invocation."""
        return self._store_hits

    def cache_info(self, cache: str = "plan") -> CacheInfo:
        """Hit/miss/size statistics for any cache the planner stack uses.

        ``cache`` selects one of the layers ``cache_info_all`` reports;
        the default (``"plan"``) keeps the historical behavior — the
        facade's own plan LRU.
        """
        if cache == "plan":
            return CacheInfo(*self._plan_cache_info())
        try:
            return self.cache_info_all()[cache]
        except KeyError:
            raise ValueError(f"unknown cache {cache!r}; one of "
                             f"{sorted(self.cache_registry())}") from None

    def cache_info_all(self) -> Dict[str, CacheInfo]:
        """Every cache between a ``plan()`` call and the NoC engine,
        resolved through ``cache_registry()`` (so strategy plugins'
        registered caches appear here too)."""
        return {name: CacheInfo(*fn())
                for name, fn in self.cache_registry().items()}

    def clear_cache(self) -> None:
        with self._lock:
            self._cache.clear()
            self._validate_cache.clear()
            self._hits = 0
            self._misses = 0
            self._store_hits = 0


_default_planner = Planner()


def get_planner() -> Planner:
    """The process-wide shared ``Planner`` (benchmarks, serving, examples)."""
    return _default_planner
