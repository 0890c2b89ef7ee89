"""Tracing of the port from inside: host spans, decoder section marks, and
the serving engine's counters and rows.

- ``span(name)``: a host span.  While a ``torch.profiler`` runs it opens a
  profiler range, recorded on the clock of the device trace, so the
  profile puts the device's idle gaps down to the span that was open.
  Otherwise it costs one check.  The range is a plain function range
  (``_RecordFunctionFast``), not a ``record_function`` user range: the
  profiler adds no device-side copy of it to the kernels it records.
- ``mark(section)``: the boundary where a decoder section starts
  (``SECTIONS``; ``END`` closes the last).  It does nothing unless a sink
  is installed (``marking``); ``ServeEngine`` installs one that records a
  CUDA event, so that a captured graph holds an event node at each mark.
- ``ServeLog``: one engine's cumulative counters, one row a tick and one
  row a request, kept in preallocated numpy arrays that grow by doubling.
  ``last_serve_log()`` is the newest engine's log; it outlives the
  engine.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

#: the decoder's sections, in the order a decode step marks them:
#: ``embed`` before the embedding, ``mixer`` and ``ffn`` at the two halves
#: of each layer (each with its norm), ``head`` before the final norm
SECTIONS = ("embed", "mixer", "ffn", "head")
#: the closing mark, after the step's last operation
END = "end"

profiling: Callable[[], bool] = torch.autograd._profiler_enabled


class span:
    """``with span(name):`` a host span, recorded only while a profiler
    runs (see the module's docstring)."""
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if profiling():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


_sink: Optional[Callable[[str], None]] = None


def mark(section: str) -> None:
    """The start of ``section`` (or ``END``): passed to the installed
    sink, if any."""
    if _sink is not None:
        _sink(section)


@contextlib.contextmanager
def marking(sink: Callable[[str], None]) -> Iterator[None]:
    """Install ``sink`` for the marks made inside the block."""
    global _sink
    before, _sink = _sink, sink
    try:
        yield
    finally:
        _sink = before


def section_ms(marks: List[Tuple[str, "torch.cuda.Event"]]) -> List[float]:
    """Each of ``SECTIONS``' device ms, from the (section, event) pairs
    of a step's marks in order (the step has ended): the time from a
    mark to the next goes to the first's section."""
    ms = dict.fromkeys(SECTIONS, 0.0)
    for (name, a), (_, b) in zip(marks, marks[1:]):
        ms[name] += a.elapsed_time(b)
    return [ms[s] for s in SECTIONS]


def _grown(a: np.ndarray, n: int) -> np.ndarray:
    """``a`` itself, or a copy twice as long (rows past the old ones NaN),
    so that row ``n`` fits."""
    if n < len(a):
        return a
    out = np.full((2 * len(a),) + a.shape[1:], np.nan)
    out[:len(a)] = a
    return out


class ServeLog:
    """One ``ServeEngine``'s counters and rows (times on
    ``time.perf_counter``).

    Counters (``counters()``): ``ticks``; ``captures`` (CUDA graphs
    captured); ``replays`` and ``instrumented_replays`` (of the plain and
    of the instrumented graph); ``admitted`` (requests put in a slot);
    ``wiped`` (slots whose cache was cleared); ``finished``; and the
    slot-ticks, each slot of each tick once: ``prompt_slot_ticks`` (fed a
    prompt token), ``output_slot_ticks`` (fed the model's own last token),
    ``idle_slot_ticks``.

    Tick rows (``ticks()``, columns ``TICK_COLS``): start, end, the
    three slot counts, the sum of the active slots' positions and, on
    instrumented ticks (NaN on the others), each section's device ms,
    read from the tick's events once its step has ended (``pend``,
    ``flush``).

    Request rows (``requests()``, columns ``REQUEST_COLS``), one a
    ``rid`` (a rid submitted again takes a new row): submitted, admitted
    (when it took a slot), first (the end of the tick that
    returned the first output token), finished (the end of its last
    tick), prompt length, output tokens.  A time not reached yet is NaN.
    """
    TICK_COLS = ("start", "end", "prompt", "output", "idle",
                 "positions") + SECTIONS
    COUNTERS = ("captures", "replays", "instrumented_replays", "admitted",
                "wiped", "finished", "prompt_slot_ticks",
                "output_slot_ticks", "idle_slot_ticks")
    REQUEST_COLS = ("rid", "submitted", "admitted", "first", "finished",
                    "prompt_len", "n_out")

    def __init__(self, capacity: int = 1024):
        self.captures = self.replays = self.instrumented_replays = 0
        self.admitted = self.wiped = self.finished = 0
        self.prompt_slot_ticks = self.output_slot_ticks = 0
        self.idle_slot_ticks = 0
        self._ticks = np.full((capacity, len(self.TICK_COLS)), np.nan)
        self._reqs = np.full((capacity, len(self.REQUEST_COLS)), np.nan)
        self._nt = self._nr = 0
        self._row: Dict[int, int] = {}
        self.pending: Optional[tuple] = None

    # -- writes ------------------------------------------------------------
    def tick(self, start: float, end: float, prompt: int, output: int,
             idle: int, positions: int) -> int:
        """Append a tick's row; returns its index."""
        self._ticks = _grown(self._ticks, self._nt)
        self._ticks[self._nt, :6] = (start, end, prompt, output, idle,
                                     positions)
        self.prompt_slot_ticks += prompt
        self.output_slot_ticks += output
        self.idle_slot_ticks += idle
        self._nt += 1
        return self._nt - 1

    def pend(self, row: int, marks: List[Tuple[str, "torch.cuda.Event"]]
             ) -> None:
        """Tick ``row``'s sections are to be read from ``marks``, the
        (section, event) pairs its step recorded, by ``flush``: the
        events must not be recorded again before."""
        self.pending = (row, marks)

    def flush(self) -> None:
        """Read the pending tick's sections from its events (its step
        has ended) into its row."""
        if self.pending:
            row, marks = self.pending
            self._ticks[row, 6:] = section_ms(marks)
            self.pending = None

    def submitted(self, rid: int, t: float, prompt_len: int) -> None:
        self._reqs = _grown(self._reqs, self._nr)
        self._reqs[self._nr, [0, 1, 5, 6]] = (rid, t, prompt_len, 0)
        self._row[rid] = self._nr
        self._nr += 1

    def _set(self, rid: int, col: int, value: float) -> None:
        i = self._row.get(rid)
        if i is not None:
            self._reqs[i, col] = value

    def admit(self, rid: int, t: float) -> None:
        self.admitted += 1
        self._set(rid, 2, t)

    def first_token(self, rid: int, t: float) -> None:
        self._set(rid, 3, t)

    def finish(self, rid: int, t: float, n_out: int) -> None:
        self.finished += 1
        self._set(rid, 4, t)
        self._set(rid, 6, n_out)

    # -- reads -------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        return {"ticks": self._nt, **{k: getattr(self, k)
                                      for k in self.COUNTERS}}

    def ticks(self) -> Dict[str, np.ndarray]:
        """The tick rows, a column (a view) by name (after ``flush``)."""
        self.flush()
        t = self._ticks[:self._nt]
        return {c: t[:, i] for i, c in enumerate(self.TICK_COLS)}

    def requests(self) -> Dict[str, np.ndarray]:
        """The request rows, a column (a view) by name."""
        r = self._reqs[:self._nr]
        return {c: r[:, i] for i, c in enumerate(self.REQUEST_COLS)}


_last: Optional[ServeLog] = None


def new_serve_log() -> ServeLog:
    """A new log, which ``last_serve_log`` returns from now on."""
    global _last
    _last = ServeLog()
    return _last


def last_serve_log() -> Optional[ServeLog]:
    """The log of the newest ``ServeEngine`` made in this process."""
    return _last
