"""The readers of the program's own tracing (``portbench/program.py``).

A smoke-sized traced run of each cell on the CPU gives every reader of
the engine's log and spans a value, except the decoder's sections,
which only the card times; the time from admission to the first token
is never longer than the time to first token.  Where there is nothing
to read (a program without the log, as before it had one; no tick or
request in the window; no instrumented tick; no profiled slice) each
reader gives None and raises nothing.
"""
import sys
import time
import types

import pytest
import torch

from portbench import catalog, program, readers, run
from portbench.tests.conftest import smoke_cell

NEW = ("mixer_ms_per_tick", "ffn_ms_per_tick", "prefill_share",
       "prefill_p95_ms", "engine_host_ms")


@pytest.mark.parametrize("name", catalog.workload_names())
def test_readers_read_a_smoke_run(name, smoke_sizes):
    cell, conf, mix = smoke_cell(name)
    metrics = [m for m in catalog.cell_metrics(catalog.benchmark(), name,
                                               True)
               if m["name"].split(".")[0] in NEW]
    out = run.measure(cell, conf, mix, 2**31 + 91, 2.0, True, metrics,
                      torch.device("cpu"), time.perf_counter())
    got = {k.split(".")[0]: v["value"] for k, v in out["metrics"].items()}
    want = {m["name"].split(".")[0] for m in metrics}
    assert set(got) == want - {"mixer_ms_per_tick", "ffn_ms_per_tick"}
    assert 0.0 < got["prefill_share"] < 100.0
    assert got["engine_host_ms"] > 0.0
    if "prefill_p95_ms" in want:
        assert 0.0 < got["prefill_p95_ms"] <= readers.ttft_p95_ms(
            out["record"])


def _reads_nothing(rec):
    for f in (program.mixer_ms_per_tick, program.ffn_ms_per_tick,
              program.prefill_share, program.prefill_p95_ms,
              program.engine_host_ms):
        assert f(rec) is None, f.__name__


def test_readers_read_nothing_where_there_is_nothing(monkeypatch):
    from portbench.drivers.serve import Served
    from repro_torch.runtime import telemetry
    rec = types.SimpleNamespace(window=(10.0, 20.0), trace=None,
                                requests=[Served(3, 12.0, 4, 8)])
    # a program without the log
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.telemetry", None)
    _reads_nothing(rec)
    monkeypatch.undo()
    # a log with no tick in the window, no instrumented tick, no row for
    # the request due; a profiled slice with no serve span
    log = telemetry.ServeLog()
    log.tick(1.0, 2.0, 1, 1, 0, 5)
    log.submitted(4, 1.0, 4)
    monkeypatch.setattr(telemetry, "_last", log)
    _reads_nothing(rec)
    rec.trace = {"units": [(0.0, 10.0)], "kernels": [],
                 "host": [("aten::add", 1.0, 2.0)]}
    _reads_nothing(rec)
