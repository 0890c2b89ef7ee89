"""Tracing of the serving path from inside the port (``runtime.telemetry``).

On the CPU: a span records nothing without a profiler, and under one the
``serve.*`` spans of an eager tick nest under ``serve.step`` as function
ranges (no device-side copy); ``adamw.apply_updates`` keeps its name;
one ``decode_step`` marks its sections in order for every servable arch
at smoke size; the engine's counters and rows hold their invariants over
a smoke run, and its log outlives it.  On the card (marker ``cuda``,
skipped here): the instrumented graph gives the plain graph's bits, its
sections sum to its events' span, and an untraced run replays only the
plain graph.  No JAX here: the file runs on the machine with the card.

    python -m pytest -q -m cuda tests/test_torch_telemetry.py
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decode_step, init_cache, init_model
from repro_torch.optim import adamw
from repro_torch.runtime import telemetry
from repro_torch.runtime.serve_loop import Request, ServeEngine

SERVABLE = sorted(a for a in ARCHS
                  if get_config(a, smoke=True).arch_kind != "encdec")
STEP_SPANS = {"serve.refill", "serve.feed", "serve.launch",
              "serve.readback", "serve.book"}


def _model(arch="qwen2.5-3b", device="cpu", use_kernels=False):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              use_kernels=use_kernels)
    return init_model(cfg, seed=0, device=device), cfg


def _requests(n=5):
    """Prompts of 1 to 4 tokens, 2 to 6 outputs."""
    return [Request(rid=10 + i, prompt=[3 + i, 7, 11, 5][:1 + i % 4],
                    max_new_tokens=2 + i % 5) for i in range(n)]


def test_span_records_nothing_without_a_profiler(monkeypatch):
    def refuse(name):                        # pragma: no cover
        raise AssertionError("a range was opened with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert not telemetry.profiling()
    with telemetry.span("serve.step") as s:
        assert s._range is None


def test_serve_spans_nest_under_the_step():
    params, cfg = _model()
    engine = ServeEngine(params, cfg, batch_slots=2, max_len=32,
                         device="cpu")
    for r in _requests(3):
        engine.submit(r)
    engine.step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step()
    spans = [e for e in prof.events() if e.name.startswith("serve.")]
    assert {e.name for e in spans} == STEP_SPANS | {"serve.step"}
    for e in spans:
        # a function range: the profiler makes no device-side copy of it
        assert e.scope == 0, (e.name, e.scope)
        if e.name != "serve.step":
            assert e.cpu_parent.name == "serve.step", e.name
    # off the card no section is timed: no marks span, no instrumented tick
    assert engine.log.instrumented_replays == 0
    assert np.isnan(engine.log.ticks()["mixer"]).all()


def test_adamw_span_keeps_its_name():
    cfg = adamw.AdamWConfig()
    params = {"w": torch.ones(4, 4)}
    grads = {"w": torch.full((4, 4), 0.1)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        adamw.apply_updates(cfg, params, grads, adamw.init_state(params))
    names = [e.name for e in prof.events()]
    assert names.count("adamw.apply_updates") == 1


def test_marks_do_nothing_without_a_sink():
    telemetry.mark("embed")
    seen = []
    with pytest.raises(RuntimeError):
        with telemetry.marking(seen.append):
            telemetry.mark("head")
            raise RuntimeError
    telemetry.mark("ffn")
    assert seen == ["head"] and telemetry._sink is None


@pytest.mark.parametrize("arch", SERVABLE)
def test_decode_step_marks_its_sections(arch):
    params, cfg = _model(arch)
    cache = init_cache(cfg, 2, 16, device="cpu")
    seen = []
    with torch.inference_mode(), telemetry.marking(seen.append):
        decode_step(params, cfg, torch.tensor([[3], [5]]), cache,
                    torch.tensor([0, 2]))
    want = ["embed"] + ["mixer", "ffn"] * cfg.n_layers + ["head"]
    assert seen == want
    # the engine's step closes the last section
    engine = ServeEngine(params, cfg, batch_slots=2, max_len=16,
                         device="cpu")
    seen.clear()
    with telemetry.marking(seen.append):
        engine._device_step(engine.cache)
    assert seen == want + [telemetry.END]


def test_counters_and_rows_hold_over_a_smoke_run():
    params, cfg = _model()
    B = 2
    engine = ServeEngine(params, cfg, batch_slots=B, max_len=32,
                         device="cpu")
    reqs = _requests(5)
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert len(done) == len(reqs)
    c = engine.log.counters()
    assert c["ticks"] == engine.ticks
    assert (c["prompt_slot_ticks"] + c["output_slot_ticks"]
            + c["idle_slot_ticks"] == engine.ticks * B)
    # a request feeds each prompt token once, then each output but its
    # last
    assert c["prompt_slot_ticks"] == sum(len(r.prompt) for r in reqs)
    assert c["output_slot_ticks"] == sum(len(r.output) - 1 for r in reqs)
    assert c["admitted"] == c["finished"] == len(reqs)
    assert c["wiped"] == len(reqs) - B      # every refill after the first
    assert c["captures"] == c["replays"] == c["instrumented_replays"] == 0
    st = engine.stats()
    assert all(st[k] == float(v) for k, v in c.items())

    rows = engine.log.requests()
    assert rows["rid"].tolist() == [r.rid for r in reqs]
    assert rows["prompt_len"].tolist() == [len(r.prompt) for r in reqs]
    assert rows["n_out"].tolist() == [len(r.output) for r in reqs]
    assert (np.diff(np.stack([rows[k] for k in ("submitted", "admitted",
                                                "first", "finished")]),
                    axis=0) >= 0).all()
    t = engine.log.ticks()
    assert (t["prompt"] + t["output"] + t["idle"] == B).all()
    assert (t["end"] >= t["start"]).all() and (np.diff(t["start"]) > 0).all()


def test_positions_are_the_active_slots_cursors():
    params, cfg = _model()
    engine = ServeEngine(params, cfg, batch_slots=2, max_len=32,
                         device="cpu")
    engine.submit(Request(rid=0, prompt=[3, 7, 11], max_new_tokens=4))
    engine.run()
    t = engine.log.ticks()
    assert t["positions"].tolist() == [0, 1, 2, 3, 4, 5]
    assert t["prompt"].tolist() == [1, 1, 1, 0, 0, 0]
    assert t["idle"].tolist() == [1] * 6


def test_log_grows_and_outlives_its_engine():
    log = telemetry.ServeLog(capacity=2)
    for i in range(5):
        log.submitted(i, float(i), 3)
        log.tick(float(i), i + 0.5, 1, 0, 1, i)
    assert log.ticks()["positions"].tolist() == [0, 1, 2, 3, 4]
    assert log.requests()["rid"].tolist() == [0, 1, 2, 3, 4]
    assert np.isnan(log.requests()["first"]).all()

    params, cfg = _model()
    engine = ServeEngine(params, cfg, batch_slots=2, max_len=16,
                         device="cpu")
    engine.submit(Request(rid=7, prompt=[3], max_new_tokens=2))
    engine.run()
    del engine
    gc.collect()
    last = telemetry.last_serve_log()
    assert last.counters()["finished"] == 1
    assert last.requests()["rid"].tolist() == [7]


class _Event:
    """A stand-in for a CUDA event: its time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_pending_sections_are_read_on_flush():
    log = telemetry.ServeLog()
    row = log.tick(0.0, 1.0, 1, 1, 0, 3)
    marks = [("embed", _Event(0.0)), ("mixer", _Event(0.5)),
             ("ffn", _Event(2.5)), ("mixer", _Event(3.0)),
             ("ffn", _Event(5.0)), ("head", _Event(5.5)),
             (telemetry.END, _Event(6.25))]
    log.pend(row, marks)
    assert log.pending
    t = log.ticks()                     # reading flushes
    assert not log.pending
    assert [t[s][0] for s in telemetry.SECTIONS] == [0.5, 4.0, 1.0, 0.75]


def test_serve_cli_prints_the_counters(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "2",
                    "--max-new", "3"])
    out = capsys.readouterr().out
    assert "engine: ticks=" in out and " admitted=2 " in out


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA graph replays on the card)")


@pytest.mark.cuda
def test_instrumented_graph_gives_the_plain_bits():
    """Two graph engines on the same weights and requests, one never
    traced, the other under a profiler from its third tick to its
    eighth: the same tokens and logits tick by tick.  Under the profiler
    every other tick replays the instrumented graph, whose sections sum
    to its events' first-to-last span; the untraced engine replays only
    the plain graph."""
    _need_card()
    params, cfg = _model(device="cuda", use_kernels=True)
    plain = ServeEngine(params, cfg, batch_slots=2, max_len=32)
    traced = ServeEngine(params, cfg, batch_slots=2, max_len=32)
    want = []
    for r in _requests(5):
        plain.submit(r)
    while plain.queue or any(r is not None for r in plain.active):
        plain.step()
        want.append((plain.logits.clone(), plain._next.clone()))
    for r in _requests(5):
        traced.submit(r)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    for ticks, (logits, nxt) in enumerate(want):
        if ticks == 2:
            prof.start()
        traced.step()
        if ticks == 7:
            prof.stop()
        assert torch.equal(traced.logits, logits), ticks
        assert torch.equal(traced._next, nxt), ticks
    ticks = len(want)
    assert ticks > 8 and not traced.queue
    assert all(r is None for r in traced.active)
    rows = traced.log.ticks()
    timed = ~np.isnan(rows["mixer"])
    assert np.flatnonzero(timed).tolist() == [2, 4, 6]
    assert all((rows[s][timed] > 0).all() for s in telemetry.SECTIONS)
    span = traced._marks[0][1].elapsed_time(traced._marks[-1][1])
    total = sum(rows[s][6] for s in telemetry.SECTIONS)
    assert abs(total - span) <= 0.02 * span, (total, span)
    assert plain.log.instrumented_replays == 0
    assert plain.log.replays == plain.ticks == ticks
    assert traced.log.instrumented_replays == 3
    assert traced.graph_replays == ticks
    assert plain.log.captures == traced.log.captures == 2
