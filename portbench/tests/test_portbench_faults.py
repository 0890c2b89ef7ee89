"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at smoke size (``conftest.smoke_cell``), with one fault
planted in the program: a step that leaves the cache as it was; half
of the slots left out, the others' mean given to them; a token altered
where the engine samples it.  The cells run on one chip, so no exchange
between chips can be left out.  A sound run of each cell comes out
correct.
"""
import time

import pytest
import torch

from portbench import catalog, run
from portbench.tests.conftest import smoke_cell

CELLS = catalog.workload_names()


def _run(name):
    cell, conf, mix = smoke_cell(name)
    out = run.measure(cell, conf, mix, 2**31 + 77, 2.0, False, [],
                      torch.device("cpu"), time.perf_counter())
    return out["correct"], out["checks"]


def _frozen_cache(monkeypatch):
    from repro_torch.runtime import serve_loop
    step = serve_loop.decode_step

    def frozen(params, cfg, tokens, cache, index):
        logits, _ = step(params, cfg, tokens, serve_loop._clone(cache), index)
        return logits, cache

    monkeypatch.setattr(serve_loop, "decode_step", frozen)


def _half_slots(monkeypatch):
    from repro_torch.runtime import serve_loop
    step = serve_loop.decode_step

    def half(params, cfg, tokens, cache, index):
        h = tokens.shape[0] // 2
        part = {k: v[:, :h] for k, v in cache.items()}
        logits, _ = step(params, cfg, tokens[:h], part, index[:h])
        rest = logits.mean(0, keepdim=True).expand(
            tokens.shape[0] - h, *logits.shape[1:])
        return torch.cat([logits, rest]), cache

    monkeypatch.setattr(serve_loop, "decode_step", half)


def _altered_token(monkeypatch):
    from repro_torch.runtime.serve_loop import ServeEngine
    step = ServeEngine._device_step

    def altered(self, cache):
        logits, nxt = step(self, cache)
        nxt = nxt.clone()
        nxt[0] = (nxt[0] + 1) % self.cfg.vocab
        return logits, nxt

    monkeypatch.setattr(ServeEngine, "_device_step", altered)


FAULTS = {"state_unchanged": _frozen_cache,
          "half_batch": _half_slots,
          "token_altered": _altered_token}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_run_is_correct(name, smoke_sizes):
    correct, checks = _run(name)
    assert correct, checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered"])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_fault_is_not_correct(name, fault, monkeypatch, smoke_sizes):
    FAULTS[fault](monkeypatch)
    correct, checks = _run(name)
    assert not correct, checks
