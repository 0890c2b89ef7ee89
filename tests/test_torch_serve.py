"""The port's continuous-batching engine against the JAX engine, on the CPU.

float32 qwen2.5-3b ``SMOKE`` with the same parameters on both sides
(greedy ``argmax`` ties flip under bf16).  Each scenario of
``tests/test_serve.py`` runs on the port, and its tokens must equal the
JAX engine's.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_model as jax_init_model
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import ServeEngine as JServeEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import params_from_jax
from repro_torch.runtime.serve_loop import Request, ServeEngine

ARCH = "qwen2.5-3b"


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               dtype=torch.float32)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _engine(slots, max_len):
    _, _, tcfg, tp = _setup()
    return ServeEngine(tp, tcfg, batch_slots=slots, max_len=max_len,
                       device="cpu")


def _serve(reqs, slots, max_len):
    """{rid: output} from the port's engine and from the JAX engine."""
    jcfg, jp, _, _ = _setup()
    outs = []
    for eng, R in ((_engine(slots, max_len), Request),
                   (JServeEngine(jp, jcfg, batch_slots=slots,
                                 max_len=max_len), JRequest)):
        for r in reqs:
            eng.submit(R(rid=r.rid, prompt=list(r.prompt),
                         max_new_tokens=r.max_new_tokens, eos_id=r.eos_id))
        outs.append({r.rid: r.output for r in eng.run()})
    return outs


def _solo(req, max_len=64):
    eng = _engine(1, max_len)
    eng.submit(Request(rid=req.rid, prompt=list(req.prompt),
                       max_new_tokens=req.max_new_tokens))
    return eng.run()[0].output


def test_engine_completes_all_requests():
    reqs = [Request(rid=i, prompt=[3 + i, 7, 11], max_new_tokens=5)
            for i in range(5)]               # more requests than slots
    port, ref = _serve(reqs, slots=2, max_len=64)
    assert port == ref
    assert sorted(port) == list(range(5))
    vocab = _setup()[2].vocab
    for out in port.values():
        assert len(out) == 5 and all(0 <= t < vocab for t in out)


def test_engine_respects_budgets():
    reqs = [Request(rid=0, prompt=[1], max_new_tokens=3),
            Request(rid=1, prompt=[2, 3], max_new_tokens=7)]
    port, ref = _serve(reqs, slots=1, max_len=64)
    assert port == ref
    assert [len(port[0]), len(port[1])] == [3, 7]


def test_engine_eos_stops_early():
    first = _solo(Request(rid=0, prompt=[5, 9], max_new_tokens=1))[0]
    req = Request(rid=1, prompt=[5, 9], max_new_tokens=50, eos_id=first)
    port, ref = _serve([req], slots=1, max_len=64)
    assert port == ref
    assert port[1][-1] == first and len(port[1]) < 50


def test_refilled_slot_output_bit_equal_to_solo():
    """Staggered arrivals through a 2-slot pool: every request, in
    particular every one refilled into a used slot, produces exactly the
    tokens it produces alone, and the tokens of the JAX engine."""
    reqs = [Request(rid=i, prompt=[3 + 2 * i, 7, 11 + i][: 1 + i % 3],
                    max_new_tokens=4 + i % 3) for i in range(6)]
    port, ref = _serve(reqs, slots=2, max_len=64)
    assert port == ref
    for r in reqs:
        assert port[r.rid] == _solo(r), r.rid


def test_empty_prompt_request():
    reqs = [Request(rid=0, prompt=[], max_new_tokens=4),
            Request(rid=1, prompt=[4, 8], max_new_tokens=4)]
    port, ref = _serve(reqs, slots=2, max_len=32)
    assert port == ref
    assert len(port[0]) == 4
    assert port[1] == _solo(reqs[1], max_len=32)


def test_max_len_boundary_truncates_generation():
    prompt = list(range(1, 11))              # 10 prompt tokens
    reqs = [Request(rid=0, prompt=prompt, max_new_tokens=50),
            Request(rid=1, prompt=[6, 2], max_new_tokens=5)]
    port, ref = _serve(reqs, slots=1, max_len=16)
    assert port == ref
    assert len(prompt) + len(port[0]) <= 16 and len(port[0]) < 50
    # the slot freed by the cut serves its next occupant as if alone
    assert port[1] == _solo(reqs[1], max_len=16)


def test_run_truncation_signal():
    eng = _engine(1, 32)
    eng.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=10))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng.run(max_ticks=3)
    assert eng.stats()["truncated"] == 1.0
    assert any("truncated" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        done = eng.run()
    assert eng.stats()["truncated"] == 0.0
    assert not caught
    assert len(done) == 1


def test_engine_rejects_params_on_another_device():
    _, _, tcfg, tp = _setup()
    with pytest.raises(ValueError, match="params lie on"):
        ServeEngine({**tp, "embed": tp["embed"].to("meta")}, tcfg,
                    batch_slots=1, max_len=8, device="cpu")


def test_serve_cli_smoke_on_cpu(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                    "--max-new", "4", "--use-kernels"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    assert "use_kernels=True" in out
