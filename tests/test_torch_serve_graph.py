"""The serving tick from static buffers, eager and as one CUDA graph.

``ServeEngine`` feeds its device step from two buffers that live as long
as the engine (tokens, per-slot cursors) and, on the card, replays the
step as one captured CUDA graph a tick (``cuda_graph``).  On the CPU the
static-buffer tick must give the tokens of a tick that makes its input
tensors afresh (``_FreshTensorEngine``, the step as it was written before
the buffers), also for requests refilled into a wiped slot;
``cuda_graph=True`` off the card raises.  On the card (marker ``cuda``,
skipped here) the graph engine's tokens and last logits must be the
eager engine's bits, at smoke width, for a dense, an rwkv6, a hybrid and
a MoE config.  No JAX here: the file runs on the machine with the card.

    python -m pytest -q -m cuda tests/test_torch_serve_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import decode_step, init_model
from repro_torch.runtime.serve_loop import (GRAPH_WARMUP_STEPS, Request,
                                            ServeEngine)

ARCHS = ["qwen2.5-3b", "rwkv6-1.6b", "recurrentgemma-2b",
         "granite-moe-1b-a400m"]


class _FreshTensorEngine(ServeEngine):
    """The tick as written before the static buffers: the feed and the
    cursors copied into new device tensors every tick, ``decode_step``
    called on them, the argmax read back."""

    def step(self):
        self._refill()
        self.ticks += 1
        feed = np.zeros((self.B, 1), np.int64)
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            if self.remaining_prompt[slot]:
                feed[slot, 0] = self.remaining_prompt[slot].pop(0)
            elif req.output:
                feed[slot, 0] = req.output[-1]
            else:
                feed[slot, 0] = req.prompt[-1] if req.prompt else 0
        index = torch.from_numpy(self.pos.copy()).to(self.device)
        tokens = torch.from_numpy(feed).to(self.device)
        with torch.inference_mode():
            logits, _ = decode_step(self.params, self.cfg, tokens,
                                    self.cache, index)
            nxt = torch.argmax(logits[:, -1, :], dim=-1).cpu().numpy()
        finished = []
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[slot] += 1
            if self.remaining_prompt[slot]:
                continue
            tok = int(nxt[slot])
            req.output.append(tok)
            self.generated[slot] += 1
            if (self.generated[slot] >= req.max_new_tokens
                    or self.pos[slot] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.active[slot] = None
        return finished


def _requests():
    """Five requests on two slots: three are refilled into a slot that
    an earlier request used (and the engine wiped)."""
    return [Request(rid=i, prompt=[3 + 2 * i, 7, 11 + i][:1 + i % 3],
                    max_new_tokens=3 + 2 * (i % 3)) for i in range(5)]


def _serve(engine):
    for r in _requests():
        engine.submit(r)
    done = engine.run()
    assert not engine.truncated and len(done) == 5
    return {r.rid: r.output for r in done}


def _model(arch, device, use_kernels):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              use_kernels=use_kernels)
    return init_model(cfg, seed=0, device=device), cfg


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_static_buffer_tick_gives_the_fresh_tensor_tokens(arch,
                                                          use_kernels):
    params, cfg = _model(arch, "cpu", use_kernels)
    new = ServeEngine(params, cfg, batch_slots=2, max_len=32, device="cpu")
    old = _FreshTensorEngine(params, cfg, batch_slots=2, max_len=32,
                             device="cpu")
    assert not new.cuda_graph and new.graph_replays == 0
    got, want = _serve(new), _serve(old)
    assert got == want
    assert new.ticks == old.ticks and new.graph_replays == 0
    assert new.logits.shape == (2, cfg.padded_vocab)


@pytest.mark.parametrize("arch", ARCHS[:2])
def test_cuda_graph_off_the_card_raises(arch):
    params, cfg = _model(arch, "cpu", False)
    with pytest.raises(ValueError, match="cuda_graph"):
        ServeEngine(params, cfg, batch_slots=2, max_len=16, device="cpu",
                    cuda_graph=True)
    with pytest.raises(ValueError, match="cuda_graph"):
        serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "1", "--max-new", "1",
                        "--cuda-graph"])


def test_serve_cli_takes_no_cuda_graph_on_cpu(capsys):
    serve_cli.main(["--smoke", "--device", "cpu", "--requests", "2",
                    "--max-new", "3", "--no-cuda-graph"])
    out = capsys.readouterr().out
    assert "served 2 requests / 6 tokens" in out and "cuda_graph=False" in out


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA graph replays on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_graph_engine_tokens_are_the_eager_bits(arch):
    """Graph and eager engines on the same weights answer the same
    requests with the same tokens, and their last tick's logits are the
    same bits; the graph engine replays its graph once a tick, and its
    kernels' wrappers count the warm-up steps and the capture only."""
    _need_card()
    params, cfg = _model(arch, "cuda", True)
    eager = ServeEngine(params, cfg, batch_slots=2, max_len=32,
                        cuda_graph=False)
    want = _serve(eager)
    graph = ServeEngine(params, cfg, batch_slots=2, max_len=32)
    assert graph.cuda_graph
    assert _serve(graph) == want
    assert graph.ticks == eager.ticks == graph.graph_replays
    assert torch.equal(graph.logits, eager.logits)
    # a wrapper counts where it launches: the warm-up steps and the
    # captures (the plain and the instrumented graph), not the replays
    from repro_torch.kernels.fused_mlp import fused_mlp
    if cfg.arch_kind == "dense":
        before = fused_mlp.launches
        again = ServeEngine(params, cfg, batch_slots=2, max_len=32)
        _serve(again)
        assert again.log.captures == 2
        assert (fused_mlp.launches - before
                == (GRAPH_WARMUP_STEPS + 2) * cfg.n_layers)
