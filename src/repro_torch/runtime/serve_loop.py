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
(``require_servable``).  The planner hooks (``plan_request``,
``decode_graph``, ``Lane``, ``AdmissionScheduler``) are not ported yet
(``ROADMAP.md``).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.common import DeviceLike, ModelConfig, resolve_device
from repro_torch.models.transformer import (decode_step, init_cache,
                                            zero_cache_slot)


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


class ServeEngine:
    """Continuous-batching engine over a fixed slot pool, on ``device``
    (``cuda`` unless the caller passes another).  ``params`` must already
    lie on that device."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_len: int, device: DeviceLike = None):
        require_servable(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.max_len = max_len
        self.cache = init_cache(cfg, batch_slots, max_len, device=self.device)
        self.queue: Deque[Request] = deque()
        self.active: List[Optional[Request]] = [None] * batch_slots
        # per-slot cursors
        self.pos = np.zeros(batch_slots, np.int64)        # next cache index
        self.remaining_prompt: List[List[int]] = [[] for _ in range(batch_slots)]
        self.generated = np.zeros(batch_slots, np.int32)
        self.ticks = 0
        self.truncated = False

    # -- device program ------------------------------------------------------
    @torch.inference_mode()
    def _device_step(self, tokens: torch.Tensor, index: torch.Tensor
                     ) -> torch.Tensor:
        logits, self.cache = decode_step(self.params, self.cfg, tokens,
                                         self.cache, index)
        return torch.argmax(logits[:, -1, :], dim=-1)

    # -- scheduling ----------------------------------------------------------
    def submit(self, req: Request) -> None:
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
                self.active[slot] = req
                self.remaining_prompt[slot] = list(req.prompt)
                self.pos[slot] = 0
                self.generated[slot] = 0

    def step(self) -> List[Request]:
        """One engine tick: feed each slot its next token (prompt token if
        still prefilling, else the model's own last sample); returns any
        requests completed this tick."""
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
                # empty prompt: nothing to condition on — feed token 0
                # (BOS convention) so generation starts from position 0
                feed[slot, 0] = req.prompt[-1] if req.prompt else 0

        # each slot decodes at its own cursor: the per-slot index vector
        # keeps a refilled slot's writes and causal mask at *its* fill
        # level, not the pool-wide maximum
        index = torch.from_numpy(self.pos.copy()).to(self.device)
        tokens = torch.from_numpy(feed).to(self.device)
        nxt = self._device_step(tokens, index).cpu().numpy()

        finished = []
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[slot] += 1
            if self.remaining_prompt[slot]:
                continue                     # still prefilling
            tok = int(nxt[slot])
            req.output.append(tok)
            self.generated[slot] += 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if (self.generated[slot] >= req.max_new_tokens or hit_eos
                    or self.pos[slot] >= self.max_len - 1):
                req.done = True
                finished.append(req)
                self.active[slot] = None
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
        return {
            "ticks": float(self.ticks),
            "queued": float(len(self.queue)),
            "active": float(sum(r is not None for r in self.active)),
            "truncated": float(self.truncated),
        }
