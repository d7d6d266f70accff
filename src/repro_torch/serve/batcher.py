"""Continuous batching: slot-based serving with per-sequence positions.

Port of ``repro.serve.batcher`` for every model the port builds.  A fixed
pool of ``max_slots`` cache slots, each with its own decode position; new
requests are admitted into free slots mid-flight (their prompt is replayed
through the same batched decode step while other slots keep generating)
and finished slots are recycled.  The slot axis is structural here: it is
axis 0 of every per-layer self-attention or Mamba cache tensor (K/V ring
buffers, MLA latents, conv histories and SSM state).  Cross-attention K/V,
precomputed from ``context`` (one shared context of ``max_slots`` rows, as
in the JAX package: there is no per-request context), have no slot axis
and are kept across slot reuse.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.types import ModelConfig
from repro_torch.models.transformer import decode_step, init_cache
from repro_torch.serve.step import full_logits


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # request lifecycle in batcher step indices: admission into a slot,
    # first emitted token, completion
    t_admit: Optional[int] = None
    t_first: Optional[int] = None
    t_finish: Optional[int] = None


class ContinuousBatcher:
    def __init__(self, cfg: ModelConfig, params, max_slots: int,
                 max_len: int, context=None, temperature: float = 0.0,
                 seed: int = 0, cache_dtype=torch.float32, ctx=None):
        self.cfg = cfg
        self.ctx = ctx
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = params["embed"].device
        # the slots are this rank's own: its share of the data ranks'
        self.cache = init_cache(cfg, params,
                                max_slots * (ctx.dp if ctx else 1), max_len,
                                dtype=cache_dtype, context=context,
                                ctx=ctx)
        self.pos = np.zeros(max_slots, np.int64)  # next write position
        self.slot_req: List[Optional[Request]] = [None] * max_slots
        self.slot_pending: List[List[int]] = [[] for _ in range(max_slots)]
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.steps = 0  # decode steps executed; indexes request lifecycle

    def submit(self, prompt: List[int], max_new: int, rid: int) -> None:
        # one slot must stay free to generate into
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"request {rid}: prompt has {len(prompt)} tokens but "
                f"max_len={self.max_len} leaves room for at most "
                f"{self.max_len - 1}; truncate the prompt or raise max_len")
        self.queue.append(Request(rid, list(prompt), max_new))

    def _reset_slot_state(self, slot: int) -> None:
        """Zero a recycled slot's cache in place.  Required for Mamba layers:
        their conv history and SSM state carry the previous request and do
        not self-invalidate from the position (the K/V ring buffers and MLA
        latents do).  Cross-attention K/V (no slot axis) stay."""
        for spec, layer in zip(self.cfg.layer_specs(), self.cache["layers"]):
            if spec.mixer != "cross_attn":
                for t in layer.values():
                    t[slot].zero_()

    def _admit(self) -> None:
        for s in range(self.max_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                req.t_admit = self.steps
                self.slot_req[s] = req
                self.slot_pending[s] = list(req.prompt)
                self.pos[s] = 0
                self._reset_slot_state(s)

    @property
    def active(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def step(self) -> Dict[int, int]:
        """One batched decode step across all slots.  Slots still replaying
        their prompt feed the next prompt token; generating slots feed
        their previous output.  Returns {rid: emitted_token}."""
        self._admit()
        tokens = np.zeros((self.max_slots, 1), np.int64)
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.slot_pending[s]:
                tokens[s, 0] = self.slot_pending[s][0]
            elif req.out:
                tokens[s, 0] = req.out[-1]
        pos = torch.from_numpy(np.minimum(self.pos, self.max_len - 1))
        logits, self.cache = decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(tokens).to(self.device), pos.to(self.device),
            ctx=self.ctx)
        last = full_logits(self.cfg, logits, self.ctx)[:, 0, :]
        if self.temperature > 0:
            probs = torch.softmax(last.float() / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        nxt = nxt.cpu().numpy()

        emitted: Dict[int, int] = {}
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            if self.slot_pending[s]:
                self.slot_pending[s].pop(0)
                self.pos[s] += 1
                if not self.slot_pending[s]:
                    # prompt fully ingested: this step's logits are the
                    # first generation
                    tok = int(nxt[s])
                    if not req.out:
                        req.t_first = self.steps
                    req.out.append(tok)
                    emitted[req.rid] = tok
            else:
                tok = int(nxt[s])
                self.pos[s] += 1
                if not req.out:
                    req.t_first = self.steps
                req.out.append(tok)
                emitted[req.rid] = tok
            if len(req.out) >= req.max_new or \
                    self.pos[s] >= self.max_len - 1:
                req.done = True
                req.t_finish = self.steps
                self.completed.append(req)
                self.slot_req[s] = None
        self.steps += 1
        return emitted

    def run(self, max_steps: int = 10_000) -> List[Request]:
        steps = 0
        while self.active and steps < max_steps:
            self.step()
            steps += 1
        return self.completed
