"""Batched request engine (continuous batching, demo-grade; port of
`repro.serving.lm_demo.engine`).

A fixed pool of decode slots; incoming requests are prefilled into a free
slot and decoded step-by-step alongside the other active slots.  Greedy
sampling; slots retire on EOS, on max_new_tokens, or one short of max_seq.
Per-slot prefill is teacher-forced batch-1 decode steps, as the reference's
(production would batch prefill separately).

Every step decodes all slots at ONE position, the largest of the active
slots' (`step`), as the reference does: a slot admitted later writes its KV
at that position and attends over the zero entries before it.

The params are cast to the compute dtype once, here (`Model._lowp`); the
per-step cast inside `decode_step` then finds them cast and copies nothing.
The reference casts inside every step, which on the card would read and
write the fp32 masters each step, about 4x a decode step's own weight
traffic; the cast is idempotent, so the results are bitwise the same.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import Model

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 16
    eos_id: int = -1  # -1: never stop early
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params,
        *,
        slots: int = 4,
        max_seq: int = 256,
    ):
        self.model = model
        self.params = model._lowp(params)
        self.device = self.params["embed"].device
        self.slots = slots
        self.max_seq = max_seq
        self.queue: deque[Request] = deque()
        self.active: list[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, dtype=np.int32)
        self.cache = model.init_cache(slots, max_seq, device=self.device)

    @torch.no_grad()
    def _prefill_one(self, params, tokens: torch.Tensor):
        """Prefill one prompt [S] by teacher-forced decode steps; returns the
        slot's cache and the last position's logits."""
        cache1 = self.model.init_cache(1, self.max_seq, device=self.device)
        for t in range(tokens.shape[0]):
            logits, cache1 = self.model.decode_step(params, tokens[t:t + 1][None], t, cache1)
        return cache1, logits[0, -1]

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                tokens = torch.as_tensor(np.asarray(req.prompt, np.int32), device=self.device)
                cache1, last_logits = self._prefill_one(self.params, tokens)
                # splice the slot-local cache into the batch cache
                for name, leaf in self.cache.items():
                    leaf[:, s : s + 1] = cache1[name]
                nxt = int(torch.argmax(last_logits))
                req.out_tokens.append(nxt)
                self.active[s] = req
                self.pos[s] = len(req.prompt)

    @torch.no_grad()
    def step(self) -> int:
        """One engine step: admit + one batched decode. Returns #active."""
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        tokens = np.zeros((self.slots, 1), dtype=np.int32)
        for s, r in enumerate(self.active):
            if r is not None and r.out_tokens:
                tokens[s, 0] = r.out_tokens[-1]
        pos = int(max(self.pos[s] for s, r in enumerate(self.active) if r))
        logits, self.cache = self.model.decode_step(
            self.params, torch.as_tensor(tokens, device=self.device), pos, self.cache
        )
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
        n_active = 0
        for s, r in enumerate(self.active):
            if r is None:
                continue
            r.out_tokens.append(int(nxt[s]))
            self.pos[s] += 1
            if (
                len(r.out_tokens) >= r.max_new_tokens
                or int(nxt[s]) == r.eos_id
                or self.pos[s] >= self.max_seq - 1
            ):
                r.done = True
                self.active[s] = None
            else:
                n_active += 1
        return n_active

    def run(self) -> None:
        while self.queue or any(r is not None for r in self.active):
            self.step()

