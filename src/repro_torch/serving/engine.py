"""Slot-based batched serving engine (continuous batching) — counterpart
of :mod:`repro.serving.engine`.

The engine owns a fixed decode batch of ``n_slots`` sequences sharing
one ring KV cache per layer.  Requests queue up; a free slot is filled by
a single-sequence prefill whose KV is scattered into the slot; every
tick runs one batched decode step for all slots.  Greedy sampling
(argmax) by default; ``temperature > 0`` samples from a seeded
``torch.Generator``.

It runs eagerly (the reference jits its decode step).  Every prefill
attends through K2 (``impl="kernel"``, whose wrapper takes its plain
version on CPU tensors); decode attends with materialised scores over
the cache, as in the reference.  An SSM layer's cache is its state ``h``
and conv history ``conv``, scattered into the slot like a KV cache; it
prefills with the chunked scan and decodes with the one-step recurrence.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, params, *, n_slots: int, cache_len: int,
                 eos_id: int | None = None, temperature: float = 0.0,
                 compute_dtype=torch.float32, seed: int = 0) -> None:
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.compute_dtype = compute_dtype
        self.caches = model.init_cache(n_slots, cache_len,
                                       dtype=compute_dtype,
                                       device=self.device)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)
        self.slot_last = np.zeros(n_slots, np.int64)
        self.queue: list[Request] = []
        self._finished: list[Request] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    # --------------------------------------------------------- admission --
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _admit(self) -> None:
        for slot in self._free_slots():
            # A request may finish at prefill (max_new_tokens=1 or a
            # prefill EOS): keep admitting into this slot until one
            # survives to decode, so no slot idles while work queues.
            while self.queue:
                req = self.queue.pop(0)
                self._prefill_into_slot(slot, req)
                if self.slot_req[slot] is not None:
                    break

    def _scatter_into_slot(self, slot: int, cache1: dict) -> None:
        """Write a one-sequence cache into batch row ``slot``, in place.
        ``slot*`` caches carry a leading period dim before the batch dim;
        ``tail*`` caches start with the batch dim."""
        for key, one in cache1.items():
            full = self.caches[key]
            for name, t in one.items():
                if key.startswith("slot"):
                    full[name][:, slot] = t[:, 0]
                else:
                    full[name][slot] = t[0]

    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Run a single-sequence prefill and scatter its KV into ``slot``."""
        tokens = torch.as_tensor(req.prompt, dtype=torch.int32,
                                 device=self.device)[None]
        cache1 = self.model.init_cache(1, self.cache_len,
                                       dtype=self.compute_dtype,
                                       device=self.device)
        logits, cache1 = self.model.prefill(
            self.params, {"tokens": tokens}, cache1, impl="kernel",
            compute_dtype=self.compute_dtype)
        self._scatter_into_slot(slot, cache1)
        tok = int(torch.argmax(logits[0]))
        req.output.append(tok)
        # A request whose budget (or EOS) is met at admission must not
        # occupy a slot.
        if self._is_done(req, tok):
            self._retire(req)
            return
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self.slot_last[slot] = tok

    def _is_done(self, req: Request, tok: int) -> bool:
        return (len(req.output) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id))

    def _retire(self, req: Request) -> None:
        req.done = True
        self._finished.append(req)

    def take_finished(self) -> list[Request]:
        """Pop every request that completed since the last call."""
        out, self._finished = self._finished, []
        return out

    # ------------------------------------------------------------- tick --
    def tick(self) -> int:
        """Admit + one batched decode step. Returns #live slots."""
        self._admit()
        live = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not live:
            return 0
        tokens = torch.as_tensor(self.slot_last, dtype=torch.int32,
                                 device=self.device)
        pos = torch.as_tensor(self.slot_pos, dtype=torch.int32,
                              device=self.device)
        logits, self.caches = self.model.decode_step(
            self.params, self.caches, tokens, pos,
            compute_dtype=self.compute_dtype)
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.cpu().numpy()
        for slot in live:
            req = self.slot_req[slot]
            tok = int(nxt[slot])
            req.output.append(tok)
            self.slot_pos[slot] += 1
            self.slot_last[slot] = tok
            if self._is_done(req, tok):
                self._retire(req)
                self.slot_req[slot] = None
        return len(live)

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        """Tick until queue and slots are empty; returns the completed
        requests in completion order."""
        done: list[Request] = []
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.tick()
            done.extend(self.take_finished())
        done.extend(self.take_finished())
        return done
