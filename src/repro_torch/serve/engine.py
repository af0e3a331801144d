"""Serving engine: batched prefill + decode with a slot-based scheduler
(``repro.serve.engine`` in torch).

``serve_decode_step`` advances every slot by one token against the KV
cache.  The host-side ``BatchScheduler`` implements continuous batching:
requests claim slots, each is prefilled on its own into its slot's cache
rows (one flash-attention launch per layer), finished slots are recycled.
A tick records the spans ``tick`` > ``admit`` (each prefill), ``decode``
and ``readback`` (``trace.span``).
The device is the params' device: on ``cuda`` the scheduler runs on the
card or fails.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..configs.base import ArchConfig
from ..models import model
from ..trace import span

# The reference's scheduler cannot serve a frontend config either (its
# admit prefills without prefix embeddings); serve one through
# ``model.serve_prefill`` / ``serve_decode``.
FRONTEND_ITEM = "ROADMAP Queue C, 'The frontend raise'"


def serve_prefill_step(cfg: ArchConfig, params, batch, cache):
    """Prefill the cache for a batch of prompts; returns (logits, cache)."""
    return model.serve_prefill(cfg, params, batch, cache)


def serve_decode_step(cfg: ArchConfig, params, token, pos, cache,
                      temperature: float = 0.0,
                      generator: Optional[torch.Generator] = None):
    """One decode step for all slots: token (B,1) -> next token (B,1).
    With ``temperature > 0`` and a ``generator`` the next token is sampled
    from ``softmax(logits / temperature)`` (its draws are torch's, not
    ``jax.random.categorical``'s); otherwise it is the argmax."""
    logits, cache = model.serve_decode(cfg, params, token, pos, cache)
    lg = logits[:, -1, :].to(torch.float32)
    if temperature > 0.0 and generator is not None:
        probs = torch.softmax(lg / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    else:
        nxt = torch.argmax(lg, dim=-1)
    return nxt[:, None], logits, cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchScheduler:
    """Slot-based continuous batching over a fixed decode batch size.

    Host-side only (device work stays in serve_*_step): admits requests into
    free slots, advances all active slots each tick, retires finished ones.
    """

    def __init__(self, cfg: ArchConfig, params, batch_slots: int,
                 max_seq: int, eos_id: int = 1):
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: the slot scheduler does not serve a "
                f"{cfg.frontend} frontend's prefix embeddings; call "
                f"models.model.serve_prefill with 'prefix_embeds' "
                f"({FRONTEND_ITEM})")
        self.cfg = cfg
        self.params = params
        self.device = params["embedding"].device
        self.slots: List[Optional[Request]] = [None] * batch_slots
        self.pos = torch.zeros((batch_slots,), dtype=torch.int64,
                               device=self.device)
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int64,
                                  device=self.device)
        self.cache = model.init_cache(cfg, batch_slots, max_seq,
                                      device=self.device)
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.finished: List[Request] = []

    def submit(self, req: Request):
        self.queue.append(req)

    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            with span("admit", rid=req.rid, prompt_len=len(req.prompt)):
                self._prefill(i, req)

    def _prefill(self, i: int, req: Request):
        """Single-request prefill straight into slot i: the reference
        prefills a fresh one-slot cache and copies it into slot i; here
        slot i's rows are zeroed and the prefill writes its rows in place
        (views of the full cache, no copy)."""
        prompt = torch.as_tensor(req.prompt, dtype=torch.int64,
                                 device=self.device)[None, :]
        slot_cache = []
        for c in self.cache:
            view = {name: t[:, i:i + 1] for name, t in c.items()}
            for t in view.values():
                t.zero_()
            slot_cache.append(view)
        logits, _ = model.serve_prefill(self.cfg, self.params,
                                        {"tokens": prompt}, slot_cache)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        self.tokens[i, 0] = nxt[0]
        self.pos[i] = len(req.prompt)
        req.generated.append(int(nxt[0]))
        self.slots[i] = req

    def tick(self) -> int:
        """Advance all active slots one token; returns #active."""
        with span("tick"):
            return self._tick()

    def _tick(self) -> int:
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        with span("decode"):
            nxt, _, self.cache = serve_decode_step(self.cfg, self.params,
                                                   self.tokens, self.pos,
                                                   self.cache)
        self.tokens = nxt
        self.pos = self.pos + 1
        with span("readback"):      # one sync a tick
            toks, pos = nxt[:, 0].tolist(), self.pos.tolist()
        for i in active:
            req = self.slots[i]
            tok = toks[i]
            req.generated.append(tok)
            limit = len(req.prompt) + req.max_new
            if tok == self.eos_id or pos[i] >= min(limit, self.max_seq - 1):
                req.done = True
                self.finished.append(req)
                self.slots[i] = None
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished
