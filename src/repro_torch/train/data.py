"""Deterministic synthetic data pipeline (``repro.train.data`` in torch).

Step-indexed draws: ``batch_at(step)`` is a pure function of (seed, step,
shape), so an elastic restart replays exactly and data needs no
checkpointing.  Each batch is drawn on the CPU from a ``torch.Generator``
seeded by ``(seed, step)`` alone and then moved to the stream's device,
so a batch does not depend on the device.  The draws are torch's, not
``jax.random``'s: the batches differ from the reference's, their
structure does not.

The stream is learnable (not uniform noise): Zipfian unigrams with a
copied n-gram motif in about ``motif_prob`` of the rows, so a small model
visibly descends within a few dozen steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.distributed import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_s: float = 1.2
    motif_len: int = 16
    motif_prob: float = 0.5     # fraction of rows with a copied motif


def _zipf_logits(vocab: int, s: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / ranks ** s
    return np.log(p / p.sum()).astype(np.float32)


def _generator(*keys: int) -> torch.Generator:
    """A CPU generator seeded by ``keys`` alone."""
    seed = np.random.SeedSequence([int(k) for k in keys]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & ((1 << 63) - 1))


class SyntheticStream:
    """Token batches: {"tokens": (B, S) int64, "labels": (B, S) int64}, and
    for a frontend config "prefix_embeds" (B, F, d) with the tokens and
    labels cut to S - F, on ``device`` (the card unless the caller asks
    for the CPU)."""

    def __init__(self, cfg: ArchConfig, batch: int, seq: int,
                 data_cfg: Optional[DataConfig] = None, device="cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.dc = data_cfg or DataConfig()
        self.device = resolve_device(device)
        self._probs = torch.from_numpy(
            np.exp(_zipf_logits(cfg.vocab, self.dc.zipf_s).astype(np.float64)))

    def draw(self, step: int):
        """(the (B, S + 1) token rows, the (B, S + 1) mask of copied motif
        positions), on the CPU."""
        gen = _generator(self.dc.seed, step)
        B, S = self.batch, self.seq + 1
        base = torch.multinomial(self._probs, B * S, replacement=True,
                                 generator=gen).reshape(B, S)
        # overlay motifs: copy a window from earlier in the same row
        L = self.dc.motif_len
        starts = torch.randint(L, max(S - L, L + 1), (B,), generator=gen)
        room = torch.clamp(starts - L, min=1)
        src = (torch.rand(B, generator=gen, dtype=torch.float64)
               * room).long().clamp(max=room - 1)
        pos = torch.arange(S)[None, :]
        in_motif = (pos >= starts[:, None]) & (pos < starts[:, None] + L)
        shift = (starts - src)[:, None]
        copied = torch.gather(base, 1, (pos - shift).clamp(0, S - 1))
        use = in_motif & (torch.rand((B, 1), generator=gen)
                          < self.dc.motif_prob)
        return torch.where(use, copied, base), use

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        toks, _ = self.draw(step)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.frontend is not None:
            from ..models.frontends import synth_frontend_embeds
            keep = self.seq - self.cfg.frontend_len
            out["tokens"] = out["tokens"][:, :keep]
            out["labels"] = out["labels"][:, :keep]
            out["prefix_embeds"] = synth_frontend_embeds(
                self.cfg, self.batch, _generator(self.dc.seed, step, 7))
        return {k: v.contiguous().to(self.device) for k, v in out.items()}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
