"""Batched serving engine: continuous-batching request scheduler over the
prefill/decode steps (a port of ``repro/serve/engine.py``).

Requests enter a deque; the engine keeps an array of ``max_batch`` slots
backed by one batch-wide cache per layer.  Whenever slots are free and
requests are queued it admits a wave -- prefills the newcomers, left-
padded to the wave's longest prompt, and copies their caches into the
freed slot rows -- then decodes the full slot array one token at a time,
retiring finished sequences individually so their slots are refilled on
the next iteration instead of waiting for the whole batch to drain.
Decode always runs at the full ``(max_batch, 1)`` shape.  The engine runs
on the model's device.  As the reference's, it passes the steps no
context, so a ``cross_attn`` layer serves its context-free form.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.model import Model, init_cache
from .step import greedy_sample, make_decode_step, make_prefill_step

__all__ = ["Request", "ServeEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: Model, max_batch: int = 4,
                 max_len: int = 512, eos_id: Optional[int] = None):
        self.cfg = cfg
        self.params = params
        self.device = params.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.prefill = make_prefill_step(cfg, max_len)
        self.decode = make_decode_step(cfg)
        self.queue: Deque[Request] = collections.deque()

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    @torch.inference_mode()
    def run(self) -> Dict[int, List[int]]:
        """Serve everything in the queue; returns rid -> generated tokens.
        Runs under ``torch.inference_mode()``."""
        dev = self.device
        results: Dict[int, List[int]] = {}
        slots: List[Optional[Request]] = [None] * self.max_batch
        caches = None
        pos = torch.zeros((self.max_batch,), dtype=torch.int32, device=dev)
        nxt = torch.zeros((self.max_batch,), dtype=torch.int32, device=dev)

        def finished(r: Request, t: int) -> bool:
            return (self.eos_id is not None and t == self.eos_id) or \
                len(r.generated) >= r.max_new_tokens

        def retire(i: int) -> None:
            r = slots[i]
            r.done = True
            results[r.rid] = r.generated
            slots[i] = None

        while self.queue or any(s is not None for s in slots):
            free = [i for i, s in enumerate(slots) if s is None]
            if self.queue and free:
                # ---- admission wave: prefill newcomers into free slots ----
                wave, idx = [], []
                for i in free:
                    if not self.queue:
                        break
                    slots[i] = self.queue.popleft()
                    wave.append(slots[i])
                    idx.append(i)
                s_max = max(len(r.prompt) for r in wave)
                toks = np.zeros((len(wave), s_max), np.int32)
                for j, r in enumerate(wave):
                    toks[j, -len(r.prompt):] = r.prompt  # left-pad
                logits, fresh = self.prefill(self.params,
                                             torch.from_numpy(toks).to(dev))
                first = greedy_sample(logits)
                if caches is None:
                    caches = init_cache(self.cfg, self.max_batch,
                                        self.max_len, dev)
                sel = torch.tensor(idx, dtype=torch.long, device=dev)
                for whole, part in zip(caches, fresh):
                    if whole is None:   # a cross-attention layer: no cache
                        continue
                    for key, t in whole.items():
                        t.index_copy_(0, sel, part[key])
                nxt.index_copy_(0, sel, first)
                pos.index_fill_(0, sel, s_max)
                for j, t in enumerate(first.tolist()):
                    r = wave[j]
                    r.generated.append(t)
                    if finished(r, t):
                        retire(idx[j])
                continue  # a 1-token request may have freed its slot already
            # ---- one decode step over the full slot array ----
            # Free slots carry stale cache/pos state; their logits are
            # discarded and admission overwrites every cache row it fills,
            # so the garbage never reaches a live request.
            logits, caches = self.decode(self.params, nxt[:, None], pos,
                                         caches)
            nxt = greedy_sample(logits)
            pos = pos + 1
            for i, t in enumerate(nxt.tolist()):
                r = slots[i]
                if r is None:
                    continue
                r.generated.append(t)
                if finished(r, t):
                    retire(i)
        return results
