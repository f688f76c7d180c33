"""Deterministic synthetic token pipeline (a copy of
``repro/data/pipeline.py``, which the port does not import; numpy only,
so its batches equal the reference's bit for bit).

Production shape: each host materializes ONLY its shard of the global
batch (host-sharded loading), derived counter-mode from (seed, step,
shard) so any host can reproduce any step — which is what makes
checkpoint/restart and elastic re-sharding exact: a restarted or re-ranked
host regenerates precisely the batches it owes.

The token stream is a structured Zipf-ish mixture (not uniform noise) so
losses move and overfitting tests are meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticTokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # multimodal stubs
    frontend: str = "none"
    num_frontend_tokens: int = 0
    d_model: int = 0


class SyntheticTokenPipeline:
    """Counter-mode deterministic batches; shard-aware."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.shard]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """The shard-local slice of global batch ``step``."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S = self.local_batch, cfg.seq_len
        # Zipf-distributed tokens with short-range repetition structure
        zipf = np.minimum(rng.zipf(1.3, size=(B, S + 1)), cfg.vocab - 1)
        rep = rng.random((B, S + 1)) < 0.3
        toks = zipf.astype(np.int32)
        toks[:, 1:][rep[:, 1:]] = toks[:, :-1][rep[:, 1:]]
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend == "audio":
            out["frames"] = rng.normal(
                0, 1, (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
        elif cfg.frontend == "vision":
            out["vision_embeds"] = rng.normal(
                0, 1, (B, cfg.num_frontend_tokens, cfg.d_model)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    def reshard(self, shard: int, num_shards: int) -> "SyntheticTokenPipeline":
        """Elastic re-mesh: same stream, new shard geometry."""
        return SyntheticTokenPipeline(self.cfg, shard, num_shards)
