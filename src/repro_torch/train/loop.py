"""Fault-tolerant training loop (a port of ``repro/train/loop.py``).

Composes the deterministic data pipeline, the train step, async
checkpointing, straggler detection and fault injection.  The recovery
path is the reference's: catch the failure, restore the last committed
checkpoint into a fresh state, and replay the stream from that step
(bit-identical, since the data is counter-mode).  As in the reference,
the loop restarts on its one device; ``train.fault.ElasticMesh`` rebuilds
the mesh over the healthy devices and re-shards a live state onto it.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from ..checkpoint.ckpt import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.model import Model
from ..optim.adamw import AdamWConfig
from .fault import FaultInjector, SimulatedDeviceFailure
from .step import init_train_state, make_train_step
from .straggler import StragglerDetector

__all__ = ["TrainLoopConfig", "train_loop"]


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    global_batch: int = 8
    seq_len: int = 128
    microbatches: int = 1
    log_every: int = 10
    seed: int = 0
    resume: bool = True
    max_restarts: int = 4


def train_loop(cfg: ModelConfig, loop: TrainLoopConfig,
               opt_cfg: AdamWConfig = AdamWConfig(lr=1e-3),
               fault_injector: Optional[FaultInjector] = None,
               on_step: Optional[Callable[[int, Dict], None]] = None,
               device=None) -> Dict:
    """Run training with restart-on-failure on ``device`` (``None``: the
    card).  The fresh state's weights come from
    ``torch.Generator(device).manual_seed(loop.seed)``.  Returns the
    reference's summary metrics, the final train state, and the seconds
    spent in ``save_async`` (waiting out the previous write, then the
    snapshot to host memory) and in the final wait for the last write."""
    dev = resolve_device(device)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=loop.seq_len,
                          global_batch=loop.global_batch, seed=loop.seed,
                          frontend="audio" if cfg.encoder_layers
                          else cfg.frontend,
                          num_frontend_tokens=cfg.num_frontend_tokens,
                          d_model=cfg.d_model)
    pipe = SyntheticTokenPipeline(data_cfg)
    ckpt = CheckpointManager(loop.ckpt_dir)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=loop.microbatches)
    detector = StragglerDetector()
    losses: List[float] = []
    restarts = 0
    ckpt_save_s = 0.0

    def fresh_state():
        gen = torch.Generator(device=dev).manual_seed(loop.seed)
        return init_train_state(cfg, Model(cfg, device=dev, generator=gen),
                                opt_cfg)

    state = fresh_state()
    start = 0
    if loop.resume:
        state, restored = ckpt.restore_latest(state)
        if restored is not None:
            start = restored
    step = start

    while step < loop.steps:
        try:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(step).items()}
            if fault_injector is not None:
                fault_injector.check(step)
            detector.step_start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            detector.step_end(step)
            losses.append(loss)
            if on_step:
                on_step(step, {"loss": loss})
            step += 1
            if step % loop.ckpt_every == 0 or step == loop.steps:
                t0 = time.perf_counter()
                ckpt.save_async(step, state)
                ckpt_save_s += time.perf_counter() - t0
        except SimulatedDeviceFailure:
            restarts += 1
            if restarts > loop.max_restarts:
                raise
            # recovery protocol: wait out the in-flight checkpoint, restore
            # the last committed state, replay the stream from there
            ckpt.wait()
            state = None
            state = fresh_state()
            state, restored = ckpt.restore_latest(state)
            step = restored or 0
            detector = StragglerDetector()

    t0 = time.perf_counter()
    ckpt.wait()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "losses": losses, "restarts": restarts,
            "straggler_events": len(detector.events), "steps_run": step,
            "state": state, "ckpt_save_s": ckpt_save_s,
            "ckpt_wait_s": time.perf_counter() - t0}
