"""Checkpointing with atomic commit and an async writer (a port of
``repro/checkpoint/ckpt.py``, with its on-disk layout).

Layout:  <dir>/step_<N>/
            manifest.json            {step, n_leaves, index, treedef, time}
            leaf_<i>.npy             one file per leaf

A state is a tree of dicts (taken in insertion order), ``nn.Module``s
(taken by their ``state_dict``) and tensors; its leaves are numbered in
that order, so a model's leaves follow its ``state_dict`` order.  bf16
leaves are stored as their ``uint16`` bits with the logical dtype in the
manifest, as the reference stores them (``tensor.view(torch.int16)``:
numpy has no bfloat16).  ``treedef`` lists the leaves' paths.

Durability protocol: leaves are written into ``step_<N>.tmp/``, the
manifest is fsync'd, then the directory is renamed, so a crash mid-write
never leaves a readable but corrupt checkpoint, and ``latest_step`` only
sees committed directories.  ``CheckpointManager`` snapshots the state
to host memory on the caller's thread, writes and commits on a daemon
thread, keeps the last ``keep`` checkpoints and blocks in ``wait()``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

# dtypes numpy lacks, stored as raw bits of the same width
_BIT_VIEWS = {torch.bfloat16: (torch.int16, np.uint16, "bfloat16")}
_LOGICAL = {name: dt for dt, (_, _, name) in _BIT_VIEWS.items()}


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, f"{prefix}.{k}" if prefix else str(k))
        return out
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree).__name__},"
                    f" not a tensor")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().to("cpu", copy=True)  # training goes on updating t
    if t.dtype in _BIT_VIEWS:
        as_int, as_np, name = _BIT_VIEWS[t.dtype]
        return t.contiguous().view(as_int).numpy().view(as_np), name
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, logical: str) -> torch.Tensor:
    if logical in _LOGICAL:
        as_int = _BIT_VIEWS[_LOGICAL[logical]][0]
        return torch.from_numpy(arr.view(np.int16)).view(as_int).view(
            _LOGICAL[logical])
    return torch.from_numpy(arr)


def _write(ckpt_dir: str, step: int, named: List[Tuple[str, np.ndarray, str]]
           ) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = []
    for i, (_, arr, logical) in enumerate(named):
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        index.append({"i": i, "shape": list(arr.shape), "dtype": logical})
    manifest = {"step": step, "n_leaves": len(named), "index": index,
                "treedef": str([path for path, _, _ in named]),
                "time": time.time()}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _snapshot(state) -> List[Tuple[str, np.ndarray, str]]:
    return [(path, *_to_numpy(t)) for path, t in _leaves(state)]


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    return _write(ckpt_dir, step, _snapshot(state))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d[5:]))
    return max(steps) if steps else None


@torch.no_grad()
def restore_checkpoint(ckpt_dir: str, state_like, step: Optional[int] = None):
    """Restore into the tensors of ``state_like``, in place (each keeps its
    device; the dtypes on disk must match).  Returns (state_like, step), or
    (state_like, None) when nothing is committed."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return state_like, None
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _leaves(state_like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, state has "
            f"{len(leaves)} — structure changed since save")
    for entry, (path, t) in zip(manifest["index"], leaves):
        src = _from_numpy(np.load(os.path.join(d, f"leaf_{entry['i']}.npy")),
                          entry["dtype"])
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(f"{path}: checkpoint has {tuple(src.shape)} "
                             f"{src.dtype}, state {tuple(t.shape)} {t.dtype}")
        t.copy_(src)
    return state_like, step


class CheckpointManager:
    """Async checkpointing: snapshot to host memory on the caller's thread,
    write and commit on a daemon thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_async(self, step: int, state) -> None:
        self.wait()
        snapshot = _snapshot(state)

        def _write_and_gc():
            try:
                _write(self.ckpt_dir, step, snapshot)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write_and_gc, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(d[5:]) for d in os.listdir(self.ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, state_like):
        return restore_checkpoint(self.ckpt_dir, state_like)
