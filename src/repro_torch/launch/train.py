"""Training CLI: ``python -m repro_torch.launch.train --arch <id>``
(a port of ``repro/launch/train.py``).

As in the reference, ``--smoke`` is always on (its flag is declared
``store_true`` with ``default=True``), so the CLI trains the reduced
config; full configs are trained by calling ``train.loop.train_loop``.
It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from repro_torch.models.registry import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainLoopConfig, train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    loop = TrainLoopConfig(steps=args.steps, global_batch=args.batch,
                           seq_len=args.seq, ckpt_dir=args.ckpt_dir)
    t0 = time.time()
    out = train_loop(cfg, loop, AdamWConfig(lr=args.lr), device=args.device)
    dt = time.time() - t0
    print(json.dumps({
        "arch": cfg.name, "device": str(out["state"]["params"].device),
        "steps": out["steps_run"], "first_loss": out["losses"][0],
        "final_loss": out["final_loss"], "restarts": out["restarts"],
        "wall_s": round(dt, 1), "steps_per_s": round(out["steps_run"] / dt, 2),
    }, indent=1))


if __name__ == "__main__":
    main()
