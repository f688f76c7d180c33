#!/usr/bin/env python3
"""Time the port's bf16 scan kernels (``ssm_scan``, ``ssm_scan_bwd``) on
one NVIDIA GPU against another checkout, split them by stage, and take
phase 16's losses under other roundings.

Run from the root of a checkout:

  python3 tools/scan_ab.py --parent DIR [--out PATH]
  python3 tools/scan_ab.py --stages [--out PATH]
  python3 tools/scan_ab.py --losses [--out PATH]

``--parent DIR`` (DIR: another checkout, such as ``git archive`` of the
parent commit unpacked under ``build/``) runs DIR and this checkout in
turns (DIR, this, this, DIR), each in a process of its own: the times of
``ops.ssm_scan`` at the serving shape (4, 512, 128, 64, 16) and the
training shape (8, 2048, 48, 64, 128) and of ``ops.ssm_scan_bwd`` at the
training shape (chunk 64), then that checkout's ``chip_smoke.py`` phase
10 (serving) and phase 14 (mamba2-780m training, with its 14b profile).

``--stages`` traces one forward and one backward at each shape with
torch.profiler and sums the device time by kernel (the stages of
``csrc/ssm_tc.cuh``, ``csrc/ssm_scan.cu`` and ``csrc/ssm_scan_bwd.cu``).

``--losses`` takes ``chip_smoke.py`` phase 16's bf16 losses of the
configs with Mamba2 layers (reduced Jamba and mamba2; the same weights
and batch) on the CPU and on the card, with the card's scan from the
kernel, from the plain version, and from plain emulations of the tensor
cores' chunk-parallel arithmetic that round each float32 operand of a
product (X u, W, S_in) to one bf16 part, to TF32, or to two bf16 parts
(``_emulated_scan``).

Each run prints one JSON line; ``--out`` writes them all.  Times are CUDA
events over repeated launches after a warm-up.  Needs the card (and
nvcc), as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE, TRAIN = (4, 512, 128, 64, 16), (8, 2048, 48, 64, 128)
CHUNK = 64


def _round(torch, v, mode):
    """A float32 operand as the tensor cores would take it."""
    bf = v.to(torch.bfloat16).float()
    if mode == "one bf16 part":
        return bf
    if mode == "two bf16 parts":
        return bf + (v - bf).to(torch.bfloat16).float()
    # TF32: 10 explicit mantissa bits, rounded to nearest
    bits = v.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _emulated_scan(torch, x, dt, a_log, b, c, chunk, mode):
    """The bf16 kernels' forward (csrc/ssm_tc.cuh, stages (a)-(c)) with
    the float32 operands of its products rounded by ``mode``; chunks of
    at most 64 rows (one tile a chunk)."""
    B, S, H, P = x.shape
    nc, L = S // chunk, chunk
    assert L <= 64, "one tile a chunk"
    f = torch.float32
    a = -torch.exp(a_log.to(f))
    xr = x.reshape(B, nc, L, H, P).to(f)
    dtr = dt.reshape(B, nc, L, H).to(f)
    br, cr = (t.reshape(B, nc, L, -1).to(f) for t in (b, c))
    seg = torch.cumsum(dtr * a, dim=2)
    u = torch.exp(seg[:, :, -1:, :] - seg) * dtr
    sc = torch.einsum("bkjhp,bkjn->bkhpn",
                      _round(torch, xr * u[..., None], mode), br)
    dec = torch.exp(seg[:, :, -1, :])
    s_in, s = torch.empty_like(sc), torch.zeros_like(sc[:, 0])
    for k in range(nc):
        s_in[:, k] = s
        s = dec[:, k, :, None, None] * s + sc[:, k]
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]
    decay = torch.exp(rel.masked_fill(~causal[None, None, :, :, None],
                                      -1e30))
    g = torch.einsum("bkin,bkjn->bkij", cr, br)
    w = g[..., None] * decay * dtr[:, :, None, :, :]
    y = torch.einsum("bkin,bkhpn->bkihp", cr, _round(torch, s_in, mode)) \
        * torch.exp(seg)[..., None] \
        + torch.einsum("bkijh,bkjhp->bkihp", _round(torch, w, mode), xr)
    return y.reshape(B, S, H, P).to(x.dtype)


def run_losses():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    kernel = ops.ssm_scan
    scans = {
        "kernel": kernel,
        "plain version": lambda *a, chunk=64: ref.ssm_scan_ref(
            *a, chunk=chunk)}
    for mode in ("one bf16 part", "TF32", "two bf16 parts"):
        scans[f"emulated, {mode}"] = (
            lambda *a, chunk=64, mode=mode: _emulated_scan(
                torch, *a, chunk, mode))
    results = []
    for arch in cs.TRAIN_PARITY_ARCHS:       # as phase 16 builds them
        cfg = get_config(arch).reduced()
        if not cfg.ssm_state:
            continue
        model = M.Model(cfg, device=cpu,
                        generator=torch.Generator().manual_seed(16))
        batch = {k: torch.from_numpy(v) for k, v in SyntheticTokenPipeline(
            DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2,
                       seed=16)).batch(0).items()}
        card = M.Model(cfg, device=dev, generator=None)
        with torch.no_grad():
            card.load_state_dict(model.state_dict())
            want = float(M.loss_fn(model, batch, remat=False))
        try:
            for name, fn in scans.items():
                ops.ssm_scan = fn
                with torch.no_grad():
                    got = float(M.loss_fn(card, {k: v.to(dev) for k, v
                                                 in batch.items()},
                                          remat=False))
                r = {"arch": arch, "scan": name, "loss_cpu": want,
                     "loss_card": got, "rel_err": abs(got - want) / want,
                     "limit": cs.LOSS_RTOL["bfloat16"]}
                results.append(r)
                print(json.dumps(r), flush=True)
        finally:
            ops.ssm_scan = kernel
    return results


def _inputs(torch, shape, seed):
    B, S, H, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    bf = torch.bfloat16
    x = torch.randn((B, S, H, P), generator=g, device="cuda").to(bf)
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=g, device="cuda")
    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device="cuda"))
    b, c = (torch.randn((B, S, N), generator=g, device="cuda").to(bf)
            for _ in range(2))
    dy = torch.randn((B, S, H, P), generator=g, device="cuda").to(bf)
    return x, dt, a_log, b, c, dy


def _kernel_times(torch, cs, ops):
    """ms of the forward at both shapes and of the backward at the
    training shape."""
    out = {}
    for name, shape in (("serve", SERVE), ("train", TRAIN)):
        x, dt, a_log, b, c, dy = _inputs(torch, shape, 0)
        out[f"fwd_{name}_ms"] = cs._time_ms(
            torch, lambda: ops.ssm_scan(x, dt, a_log, b, c, chunk=CHUNK), 20)
        if name == "train":
            out["bwd_train_ms"] = cs._time_ms(
                torch, lambda: ops.ssm_scan_bwd(x, dt, a_log, b, c, dy,
                                                chunk=CHUNK), 10)
        del x, dt, a_log, b, c, dy
        torch.cuda.empty_cache()
    return out


def run_checkout(root, label):
    """In this process: the kernels and phases 10 and 14 of the checkout
    at ``root``; prints and returns one result."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_config

    dev = torch.device("cuda")
    res = {"label": label, "root": root, **_kernel_times(torch, cs, ops)}
    serve = cs._serve_phase(torch, np, dev, False)
    res.update(prefill_ms=serve["prefill_ms"], waves=serve["waves"],
               decode_ms_per_step=serve["decode_ms_per_step"])
    torch.cuda.empty_cache()
    train = cs._train_phase(torch, np, dev, 14, "train",
                            get_config(cs.TRAIN_SSM_ARCH),
                            cs.TRAIN_SSM_BATCH, cs.TRAIN_SSM_STEPS,
                            cs.TRAIN_SSM_LR, "ssm_scan", "", profile=True)
    res.update({k: train[k] for k in ("ms_per_step", "step_ms", "losses",
                                      "launches", "profile",
                                      "max_memory_allocated_gb")})
    print("RESULT " + json.dumps(res), flush=True)
    return res


def run_stages():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    results = []
    for name, shape in (("serve", SERVE), ("train", TRAIN)):
        x, dt, a_log, b, c, dy = _inputs(torch, shape, 0)
        runs = {"fwd": lambda: ops.ssm_scan(x, dt, a_log, b, c, chunk=CHUNK),
                "bwd": lambda: ops.ssm_scan_bwd(x, dt, a_log, b, c, dy,
                                                chunk=CHUNK)}
        for what, run in runs.items():
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            per = {}
            for ev in prof.key_averages():
                t = getattr(ev, "device_time_total",
                            getattr(ev, "cuda_time_total", 0))
                if t > 0 and ev.key.split("<")[0].split("(")[0] \
                        not in ("cudaLaunchKernel",):
                    per[ev.key[:80]] = t / 1e3
            r = {"shape": name, "run": what, "device_ms_by_kernel": per}
            results.append(r)
            print(json.dumps(r), flush=True)
        del x, dt, a_log, b, c, dy
        torch.cuda.empty_cache()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to run in turns")
    ap.add_argument("--stages", action="store_true",
                    help="device time of each stage kernel")
    ap.add_argument("--losses", action="store_true",
                    help="phase 16's bf16 losses under other roundings")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write every result to this JSON")
    args = ap.parse_args(argv)
    if args.one:
        run_checkout(args.one, args.label)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("scan_ab: needs the GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    record = {"card": card}
    if args.stages:
        record["stages"] = run_stages()
    if args.losses:
        record["losses"] = run_losses()
    if args.parent:
        from flash_ab import run_parent   # tools/ is this script's path
        record["parent"] = run_parent(args.parent, script=__file__)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
