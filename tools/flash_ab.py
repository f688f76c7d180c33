#!/usr/bin/env python3
"""Time the port's bf16 flash kernels on one NVIDIA GPU, against another
checkout and against variants of their sources.

Run from the root of a checkout:

  python3 tools/flash_ab.py --parent DIR [--out PATH]
  python3 tools/flash_ab.py --variants [--out PATH]
  python3 tools/flash_ab.py --losses [--out PATH]

``--parent DIR`` (DIR: another checkout, such as ``git archive`` of the
parent commit unpacked under ``build/``) runs DIR and this checkout in
turns (DIR, this, this, DIR), each in a process of its own: the times of
``ops.flash_attention`` at the serving shape (4, 32, 512, 128, causal)
and the training shape (4, 48, 2048, 128, causal) and of
``ops.flash_attention_bwd`` at the training shape, then that checkout's
``chip_smoke.py`` phase 10 (serving) and phase 15 (starcoder2-15b
training, with its 15b profile).

``--variants`` builds copies of this checkout's flash sources with one
change each (``VARIANTS``: a dropped or replaced piece, some of which
give wrong results and only show what that piece costs) and times each
in two rounds, beside the sources as they are.  A variant whose snippet
is no longer in the source is reported and skipped.

``--losses`` takes ``chip_smoke.py`` phase 16's bf16 losses (reduced
Jamba, mamba2 and starcoder2, the same weights and batch) on the CPU and
on the card, with the card's attention from the kernel, from the plain
version, and from plain emulations of other roundings (``_roundings``):
float32 attention, and one online pass that rounds the unnormalised P to
bf16 (FlashAttention's usual rounding), with bf16 scores, or with P as
the sum of two bf16 parts.  Reduced Jamba's top-2 routing turns on last
bits, so its loss shows where a rounding lands.

Each run prints one JSON line; ``--out`` writes them all.  Times are CUDA
events over repeated launches after a warm-up.  Needs the card (and
nvcc), as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE, TRAIN = (4, 32, 512, 128), (4, 48, 2048, 128)

# name -> (source, snippet, replacement)
_BWD_ADDS = '''        atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                  make_float2(dq[4 * j + 2 * i] * sm_scale,
                              dq[4 * j + 2 * i + 1] * sm_scale));'''
_KEEP_DQ = "        if (dq[4 * j] == 1234.5f) dst[8 * j] = dq[4 * j + 1];"
VARIANTS = {
    "bwd: dq by plain stores": (
        "flash_attention_bwd", _BWD_ADDS,
        '''        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(dq[4 * j + 2 * i] * sm_scale,
                        dq[4 * j + 2 * i + 1] * sm_scale);'''),
    "bwd: no dq adds": ("flash_attention_bwd", _BWD_ADDS, _KEEP_DQ),
    "fwd: one warpgroup a block": (
        "flash_attention", "constexpr int kW = 2;", "constexpr int kW = 1;"),
    "fwd: one block an SM": (
        "flash_attention", "__launch_bounds__(kW * tc::kWarpgroup, 2)",
        "__launch_bounds__(kW * tc::kWarpgroup, 1)"),
    "fwd: weights divided by l": (
        "flash_attention",
        """                exp2f(s[8 * kk + 2 * x] - m[r]) * inv_l[r],
                exp2f(s[8 * kk + 2 * x + 1] - m[r]) * inv_l[r]);""",
        """                exp2f(s[8 * kk + 2 * x] - m[r]) / l[r],
                exp2f(s[8 * kk + 2 * x + 1] - m[r]) / l[r]);"""),
    "fwd: no W V": (
        "flash_attention",
        """          tc::Wgmma<D>::template rs<1>(acc, wa[kk],
                                       Tile::mnmajor(v_s(st), kk), 1);""",
        "          acc[0] += __uint_as_float(wa[kk][0]) * 1e-30f;"),
}


def _one_pass(torch, q, k, v, causal, bf16_scores=False, split_p=False):
    """Attention in one online pass over 64-key tiles, P rounded to bf16
    before P V (or, with ``split_p``, as the sum of two bf16 parts)."""
    dt, (q, k, v) = q.dtype, (t.float() for t in (q, k, v))
    S, T, D = q.shape[-2], k.shape[-2], q.shape[-1]
    s = q @ k.transpose(-1, -2)
    if bf16_scores:
        s = s.to(torch.bfloat16).float()
    s = s / D ** 0.5
    if causal:
        vis = (torch.arange(T, device=q.device)[None, :]
               <= torch.arange(S, device=q.device)[:, None] + (T - S))
        s = torch.where(vis, s, torch.full_like(s, -1e30))
    m = torch.full(s.shape[:-1], -1e30, device=q.device)
    l = torch.zeros(s.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, T, 64):
        t = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, t.amax(dim=-1))
        alpha, p = torch.exp(m - m_new), torch.exp(t - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        hi = p.to(torch.bfloat16).float()
        if split_p:
            hi = hi + (p - hi).to(torch.bfloat16).float()
        acc = acc * alpha[..., None] + hi @ v[..., k0:k0 + 64, :]
        m = m_new
    return (acc / l[..., None]).to(dt)


def _roundings(torch, ops, ref):
    """name -> attention(q, k, v, causal), as ``ops.flash_attention``."""
    plain = ref.flash_attention_ref
    return {
        "kernel": ops.flash_attention,
        "plain version": lambda q, k, v, causal=True: plain(q, k, v, causal),
        "float32 attention": lambda q, k, v, causal=True: plain(
            q.float(), k.float(), v.float(), causal).to(q.dtype),
        "one pass, P to bf16": lambda q, k, v, causal=True: _one_pass(
            torch, q, k, v, causal),
        "one pass, bf16 scores": lambda q, k, v, causal=True: _one_pass(
            torch, q, k, v, causal, bf16_scores=True),
        "one pass, P as two bf16 parts": lambda q, k, v, causal=True:
            _one_pass(torch, q, k, v, causal, split_p=True)}


def run_losses():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    roundings, kernel = _roundings(torch, ops, ref), ops.flash_attention
    results = []
    for arch in cs.TRAIN_PARITY_ARCHS:       # as phase 16 builds them
        cfg = get_config(arch).reduced()
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
            for name, fn in roundings.items():
                ops.flash_attention = fn
                with torch.no_grad():
                    got = float(M.loss_fn(card, {k: v.to(dev) for k, v
                                                 in batch.items()},
                                          remat=False))
                r = {"arch": arch, "attention": name, "loss_cpu": want,
                     "loss_card": got, "rel_err": abs(got - want) / want,
                     "limit": cs.LOSS_RTOL["bfloat16"]}
                results.append(r)
                print(json.dumps(r), flush=True)
        finally:
            ops.flash_attention = kernel
    return results


def _timer(torch):
    def time_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    return time_ms


def _inputs(torch, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(4)]


def _kernel_times(torch, fwd, bwd):
    """ms of ``fwd(q, k, v)`` at both shapes and of ``bwd(q, k, v, do)``
    at the training shape."""
    time_ms = _timer(torch)
    out = {}
    for name, shape in (("serve", SERVE), ("train", TRAIN)):
        q, k, v, do = _inputs(torch, shape, 0)
        out[f"fwd_{name}_ms"] = time_ms(lambda: fwd(q, k, v), 20)
        if name == "train":
            out["bwd_train_ms"] = bwd(q, k, v, do, time_ms)
    return out


def run_checkout(root, label):
    """In this process: the kernels and phases 10 and 15 of the checkout
    at ``root``; prints and returns one result."""
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.models.registry import get_config

    def bwd(q, k, v, do, time_ms):
        o, lse = flash_attention_cuda(q, k, v, True, with_lse=True)
        return time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do,
                                                       True), 10)

    dev = torch.device("cuda")
    res = {"label": label, "root": root, **_kernel_times(
        torch, lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
        bwd)}
    torch.cuda.empty_cache()
    serve = cs._serve_phase(torch, np, dev, False)
    res.update(prefill_ms=serve["prefill_ms"], waves=serve["waves"],
               decode_ms_per_step=serve["decode_ms_per_step"])
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(cs.TRAIN_ATTN_ARCH),
                              n_layers=cs.TRAIN_ATTN_LAYERS)
    train = cs._train_phase(torch, np, dev, 15, "train attention", cfg,
                            cs.TRAIN_ATTN_BATCH, cs.TRAIN_ATTN_STEPS,
                            cs.TRAIN_ATTN_LR, "flash_attention", "",
                            profile=True)
    res.update({k: train[k] for k in ("ms_per_step", "step_ms", "losses",
                                      "launches", "profile",
                                      "max_memory_allocated_gb")})
    print("RESULT " + json.dumps(res), flush=True)
    return res


def run_parent(parent, script=__file__, extra=()):
    """Runs ``script --one`` (and the arguments ``extra``) on the checkout
    ``parent`` and on this one in turns (parent, this, this, parent), each
    in a process of its own, and returns the result each printed."""
    results = []
    for label, root in (("parent", parent), ("this", ROOT), ("this", ROOT),
                        ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--one",
             os.path.abspath(root), "--label", label, *extra],
            capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            raise RuntimeError(f"{label} run failed ({proc.returncode}):\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        results.append(json.loads(lines[-1][len("RESULT "):]))
        print(json.dumps({k: v for k, v in results[-1].items()
                          if k not in ("profile", "waves")}), flush=True)
    return results


def _load(path, kernel):
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if kernel == "flash_attention":
        lib.flash_attention_launch.argtypes = [p] * 5 + [i] * 6 + [f, p]
        lib.flash_attention_launch.restype = i
    else:
        lib.flash_attention_bwd_launch.argtypes = [p] * 11 + [i] * 6 + [f, p]
        lib.flash_attention_bwd_launch.restype = i
    err = getattr(lib, f"{kernel}_error_string")
    err.argtypes, err.restype = [i], ctypes.c_char_p
    return lib


def run_variants():
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    out_dir = os.path.join(ROOT, "build", "flash_ab")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    todo = {"as is": None, **VARIANTS}
    procs, libs, usage = {}, {}, {}
    for n, (name, spec) in enumerate(todo.items()):
        kernels = ("flash_attention", "flash_attention_bwd") if spec is None \
            else (spec[0],)
        for kernel in kernels:
            text = open(os.path.join(csrc, f"{kernel}.cu")).read()
            text = text.replace('#include "hopper_tc.cuh"',
                                f'#include "{csrc}/hopper_tc.cuh"')
            if spec is not None:
                if spec[1] not in text:
                    print(json.dumps({"variant": name,
                                      "skipped": "snippet not in source"}))
                    continue
                text = text.replace(spec[1], spec[2])
            cu = os.path.join(out_dir, f"v{n}_{kernel}.cu")
            with open(cu, "w") as fh:
                fh.write(text)
            so = cu[:-3] + ".so"
            procs[(name, kernel)] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-3000:]}")
        libs[key] = _load(so, key[1])
        usage[key] = cs._ptxas_usage(log, r"(flash_\w+_tc_kernelILi128E)")

    # the backward's inputs, from the forward as it is
    q, k, v, do = _inputs(torch, TRAIN, 0)
    o, lse = fa.flash_attention_cuda(q, k, v, True, with_lse=True)
    results = []
    for rnd in range(2):
        for (name, kernel), lib in libs.items():
            # the launchers of kernels/flash_attention.py on this library
            if kernel == "flash_attention":
                fa._library = lambda lib=lib: lib
                times = _kernel_times(
                    torch, lambda q, k, v: fa.flash_attention_cuda(
                        q, k, v, True), lambda *a: None)
                times.pop("bwd_train_ms")
            else:
                fa._bwd_library = lambda lib=lib: lib
                times = {"bwd_train_ms": _timer(torch)(
                    lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                        True), 10)}
            r = {"round": rnd, "variant": name, "kernel": kernel,
                 "ptxas": usage[(name, kernel)], **times}
            results.append(r)
            print(json.dumps(r), flush=True)
            torch.cuda.empty_cache()
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="another checkout to run in turns")
    ap.add_argument("--variants", action="store_true",
                    help="time the source variants")
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
        print("flash_ab: needs the GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    record = {"card": card}
    if args.variants:
        record["variants"] = run_variants()
    if args.losses:
        record["losses"] = run_losses()
    if args.parent:
        record["parent"] = run_parent(args.parent)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
