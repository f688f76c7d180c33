#!/usr/bin/env python3
"""Drive the PyTorch port of MOSAIC on one NVIDIA GPU and check it.

Run from the root of a checkout:  ``python3 chip_smoke.py``

Phases (each prints one ``[n name]`` line; any failure raises and the
script exits non-zero without printing a result):

1. card      -- the card's name and power limit from ``nvidia-smi``;
2. build     -- compiles every hand-written CUDA kernel of the port
                (``src/repro_torch/csrc/*.cu``: dse_eval, flash_attention,
                flash_attention_bwd, ssm_scan, ssm_scan_bwd, horner) with
                ``nvcc`` for ``sm_90a``, one process each, all started
                together;
3. kernel    -- dse_eval against its plain PyTorch version on the card,
                at the main path's shapes (512 genomes x the op rows of
                all 20 workloads) and on the no-hostable-tile case: the
                seconds and the energy bit for bit; times both with CUDA
                events, the kernel also by torch.profiler's device time
                ("not measured" when the profiler sees no such kernel),
                and computes its bound;
4. main path -- ``EvalEngine(workload_names(), EngineConfig(
                backend="batched", mode="latency"))`` on ``cuda`` scores
                512 random genomes on the 20 workloads (cut from 4,096
                to 2,048 when phase 21 came, to 1,024 when phase 22 came
                and to 512 when phases 26-27 came, to keep the run within
                900 s), then again (all memo hits);
5. prefilter -- ``roofline_bounds`` on the same 512 x 20 (the kernel's
                caller).  Phases 4 and 5 are the DSE path: the launch
                counters are zeroed just before phase 4 and read just
                after phase 5, and dse_eval must have launched;
6. throughput-- the engine in throughput mode, 4 workloads x 512;
7. card vs CPU -- the same engine on ``cpu`` and on ``cuda`` for 64 genomes
                x 3 workloads in both modes (ok masks equal, metrics within
                rel 1e-9), and the port on ``hetero_bls()`` against the
                golden traces in tests/golden (rtol 1e-6);
8. build     -- loads flash_attention and ssm_scan and their backward
                libraries (built in phase 2) and prints their build
                seconds, the number of ``HGMMA`` (wgmma) instructions in
                each (``cuobjdump --dump-sass``; fails if one has none) and
                the registers and spills ``ptxas -v`` gave each tensor-core
                kernel (fails if a bf16 scan kernel spills);
9. lm kernels -- both at the first prefill wave's shapes (batch 4, 512
                tokens, bf16) against their plain versions (flash 2e-2,
                ssm_scan 5e-2), timed with CUDA events beside the plain
                version, the bound and, for flash,
                ``scaled_dot_product_attention`` (a yardstick only); and
                each again at its training phase's shape: flash_attention
                at phase 15's (batch 4, 48 heads, 2,048 tokens, causal),
                ssm_scan at phase 14's (mamba2-780m, batch 8 x 2,048, 48
                heads, P 64, N 128, chunk 64), bf16, and the float32
                CUDA-core ssm_scan there in chunks of 128 (1e-4); and
                flash_attention non-causal at phases 24 and 25's shapes:
                llama-3.2-vision's cross-attention (batch 4, 32 heads, 512
                queries over 1,601 vision tokens, D 128) and seamless-m4t's
                encoder (batch 4, 16 heads, 960 x 960 frames, D 64);
10. serve    -- the LM main path: Jamba-v0.1 at full width, one period of
                8 layers, random weights from ``torch.Generator`` seed 0,
                ``ServeEngine(max_batch=4, max_len=1024)`` serving 8
                requests (prompts of 128-512 tokens, 8-32 new tokens), once
                cold and once measured.  The counters are zeroed just before
                the measured run and read just after: each admission wave
                (W >= 2) launches flash_attention once and ssm_scan once per
                Mamba2 layer (7 W); (c) then one (4, 512) prefill of the
                blocks into empty caches, timed both ways: told they are
                empty (``prefill_step``'s route) and reading each
                attention layer's cache lengths back to the host;
11. serve card vs CPU -- reduced Jamba (16 layers) with the same weights
                on both devices, layer by layer, for a prefill and 4
                decode steps, within 2e-2;
12. lm backward kernels -- ssm_scan_bwd at phase 14's shapes and
                flash_attention_bwd at phase 15's against autograd of their
                plain versions (5e-2 and 2e-2 of each gradient's largest
                magnitude, bf16), and the float32 CUDA-core ssm_scan_bwd
                in chunks of 128 (1e-4), timed beside the plain version's
                backward, the bound and, for flash, the backward of
                ``scaled_dot_product_attention`` (a yardstick only); and
                flash_attention_bwd non-causal at seamless-m4t's training
                shapes (the encoder, 960 x 960, and the decoder's
                cross-attention, 512 x 960; batch 4, 16 heads, D 64);
13. horner   -- the KAN workload's first layer, 784 x 512 edge polynomials
                of degree 8 over a batch of 64 (25.7 M elements), in
                float32 and bfloat16 through ``ops.horner``, bit for bit
                against the plain version, timed (CUDA events and
                torch.profiler's device time) beside its byte bound;
14. train    -- the slice's main path: ``train_loop`` on mamba2-780m at
                full width and depth (48 layers, 0.78e9 parameters),
                global batch 8 x 2,048 tokens, 6 steps, remat, float32
                moments, one checkpoint at the end (deleted after).  The
                counters are zeroed just before and read just after:
                ssm_scan launches twice per layer and step (the forward
                and its rematerialisation), ssm_scan_bwd once;
15. train attention -- starcoder2-15b at full width, depth cut from 40 to
                4 layers (the whole model's train state does not fit one
                card): ``train_loop`` for 4 steps of batch 4 x 2,048,
                remat, float32 moments, one checkpoint at the end (deleted
                after); flash_attention launches twice and
                flash_attention_bwd once per layer and step; (c) then the
                trained state through ``ElasticMesh.reshard_state`` onto
                the (1, 1) mesh of an NCCL group of one rank: every
                parameter and moment bit for bit, plain on the card, and
                one more step from it with a finite loss;
16. train card vs CPU -- one training step's loss and gradients of reduced
                Jamba, mamba2 and starcoder2 with the same weights on both
                devices, in bf16 and in float32 (Jamba's gradients layer by
                layer), per leaf; planted faults (a layer in float8, a
                layer dropped, a zeroed dq or db) must be rejected;
17. exact    -- (runs right after phase 7, with phases 4 and 6 still in
                memory) ``EvalEngine(backend="exact")`` on ``cuda``, the
                search that maps and executes each op row in one pass, cold
                on phase 4's 512 genomes x 20 workloads,
                served by one ``DSEService`` with a sqlite store under
                ``build/`` to an in-process and a TCP tenant that start
                together and ask for 384 genomes each, 256 in common (one
                coalesced dispatch against the tenants' separate 2), and
                on the first 256 of phase 6's in throughput mode on a local
                engine: bit for bit those phases' rows; evaluations/s
                beside phase 4's (both backends run the same search loop,
                ``batched_mapper._search_one``, in micro-batches of 1,024);
18. search   -- (right after phase 17) the search frontends on
                PARITY_WORKLOADS through one shared exact engine on
                ``cuda``: ``run_sweeps`` (seeds 0, 1, 8 genomes a stratum),
                ``run_ga(loop="host")`` at 200 mm^2, ``run_bayes`` with the
                Eq. 8 objective, and seed 0's Pareto front over (mean
                energy, area, mean latency) by ``pareto_front`` and by
                ``pareto_mask_device`` on the card (equal); then the same
                search with a fresh engine on ``cpu``: the same sampled
                genomes, GA best genome, Pareto indices and BO optimum, the
                GA history within rel 1e-9; seconds per stage;
19. oracle   -- (right after phase 18) the host ``ChipSim`` oracle and the
                host compiler beside the card: (a) ``hetero_bls()`` on the
                six golden workloads in both modes, ``compile_workload`` +
                ``simulate`` on the host and ``simulate_plans`` on ``cuda``
                for the same plans (within rel 1e-9 per module, per-tile op
                counts and gating equal; the oracle's ``golden_dict()``
                within rtol 1e-6 of the golden files); (b) on phase 7's 64
                genomes in both modes, ``EvalEngine(exact_mapper=
                "python")`` on ``cuda`` bit for bit phase 7's card rows,
                ``backend="oracle"`` within rel 1e-9 of them (ok masks
                equal) and ``rescore(oracle=True)`` on the first 16 bit for
                bit the oracle engine; (c) the NVDLA points of Table 2 on
                the INT8 64x64x64 GEMM through the oracle and the card
                (within rel 1e-9), with the ratios to the published NVDLA
                values beside the paper's (printed, not gated); seconds of
                the host compile, the card's plan execution and the oracle
                walk, and evaluations/s of both engines;
20. scan and link -- (right after phase 19) (a) the default engine,
                ``EvalEngine(backend="scan")`` (the approximate in-scan
                mapping), on ``cuda``, cold on phase 4's 512
                genomes x 20 workloads and the first 256 of phase 6's in
                throughput mode: evaluations/s beside phases 4 and 17, and
                its error against those phases' exact rows (median, 99th
                percentile and maximum of |scan / exact - 1| over pairs
                finite in both, the pairs whose ok differs; printed, not
                gated); phase 7's 64 genomes through the scan on ``cuda``
                and on ``cpu``, both modes and both fidelity tiers, within
                rel 1e-9 with equal inf/finite patterns; (b) the link
                fidelity tier: the six golden workloads on the link chip
                of tests/test_golden_traces.py (``hetero_bls()`` on a
                2:1 torus, 2 DRAM channels, 32 B/cycle NoC links) through
                the host oracle (``golden_dict()`` within rtol 1e-6 of
                ``tests/golden/*_link.json``) and ``simulate_plans`` on
                ``cuda`` (within rel 1e-9 of the oracle, the two link
                bounds included); the exact engine with
                ``fidelity="link"`` on phase 6's first 256 genomes (II at
                least phase 6's on every pair) and on phase 7's 64 in
                latency mode (bit for bit phase 7's card rows); the
                ``exact_mapper="python"`` engine bit for bit the exact one,
                and the oracle engine on the first 16 within rel 1e-9, on
                the link tier in throughput mode; seconds of each part;
21. pipeline -- (right after phase 20) the §4 study on ``resnet50_int8`` and
                ``kan`` (README's quickstart), cut from the paper's 20
                workloads, 3 seeds, about 980 K sweep samples a seed and
                100 generations to 2 workloads, seeds 0 and 1, 8 genomes a
                stratum (120 a seed) and 4 generations (population 200, the
                paper's): (a) on one shared exact engine on ``cuda``, seed
                0's sweep, then ``run_ga(loop="device")`` and
                ``run_ga(loop="fused")`` at 200 mm^2, bit for bit each other,
                and the fused loop's device configs of its final population
                bit for bit ``genomes_to_configs``; memo fill and hits; (b)
                ``run_pipeline`` over the five brackets with a checkpoint on
                ``cuda``, then the same study on ``cpu`` (the same sweep
                genomes, best genome per (seed, bracket) and front genomes;
                front points and fitness within rel 1e-9), then a rerun on
                ``cuda`` against the same directory (every stage resumed,
                bit for bit); (c) seed 0 at 100 and 200 mm^2 stopped by an
                ``on_stage`` callback after its first refinement and rerun,
                bit for bit an uninterrupted run in another directory, with
                ``results.sqlite``'s row count and versions; seconds of each
                part and stage, evaluations, the front's size, the best
                fitness and mean iso-area savings per bracket.
22. service  -- (right after phase 21) the evaluation service and the
                worker cluster on ``cuda``: (a) a second service on the
                sqlite file of phase 17's served dispatch (whose tenants
                got phase 4's rows byte for byte in fewer coalesced
                dispatches than their separate total) serves the
                in-process tenant's genomes again from above 50 % store
                hits, byte for byte; (b) on
                ``resnet50_int8`` and ``kan``, the served ``search``
                (population 32, 4 generations) and the served ``pipeline``
                (seed 0, brackets 100 and 200, 4 genomes a stratum,
                population 16, 2 generations) byte for byte the local
                ``run_ga`` and ``run_pipeline`` on the card; (c) a 3-worker
                ``DSECluster`` under planted ``worker_kill`` and
                ``shard_timeout`` faults: (b)'s GA, then ``run_pipeline(
                cluster=, checkpoint=)`` with (b)'s study, each byte for
                byte (b)'s local run, every planted fault fired, and the
                checkpoint replayed by a local run; (d) ``dse_hillclimb``
                through a ``DSEClient`` byte for byte the local engine's;
                the phase's seconds and each part's, the service counters
                and the cluster's membership;
23. serve MLA -- (after phase 16) deepseek-v2-lite whole (27 layers: the
                dense-FFN prefix layer and 26 MLA + MoE layers, 64 routed
                experts top-6 and 2 shared), weights from seed 0, served
                as phase 10 serves Jamba (with its (c)): flash_attention
                launches 0 times (MLA's products are einsums);
24. serve with context -- llama-3.2-vision (40 layers, 8 of them
                cross-attention) and seamless-m4t (12 encoder and 12
                decoder layers) whole, through ``serve/step.py`` with a
                context (the reference's engine passes none): vision
                embeddings (4, 1,601, 4,096), or ``encode`` of (4, 960,
                1,024) frames; a (4, 512) prefill and 16 greedy decode
                steps, cold and measured (the same tokens); flash_attention
                launches once per encoder layer, once per layer and per
                ``xattn`` in the prefill, never in a decode step;
25. context card vs CPU, train -- (a) reduced deepseek, llama-3.2-vision
                and seamless-m4t, layer by layer as phase 11, with a
                context of 100 rows (the encoder's layers held too); (b)
                phase 16 on reduced seamless-m4t and llama-3.2-vision (its
                gradients layer by layer), a zeroed dq rejected; (c)
                ``train_loop`` on seamless-m4t whole, 4 steps of 4 x 512
                tokens and 960 frames, remat, float32 moments, one
                checkpoint (deleted after): flash_attention 60 launches a
                step (the encoder's 12 and the decoder's 24 twice, the
                forward and its rematerialisation), flash_attention_bwd
                36.
26. sharding -- (after phase 25) the sharding layer on one card: (a)
                ``make_mesh_for_devices(1)``, a (1, 1) ``DeviceMesh`` over
                an NCCL group of one rank, and ``ring_allgather_matmul``
                on it against ``torch.matmul`` of the same operands (one
                rank: no send); (b) ``EvalEngine(EngineConfig(shard=
                True))``, batched and exact, on 64 genomes x ``kan`` and
                ``resnet50_int8``, bit for bit ``shard=False`` (one
                device: ``candidate_sharding`` is None and
                ``default_islands(64) == 1``); (c) reduced starcoder2-15b
                trained 12 steps, once straight through and once with its
                state passed through ``ElasticMesh.reshard_state`` at step
                6: the last losses within rtol 1e-6 (the backward kernels
                add by atomics, so bit for bit is not asked on the card).
                The process group is destroyed at the end;
27. dry-run  -- host work, no card: ``launch.dryrun.run_cell`` on
                granite-20b ``train_4k`` over the (16, 16) fake mesh of
                256 ranks (flops, bytes and collective bytes a device by
                kind, peak GiB a device, and ``roofline.analyze``'s three
                terms at the H100's data-sheet rates), then
                ``search_mesh(granite-20b, chips=256, global_batch=256,
                seq_len=4096)``'s top three.

Then one JSON line describing the kernels (times, launches, bounds) and,
as the last line, ``{"ok": true, "device": {...}}``.  ``--out PATH`` also
writes every number to a JSON file; ``--profile`` adds torch.profiler
traces of one DSE micro-batch (4b) and one exact micro-batch (17b), of
one prefill wave and one decode step (10b) and of one training step of
each training phase (14b, 15b).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, dense bf16 on
# the tensor cores, HBM3 rate.  (All assume the full 700 W power limit.)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

DEVICE = "cuda"
# phase 4 (and phase 3's shapes): cut from 4,096 to 2,048 so that the run
# with phase 21 stays under 900 s (phase 4 took 373.9 s at 4,096 on an
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md), then to 1,024 to make room for
# phase 22 (215.9-217.1 s at 2,048), then to 512 for phases 26-27 (the
# script took 1,037.5-1,074.3 s with 1,024 on slow hosts, phase 4 141.1 s)
POPULATION = 512
THROUGHPUT_POPULATION = 512
PARITY_POPULATION = 64
THROUGHPUT_WORKLOADS = ["kan", "resnet50_int8", "hyena_1_3b",
                        "llama7b_int4"]
PARITY_WORKLOADS = ["kan", "resnet50_int8", "hyena_1_3b"]
# phase 17: the exact engine on the first genomes of phases 4 and 6 (cut
# to keep the run's time: phase 4 at 4,096 took 240-490 s)
EXACT_POPULATION, EXACT_THROUGHPUT_POPULATION = 512, 256
# phase 18: the search frontends on PARITY_WORKLOADS
SEARCH_SEEDS, SEARCH_SAMPLES, SEARCH_BRACKET = (0, 1), 8, 200.0
SEARCH_GA = dict(population=32, generations=4, seed_top_k=16, early_stop=4)
SEARCH_BO = dict(init_samples=32, rounds=2, batch_per_round=8,
                 candidate_pool=256)
GOLDEN_WORKLOADS = ["resnet50_int8", "vit_b16_fp16", "llama7b_int4",
                    "snn_vgg9", "hyena_1_3b", "kan"]
# phase 19: rescore(oracle=True) on the first of phase 7's genomes; the
# MOSAIC / NVDLA ratios the paper reports in Table 2 (latency, energy, area)
ORACLE_RESCORE_POPULATION = 16
# phase 20: the scan engine on the first genomes of phases 4 and 6 (phase
# 17's cut; 512 takes as long as 1,024: the scan's cost is per op row),
# and the link tier's exact engine on the first of phase 6's
SCAN_POPULATION, SCAN_THROUGHPUT_POPULATION = 512, 256
LINK_POPULATION = 256
NVDLA_PAPER_RATIOS = {"nv_small": (1.08, 1.41, 1.77),
                      "nv_full": (1.39, 1.19, 1.50)}
# phase 21: the §4 pipeline on README's quickstart study, cut from the
# paper's (20 workloads, 3 seeds, ~980 K sweep samples a seed, 100
# generations) to 2 workloads, 2 seeds, 8 genomes a stratum (120 a seed)
# and 4 generations; the population stays the paper's 200
PIPELINE_WORKLOADS = ["resnet50_int8", "kan"]
PIPELINE_SEEDS, PIPELINE_SAMPLES, PIPELINE_BRACKET = (0, 1), 8, 200.0
PIPELINE_GA = dict(population=200, generations=4, early_stop=4)
RESUME_BRACKETS = (100.0, 200.0)
# phase 17 serves its exact genomes to two tenants of one DSEService, the
# halves of EXACT_POPULATION overlapping by SERVICE_SHARED genomes, within
# a batching window of SERVICE_WINDOW_MS (a cold exact dispatch on the 20
# workloads takes 75-109 s on the card whatever its size, so phase 22 (a)
# measures the coalescing on phase 17's dispatch, not on one of its own);
# phase 22: (a) a second service on that dispatch's sqlite file; (b)-(d)
# on PIPELINE_WORKLOADS: the served search, the served pipeline (seed 0,
# two brackets), a 3-worker cluster under planted faults and the hillclimb
SERVICE_SHARED, SERVICE_WINDOW_MS = 256, 1000.0
SERVICE_SEARCH = dict(population=32, generations=4, seed_top_k=16,
                      early_stop=10_000)
SERVICE_PIPELINE = dict(seeds=(0,), brackets=(100.0, 200.0),
                        samples_per_stratum=4,
                        cfg=dict(population=16, generations=2, seed_top_k=8,
                                 early_stop=10_000))
CLUSTER_WORKERS = 3
# shard indices at which the planted faults fire: the GA's (a shard per
# live worker per generation) and the pipeline's (its one sweep call)
CLUSTER_GA_FAULTS = {"worker_kill": (1,), "shard_timeout": (3,)}
CLUSTER_PIPELINE_FAULTS = {"worker_kill": (1,), "shard_timeout": (0,)}
SERVICE_HILLCLIMB = dict(budget_mm2=200.0, steps=2, neighbors=16, seed=0)

# the LM serving path: Jamba-v0.1 at full width, one period of 8 layers
LM_ARCH = "jamba-v0.1-52b"
LM_LAYERS = 8
SERVE_BATCH, SERVE_MAX_LEN, SERVE_REQUESTS = 4, 1024, 8
PREFILL_ROUTE_REPS = 5      # phases 10 (c) and 23 (c): each way, alternating
PROMPT_LENS = (128, 256, 384, 512)   # multiples of the SSD chunk (64)
NEW_TOKENS = (8, 16, 24, 32)
PARITY_LAYERS = 16                   # reduced Jamba, repeat axis at 2
PARITY_DECODE_STEPS = 4
LM_TOL = 2e-2                        # bf16, rtol and atol
SSM_TOL = 5e-2                       # tests/test_kernels.py, bf16

# phases 23-25: the configs that need MLA and the dense prefix, a vision
# context or the encoder, at full width and depth (all three fit the card)
MLA_ARCH = "deepseek-v2-lite-16b"
VISION_ARCH = "llama-3.2-vision-11b"
AUDIO_ARCH = "seamless-m4t-medium"
CTX_BATCH, CTX_PROMPT, CTX_DECODE_STEPS = 4, 512, 16
CTX_PARITY_ROWS = 100     # phase 25 (a): context rows of the reduced models
ENC_TRAIN_BATCH, ENC_TRAIN_SEQ, ENC_TRAIN_STEPS = 4, 512, 4
# seamless-m4t's first steps: at 0.02 its loss went from 12.83 to 10.94
# and then 15.24 (step 4); at 0.002, 0.005 and 0.01 it fell to 10.53-10.75
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md)
ENC_TRAIN_LR = 0.005

# the LM training path
TRAIN_SEQ = 2048
TRAIN_SSM_ARCH, TRAIN_SSM_BATCH, TRAIN_SSM_STEPS = "mamba2-780m", 8, 6
TRAIN_ATTN_ARCH, TRAIN_ATTN_LAYERS = "starcoder2-15b", 4
TRAIN_ATTN_BATCH, TRAIN_ATTN_STEPS = 4, 4
# AdamW's first updates move every weight by about the rate, and a layer's
# output by about that times its fan-in (24,576 in starcoder2's FFN, 3,072
# in mamba2's out_proj), so the wider model takes the smaller rate (with
# 0.1 for both, starcoder2's loss rose from 11.9 to 24.5 at step 3 on an
# NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  warmup_cosine scales each by
# step / 200 in these first steps.
TRAIN_SSM_LR, TRAIN_ATTN_LR = 0.02, 1e-3
# gradients, by the error over the gradient's largest magnitude (bf16)
FLASH_BWD_TOL, SSM_BWD_TOL = 2e-2, 5e-2
# the float32 CUDA-core scans (phases 9 and 12) at mamba2-780m's training
# shape in chunks of 128 rows, tests/test_kernels.py's float32 limit (y
# rel + abs; each gradient over its largest magnitude)
F32_CHUNK, F32_SSM_TOL = 128, 1e-4
# every scan kernel cuts a chunk into tiles of at most this many rows, each
# its own sub-chunk (csrc/ssm_tc.cuh, csrc/ssm_scan.cu): the quadratic
# work of a chunk of L rows is that of ceil(L / 64) tiles
SCAN_TILE_ROWS = 64
# card against CPU, per leaf, as tests/test_torch_train_step.py holds the
# port against the reference: bf16 gradients within 2e-2 of each element
# plus 2e-2 of the leaf's largest magnitude, float32 within 1e-4 of both.
# Mamba2's d_skip gradient (a cancelling sum of bf16 products: mostly
# rounding in bf16) is held in float32 only; the MoE router's (zero: the
# top-k gates enter only through their sum, which is 1) within 2^-20 of
# the largest gradient.
GRAD_RTOL, GRAD_ATOL, F32_TOL = 2e-2, 2e-2, 1e-4
FLOAT32_ONLY, ZERO_GRAD = ("mamba.d_skip",), ("ffn.router.w",)
# the loss, relative: the card's bf16 losses were 1.3e-5 to 1.3e-4 (Jamba,
# whose routing flips) from the CPU's (NVIDIA H100 80GB HBM3, 700 W), and on
# the CPU the planted faults (the first layer's matrices through float8
# e4m3; the last layer dropped) move it by 9.4e-4 to 4.4e-2 (PERF.md)
LOSS_RTOL = {"bfloat16": 2e-4, "float32": 1e-5}
TRAIN_PARITY_ARCHS = ("jamba-v0.1-52b", "mamba2-780m", "starcoder2-15b")
# the reduced configs whose gradients phases 16 and 25 (b) hold layer by
# layer (their docstring says why)
LAYER_BY_LAYER = ("jamba", "llama-3.2-vision")
# phase 26: the sharding layer on one card
SHARD_WORKLOADS = ["kan", "resnet50_int8"]      # phase 18's two smallest
SHARD_POPULATION = 64
RING_SHAPE = (4096, 2048, 2048)                 # x (S, D) @ w (D, F)
ELASTIC_ARCH = "starcoder2-15b"
ELASTIC_STEPS, ELASTIC_AT = 12, 6
ELASTIC_BATCH, ELASTIC_SEQ = 4, 128
ELASTIC_RTOL = 1e-6     # a resumed run's bar, tests/test_train_substrate.py
# phase 27: the dry-run's cell and the mesh search's
DRYRUN_CELL = ("granite-20b", "train_4k")
# the KAN workload's first layer (src/repro/core/workloads/misc.py): 784 x
# 512 edge polynomials of degree 8, over a batch of 64
KAN_ELEMENTS, KAN_DEGREE = 784 * 512 * 64, 8

# fp32 operations the kernel's formula needs per (candidate, op, tile
# slot), by the op's class (src/repro_torch/csrc/dse_eval.cu):
#   common to every class: bw / clock, max(., 1e-9), bytes / that,
#     max(c_cmp, c_bw), / clock, exists > 0, the ok conjunction, the inf
#     select, the running-min compare                                  = 9
#   MAC: num_macs > 0, prec_ok > 0, and, num_macs * eta, max, divide,
#     select, mac_ok | dsp_ok, lanes > 0                               = 9
#   DSP: max(lanes, 1), divide, ceil, * sqrt-term, lanes > 0          = 5
#   SPECIAL: divide + floor (mask / kind), fmod, compare, max(par, 1),
#     divide, max(lanes, 1), divide, ceil, select, lanes > 0         = 11
# plus, per (candidate, op), the energy multiply-add (2).
_SLOT_OPS = {0: 9 + 9, 1: 9 + 5, 2: 9 + 11}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


_T0 = [None]            # the run's start (``main``)
_ELAPSED = {}           # each phase's last line: seconds since the start


def _phase(n, name, text):
    if _T0[0] is not None:
        _ELAPSED[f"{n} {name}"] = time.perf_counter() - _T0[0]
    print(f"[{n} {name}] {text}", flush=True)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0].strip()


def _time_ms(torch, fn, reps):
    """Mean ms of ``fn()`` over ``reps`` runs, CUDA events, after one
    warm-up run."""
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


def _compare_bounds(np, got, want):
    """The seconds and the energy bit for bit (the kernel does the plain
    version's IEEE operations in its order, the energy's multiply and add
    rounded apart); returns (max rel err of finite seconds, max abs err
    over finite entries, max abs err of the energy)."""
    fin = np.isfinite(want[..., 0])
    check(np.array_equal(fin, np.isfinite(got[..., 0])),
          "kernel and plain version disagree on which ops are hostable")
    gs, ws = got[..., 0][fin].astype(np.float64), \
        want[..., 0][fin].astype(np.float64)
    rel = np.abs(gs - ws) / np.maximum(np.abs(ws), 1e-30)
    check(np.array_equal(got[..., 0], want[..., 0]),
          f"kernel seconds not bit for bit the plain version's (max rel err "
          f"{rel.max(initial=0.0):.3e})")
    ge, we = got[..., 1].astype(np.float64), want[..., 1].astype(np.float64)
    e_err = float(np.abs(ge - we).max(initial=0.0))
    check(np.array_equal(got[..., 1], want[..., 1]),
          f"kernel energy not bit for bit the plain version's (max abs err "
          f"{e_err:.6g})")
    abs_err = max(float(np.abs(gs - ws).max(initial=0.0)), e_err)
    return float(rel.max(initial=0.0)), abs_err, e_err


def _device_ms(torch, fn, reps, match):
    """Device ms per run of ``fn()`` by torch.profiler (``reps`` runs after
    a warm-up), summed by kernel name over the kernels whose name contains
    ``match``.  Returns ({name: [ms per run, launches per run]}, total ms
    per run, sessions): a session that saw none of the kernels is tried
    again, up to three sessions, and ``sessions`` counts them (on an
    NVIDIA H100 a session has once seen none, cause unknown: PERF.md).
    When all three saw none the total is None: not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for sessions in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_name = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA") and match in e.name:
                r = per_name.setdefault(e.name, [0.0, 0])
                r[0] += float(e.time_range.elapsed_us()) / 1e3 / reps
                r[1] += 1
        if per_name:
            break
    for r in per_name.values():
        r[1] /= reps
    total = sum(r[0] for r in per_name.values()) if per_name else None
    return per_name, total, sessions


def _device_text(ms, by_name, sessions):
    """The device time as the phases print it."""
    if ms is None:
        return f"device not measured (torch.profiler saw no such kernel " \
            f"in {sessions} sessions)"
    return f"device {ms:.4f} ms (torch.profiler, session {sessions}: " \
        f"{json.dumps(by_name)})"


def _trace(torch, run):
    """Run ``run`` (which ends in a synchronisation) once to warm up, once
    timed and once under torch.profiler.  Returns wall seconds with and
    without the profiler, the summed device time of the kernels, their
    count, the device's busy share of the profiled wall and the top five
    kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        prof_wall = time.perf_counter() - t0
    dev_us, n_kernels, per_name = 0.0, 0, {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            us = float(e.time_range.elapsed_us())
            dev_us += us
            n_kernels += 1
            per_name[e.name] = per_name.get(e.name, 0.0) + us
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    return {"wall_s": plain_wall, "profiled_wall_s": prof_wall,
            "device_busy_s": dev_us / 1e6, "device_kernels": n_kernels,
            "busy_share_of_profiled_wall": dev_us / 1e6 / prof_wall,
            "top_kernels_us": top}


def _profile_micro_batch(torch, np, genomes, dev):
    """Trace one engine micro-batch: ``map_and_simulate`` of resnet50_int8
    on phase 4's 512 genomes."""
    from repro_torch.core.compiler.batched_mapper import map_and_simulate
    from repro_torch.core.dse.engine import genomes_to_configs, \
        prepared_workload
    from repro_torch.core.simulator.batched import place_configs

    ws = prepared_workload("resnet50_int8")
    cfgs = genomes_to_configs(genomes)
    placed = place_configs(cfgs, dev)

    def run():
        map_and_simulate(ws, cfgs, device=dev, placed=placed,
                         placements=False)
        torch.cuda.synchronize()

    out = _trace(torch, run)
    _phase("4b", "profile", json.dumps(out))
    return out


def _profile_serve_steps(torch, model, cfg, dev):
    """Trace one (4, 512) prefill wave and one decode step of the serving
    path on the full-width model."""
    from repro_torch.models.model import decode_step
    from repro_torch.serve.step import make_prefill_step

    g = torch.Generator(device=dev).manual_seed(10)
    toks = torch.randint(0, cfg.vocab, (SERVE_BATCH, max(PROMPT_LENS)),
                         generator=g, device=dev, dtype=torch.int32)
    prefill = make_prefill_step(cfg, SERVE_MAX_LEN)
    # the serving steps run in inference mode, and so do updates of the
    # caches they return
    with torch.inference_mode():
        logits, caches = prefill(model, toks)
        nxt = logits[:, -1:].argmax(-1).to(torch.int32)
        pos = torch.full((SERVE_BATCH,), toks.shape[1], dtype=torch.int32,
                         device=dev)

        def run_prefill():
            prefill(model, toks)
            torch.cuda.synchronize()

        def run_decode():   # advances the caches by one step each call
            decode_step(model, nxt, pos, caches)
            torch.cuda.synchronize()

        out = {"prefill": _trace(torch, run_prefill),
               "decode": _trace(torch, run_decode)}
    _phase("10b", "profile", json.dumps(out))
    return out


def dse_launches(np, dev):
    """Phase 3's inputs: POPULATION genomes from ``default_rng(0)``, their
    configs placed on ``dev``, and the ``dse_eval`` launches
    ``pack_launches`` makes of them over the 20 workloads; returns
    (genomes, configs, placed, launches)."""
    from repro_torch.core.dse.encoding import random_genomes
    from repro_torch.core.dse.engine import (genomes_to_configs,
                                             prepared_workload)
    from repro_torch.core.dse.prefilter import pack_launches
    from repro_torch.core.simulator.batched import place_configs
    from repro_torch.core.workloads import workload_names

    genomes = random_genomes(np.random.default_rng(0), POPULATION)
    cfgs = genomes_to_configs(genomes)
    placed = place_configs(cfgs, dev)
    launches = []
    for w in workload_names():
        launches += pack_launches(cfgs, prepared_workload(w), device=dev,
                                  placed=placed)
    return genomes, cfgs, placed, launches


def _dse_phases(torch, np, dev, args, record):
    """Phases 3-7 and 17-22, the DSE evaluation path, the search on top of
    it, the host oracle beside it, the scan and link tiers, the §4
    pipeline, the service and the cluster; returns the kernel line of
    ``dse_eval``.  Its tensors are freed
    when it returns."""
    from repro_torch.core.arch import hetero_bls
    from repro_torch.core.compiler.batched_mapper import map_and_simulate
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.encoding import random_genomes
    from repro_torch.core.dse.engine import EvalEngine, prepared_workload
    from repro_torch.core.dse.prefilter import roofline_bounds
    from repro_torch.core.simulator.batched import stack_chip_configs
    from repro_torch.core.workloads import workload_names
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    names = workload_names()
    # ---- 3. kernel against its plain version -------------------------------
    genomes, cfgs, placed, launches = dse_launches(np, dev)
    max_rel, max_abs, max_e = 0.0, 0.0, 0.0
    for _, tiles, ops in launches:
        got = kops.dse_eval(tiles, ops)
        want = kref.dse_eval_ref(tiles, ops)
        torch.cuda.synchronize()
        r, a, e = _compare_bounds(np, got.cpu().numpy(), want.cpu().numpy())
        max_rel, max_abs, max_e = max(max_rel, r), max(max_abs, a), \
            max(max_e, e)
    # no tile can host the ops: inf seconds, energy from tile 0 (ref.py)
    nt = torch.zeros((2, 4, kref.TILE_FIELDS), dtype=torch.float32,
                     device=dev)
    nt[..., 3] = 1e9
    nt[..., 8] = torch.tensor([1.5, 2.0, 3.0, 4.0], device=dev)
    nt[1, :, 0] = 1.0
    no = torch.tensor([[0, 1000, 10, 100, 1, 1, 0], [1, 0, 50, 100, 1, 1, 0]],
                      dtype=torch.float32, device=dev)
    edge = kops.dse_eval(nt, no).cpu().numpy()
    check(np.isinf(edge[..., 0]).all(), "no-hostable case: seconds not inf")
    check(np.allclose(edge[..., 1], [[1505.0, 25.0]] * 2, rtol=1e-6),
          f"no-hostable case: energy {edge[..., 1].tolist()}")

    def run_kernel():
        for _, tiles, ops in launches:
            kops.dse_eval(tiles, ops)

    def run_plain():
        for _, tiles, ops in launches:
            kref.dse_eval_ref(tiles, ops)

    kernel_ms = _time_ms(torch, run_kernel, 20)
    plain_ms = _time_ms(torch, run_plain, 3)
    # the device's own time: with a fast kernel the host's dispatch of 40
    # small launches may set the event time
    dev_names, dev_ms, dev_sessions = _device_ms(torch, run_kernel, 5,
                                                 "dse_eval")
    n_bytes = sum(t.numel() * 4 + o.numel() * 4 + t.shape[0] * o.shape[0] * 8
                  for _, t, o in launches)
    n_ops = 0
    for _, t, o in launches:
        B, T = t.shape[0], t.shape[1]
        cls = o[:, 0].long().cpu().numpy()
        n_ops += B * T * sum(_SLOT_OPS[int(c)] for c in cls) \
            + B * len(cls) * 2
    bytes_ms = n_bytes / PEAK_HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    record["kernel"] = {
        "launches_per_suite": len(launches), "max_rel_err_seconds": max_rel,
        "max_abs_err": max_abs, "max_abs_err_energy": max_e,
        "ms": kernel_ms, "device_ms": dev_ms, "device_ms_by_name": dev_names,
        "profiler_sessions": dev_sessions,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": n_bytes, "fp32_ops": n_ops}
    _phase(3, "kernel", f"{len(launches)} launches over 20 workloads x "
           f"{POPULATION} genomes: seconds and energy bit for bit (max rel "
           f"err {max_rel:.3e}, energy max abs err {max_e:.6g}); kernel "
           f"{kernel_ms:.4f} ms (CUDA events), "
           f"{_device_text(dev_ms, dev_names, dev_sessions)}, plain "
           f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
           f"{n_ops:.4g} fp32 ops at {PEAK_FP32_FLOPS:.3g}/s, "
           f"{n_bytes:.4g} B at {PEAK_HBM_BYTES_PER_S:.3g} B/s, H100 SXM "
           f"data sheet); library: none (no single PyTorch call computes "
           f"this function)")

    # ---- 4. main path: the engine ------------------------------------------
    kops.reset_launch_counts()
    eng = EvalEngine(names, config=EngineConfig(backend="batched",
                                                mode="latency"))
    check(eng.device.type == DEVICE, f"engine on {eng.device}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.evaluate(genomes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = res["latency"]
    check(lat.shape == (POPULATION, len(names)), f"latency shape {lat.shape}")
    for k in ("latency", "energy", "tops_w", "area"):
        check(not np.isnan(res[k]).any(), f"NaN in {k}")
    fin = np.isfinite(lat)
    check(fin.mean() > 0.5, f"finite share {fin.mean():.3f}")
    check((lat[fin] > 0).all() and (res["energy"][fin] > 0).all(),
          "non-positive latency or energy")
    evals = POPULATION * len(names) / wall
    record["main_path"] = {"wall_s": wall, "evals_per_s": evals,
                           "finite_share": float(fin.mean()),
                           "meta": res["meta"]}
    _phase(4, "main path", f"EvalEngine batched/latency on {eng.device}: "
           f"{POPULATION} genomes x {len(names)} workloads in {wall:.3f} s = "
           f"{evals:.1f} candidate-workload evaluations/s; finite share "
           f"{fin.mean():.4f}; meta {json.dumps(res['meta'])}")

    if args.profile:
        record["profile"] = _profile_micro_batch(torch, np, genomes, dev)

    # ---- 5. prefilter (the kernel's caller), same candidates ---------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bounds = {w: roofline_bounds(cfgs, prepared_workload(w), device=dev,
                                 placed=placed) for w in names}
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0
    main_launches = dict(kops.launch_counts)       # read just after
    check(main_launches["dse_eval"] > 0,
          "the main path never launched the dse_eval kernel")
    check(main_launches["dse_eval"] == len(launches),
          f"{main_launches['dse_eval']} launches, expected {len(launches)}")
    above, pairs = 0, 0
    for j, w in enumerate(names):
        sb = bounds[w][..., 0].double().sum(dim=1).cpu().numpy()
        ok = np.isfinite(lat[:, j])
        above += int((sb[ok] > lat[ok, j]).sum())
        pairs += int(ok.sum())
    share_above = above / max(pairs, 1)
    record["prefilter"] = {"wall_s": pre_wall, "launches": main_launches,
                           "share_bound_above_latency": share_above}
    again = eng.evaluate(genomes)
    check(again["meta"]["hits"] == POPULATION and
          again["meta"]["misses"] == 0, f"second call meta {again['meta']}")
    check(np.array_equal(again["latency"], lat), "memo hit changed latency")
    _phase(5, "prefilter", f"roofline_bounds over {POPULATION} x "
           f"{len(names)}: {pre_wall:.3f} s wall incl. packing, "
           f"{main_launches['dse_eval']} dse_eval launches in the main-path "
           f"run (kernel time for these launches: {kernel_ms:.4f} ms, "
           f"phase 3); summed per-op bound > exact latency in "
           f"{share_above:.4f} of {pairs} finite pairs (information only); "
           f"second evaluate: {again['meta']['hits']} hits")

    # ---- 6. throughput mode ------------------------------------------------
    g1 = random_genomes(np.random.default_rng(1), THROUGHPUT_POPULATION)
    eng_t = EvalEngine(THROUGHPUT_WORKLOADS,
                       config=EngineConfig(backend="batched",
                                           mode="throughput"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rt = eng_t.evaluate(g1)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    fin_t = np.isfinite(rt["latency"])
    check(not np.isnan(rt["latency"]).any() and fin_t.mean() > 0.5,
          f"throughput finite share {fin_t.mean():.3f}")
    evals_t = len(g1) * len(THROUGHPUT_WORKLOADS) / wall_t
    record["throughput"] = {"wall_s": wall_t, "evals_per_s": evals_t,
                            "finite_share": float(fin_t.mean())}
    _phase(6, "throughput", f"EvalEngine batched/throughput: {len(g1)} x "
           f"{len(THROUGHPUT_WORKLOADS)} in {wall_t:.3f} s = "
           f"{evals_t:.1f} evaluations/s; finite share "
           f"{fin_t.mean():.4f}; meta {json.dumps(rt['meta'])}")

    # ---- 7. card against CPU, and the golden traces ------------------------
    g2 = random_genomes(np.random.default_rng(2), PARITY_POPULATION)
    worst, rows_equal, rows = 0.0, 0, 0
    card_rows = {}                      # phase 19 holds its engines to them
    for mode in ("latency", "throughput"):
        cfg = EngineConfig(backend="batched", mode=mode)
        on_card = card_rows[mode] = EvalEngine(PARITY_WORKLOADS,
                                               config=cfg).evaluate(g2)
        on_cpu = EvalEngine(PARITY_WORKLOADS, config=cfg,
                            device="cpu").evaluate(g2)
        check(np.array_equal(np.isfinite(on_card["latency"]),
                             np.isfinite(on_cpu["latency"])),
              f"{mode}: ok masks differ between card and CPU")
        same = np.ones(len(g2), bool)
        for k in ("latency", "energy", "tops_w"):
            a, b = on_card[k], on_cpu[k]
            f = np.isfinite(b)
            check(np.array_equal(f, np.isfinite(a)), f"{mode} {k} mask")
            err = np.abs(a[f] - b[f]) / np.maximum(np.abs(b[f]), 1e-300)
            worst = max(worst, float(err.max(initial=0.0)))
            same &= (a == b).all(axis=1)
        rows_equal += int(same.sum())
        rows += len(g2)
    check(worst <= 1e-9, f"card vs CPU rel err {worst:.3e} > 1e-9")
    golden_worst = 0.0
    chip = stack_chip_configs([hetero_bls()])
    for w in GOLDEN_WORKLOADS:
        r = map_and_simulate(prepared_workload(w), chip, device=dev)
        check(bool(r["ok"][0]), f"golden {w}: unmappable")
        for suffix in ("", "_throughput"):
            with open(os.path.join(ROOT, "tests", "golden",
                                   f"{w}{suffix}.json")) as fh:
                g = json.load(fh)
            pairs_g = [(r["latency_s"][0], g["latency_s"]),
                       (r["energy_pj"][0], g["energy_pj"]),
                       (r["area_mm2"][0], g["area_mm2"])]
            pairs_g += [(r[f"energy_{m}_pj"][0], v) for m, v in
                        g["energy_breakdown"].items() if m != "total"]
            pairs_g += [(r[k][0], v) for k, v in
                        (g.get("pipeline") or {}).items()]
            for got_v, want_v in pairs_g:
                check(np.isclose(got_v, want_v, rtol=1e-6, atol=1e-12),
                      f"golden {w}{suffix}: {got_v!r} vs {want_v!r}")
                golden_worst = max(golden_worst, abs(got_v - want_v)
                                   / max(abs(want_v), 1e-300))
    record["card_vs_cpu"] = {"max_rel_err": worst, "rows_bitwise": rows_equal,
                             "rows": rows, "golden_max_rel_err": golden_worst}
    _phase(7, "card vs CPU", f"{len(g2)} genomes x {len(PARITY_WORKLOADS)} "
           f"workloads x 2 modes: ok masks equal, max rel err {worst:.3e} "
           f"(limit 1e-9), {rows_equal}/{rows} rows bitwise; golden traces "
           f"({len(GOLDEN_WORKLOADS)} workloads x 2 modes on cuda) max rel "
           f"err {golden_worst:.3e} (limit 1e-6)")

    # ---- 17-20. the exact search, the search frontends, the oracle, the
    # scan backend and the link tier --------------------------------------
    record["exact"], served = _exact_phase(torch, np, dev, args, genomes,
                                           res, record["main_path"], g1, rt)
    record["search"] = _search_phase(torch, np, dev)
    record["oracle"] = _oracle_phase(torch, np, dev, g2, card_rows)
    record["scan_link"] = _scan_link_phase(torch, np, dev, genomes, res,
                                           g1, rt, g2, card_rows, record)
    record["pipeline"] = _pipeline_phase(torch, np, dev)
    record["service"] = _service_phase(torch, np, dev, served)

    return {
        "name": "dse_eval", "route": "cuda",
        "source": "src/repro_torch/csrc/dse_eval.cu",
        "replaces": "src/repro/kernels/dse_eval.py:79",
        "launches": main_launches["dse_eval"], "max_abs_err": max_abs,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}


_ROWS = ("latency", "energy", "tops_w")


def _same_rows(np, got, want, what):
    """The engine's three metric columns bit for bit (inf where unmappable
    in the same places)."""
    for k in _ROWS:
        check(got[k].shape == want[k].shape, f"{what} {k} shape")
        check(np.array_equal(np.isinf(got[k]), np.isinf(want[k])),
              f"{what}: {k} inf in other places")
        check(np.array_equal(got[k], want[k]),
              f"{what}: {k} not bit for bit (max abs diff "
              f"{float(np.nanmax(np.abs(got[k] - want[k]))):.3e})")


def _served_exact(torch, np, dev, names, g, store_dir):
    """Score ``g`` on ``names`` cold through one ``DSEService`` over an
    exact engine on ``dev`` with a sqlite store in ``store_dir``: an
    in-process and a TCP tenant start together through a barrier and ask
    for the two halves of ``g``, overlapping by SERVICE_SHARED genomes.
    Holds the two tenants' rows of their shared genomes byte for byte,
    and the coalesced dispatches below the tenants' separate count.
    Returns the rows of ``g`` in order, the tenants' seconds, the service
    counters and the tenants' genomes."""
    import threading
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.engine import EvalEngine
    from repro_torch.core.dse.store import (MemoryLRUStore, SqliteStore,
                                            TieredStore)
    from repro_torch.serve.dse_service import DSEClient, DSEService

    wait_s = 600.0
    half = (len(g) + SERVICE_SHARED) // 2
    overlap = 2 * half - len(g)
    tenant_g = {"in-process": g[:half], "tcp": g[len(g) - half:]}
    store_path = os.path.join(store_dir, "results.sqlite")
    store = TieredStore(MemoryLRUStore(), SqliteStore(store_path))
    svc = DSEService(EvalEngine(names, config=EngineConfig(
        backend="exact", mode="latency", store=store), device=dev),
        max_batch=len(g), max_wait_ms=SERVICE_WINDOW_MS).start()
    served, errs = {}, []
    try:
        check(svc.engine.device.type == torch.device(dev).type,
              f"exact engine on {svc.engine.device}")
        address = svc.listen()
        barrier = threading.Barrier(len(tenant_g))

        def tenant(name):
            try:
                cl = (DSEClient(service=svc, timeout=wait_s)
                      if name == "in-process"
                      else DSEClient(address=address, timeout=wait_s))
                barrier.wait(wait_s)
                served[name] = cl.evaluate(tenant_g[name])
                cl.close()
            except Exception as exc:    # noqa: BLE001 - raised below
                errs.append(exc)

        threads = [threading.Thread(target=tenant, args=(t,))
                   for t in tenant_g]
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(wait_s)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a tenant hung")
        if errs:
            raise errs[0]
        st = svc.stats
        # each tenant alone: one cold dispatch of each micro-batch
        separate = sum(-(-len(x) // svc.engine.batch)
                       for x in tenant_g.values())
        check(st.engine_dispatches < separate,
              f"{st.engine_dispatches} coalesced dispatches, not fewer "
              f"than the tenants' separate {separate}")
        stats = st.snapshot(svc.max_batch)
    finally:
        svc.stop()
        store.close()
    a, b = served["in-process"], served["tcp"]
    keys = _ROWS + ("area",)
    for k in keys:
        check(a[k][len(g) - half:].tobytes() == b[k][:overlap].tobytes(),
              f"the tenants' rows of their shared genomes differ: {k}")
    return {"rows": {k: np.concatenate([a[k], b[k][overlap:]])
                     for k in keys},
            "wall_s": wall, "stats": stats, "separate": separate,
            "batch": svc.engine.batch,
            "tenants": tenant_g, "overlap": overlap, "store": store_path,
            "dir": store_dir}


def _exact_phase(torch, np, dev, args, genomes, res4, main_path, g1, rt):
    """Phase 17: ``EvalEngine(backend="exact")`` (the search: one pass per
    workload mapping and executing each row) cold on the first
    EXACT_POPULATION of phase 4's genomes on all 20 workloads, served to
    two overlapping tenants by one ``DSEService`` (``_served_exact``),
    and on the first EXACT_THROUGHPUT_POPULATION of phase 6's in
    throughput mode on a local engine; both bit for bit equal to those
    phases' rows.  Returns its numbers and, for phase 22 (a), what
    ``_served_exact`` returned (its sqlite store stays in ``build/``
    until phase 22 removes it)."""
    import tempfile
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.engine import EvalEngine
    from repro_torch.core.workloads import workload_names

    names = workload_names()
    g = genomes[:EXACT_POPULATION]
    served = _served_exact(torch, np, dev, names, g, tempfile.mkdtemp(
        prefix="service_", dir=os.path.join(ROOT, "build")))
    rx, wall, st = served["rows"], served["wall_s"], served["stats"]
    _same_rows(np, rx, {k: res4[k][:len(g)] for k in _ROWS}, "exact "
               "(served) vs phase 4")
    check(served["batch"] >= len(g) and st["engine_dispatches"] == 1,
          f"micro-batch {served['batch']}, service {st}")
    evals = len(g) * len(names) / wall

    gt = g1[:EXACT_THROUGHPUT_POPULATION]
    eng_t = EvalEngine(THROUGHPUT_WORKLOADS,
                       config=EngineConfig(backend="exact",
                                           mode="throughput"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rxt = eng_t.evaluate(gt)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    _same_rows(np, rxt, {k: rt[k][:len(gt)] for k in _ROWS}, "exact "
               "throughput vs phase 6")
    out = {"wall_s": wall, "evals_per_s": evals,
           "phase4_evals_per_s": main_path["evals_per_s"],
           "throughput_wall_s": wall_t,
           "throughput_evals_per_s": len(gt) * len(THROUGHPUT_WORKLOADS)
           / wall_t, "service": st,
           "tenant_genomes": [len(x) for x in served["tenants"].values()],
           "shared_genomes": served["overlap"],
           "separate_dispatches": served["separate"]}
    _phase(17, "exact", f"EvalEngine exact/latency on {dev}, served by a "
           f"DSEService with a sqlite store to an in-process and a TCP "
           f"tenant of {out['tenant_genomes']} genomes ({served['overlap']}"
           f" shared): {len(g)} genomes x {len(names)} workloads in "
           f"{wall:.3f} s = {evals:.1f} evaluations/s (phase 4, batched: "
           f"{main_path['evals_per_s']:.1f}; both in micro-batches of "
           f"{served['batch']}), bit for bit phase 4's rows; "
           f"{st['engine_dispatches']} coalesced dispatch against "
           f"{served['separate']} separate, {st['batches']} batches "
           f"({st['coalesced_batches']} coalesced), {st['inflight_merged']}"
           f" in-flight merges, mean queue {st['mean_queue_ms']:.3f} ms; "
           f"throughput mode {len(gt)} x {len(THROUGHPUT_WORKLOADS)} in "
           f"{wall_t:.3f} s = {out['throughput_evals_per_s']:.1f} "
           f"evaluations/s, bit for bit phase 6's rows")
    if args.profile:
        out["profile"] = _profile_exact_micro_batch(torch, genomes, dev)
    return out, served


def _profile_exact_micro_batch(torch, genomes, dev):
    """Trace one exact micro-batch: ``search_population`` of resnet50_int8
    on phase 4's 512 genomes (phase 4b's inputs)."""
    from repro_torch.core.compiler.batched_mapper import search_population
    from repro_torch.core.dse.engine import genomes_to_configs, \
        prepared_workload
    from repro_torch.core.simulator.batched import place_configs

    ws = prepared_workload("resnet50_int8")
    cfgs = genomes_to_configs(genomes)
    placed = place_configs(cfgs, dev)

    def run():
        search_population([ws], cfgs, out_keys=("latency_s", "energy_pj",
                                                "achieved_tops"),
                          device=dev, placed=placed)
        torch.cuda.synchronize()

    out = _trace(torch, run)
    _phase("17b", "profile", json.dumps(out))
    return out


def _search(np, device):
    """Phase 18's search on one device: the stratified sweep (two seeds),
    the host GA at 200 mm^2, BO with the Eq. 8 objective and the Pareto
    front of seed 0's sweep, through one shared exact engine.  Returns
    the results and the seconds of each stage."""
    import torch
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.bayes import BayesConfig, run_bayes
    from repro_torch.core.dse.engine import EvalEngine
    from repro_torch.core.dse.ga import GAConfig, run_ga
    from repro_torch.core.dse.objective import fitness
    from repro_torch.core.dse.pareto import (pareto_front, pareto_mask,
                                             pareto_mask_device)
    from repro_torch.core.dse.sweep import run_sweeps

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    eng = EvalEngine(PARITY_WORKLOADS, config=EngineConfig(backend="exact"),
                     device=device)
    secs = {}
    t0 = time.perf_counter()
    sweeps = run_sweeps(PARITY_WORKLOADS, seeds=SEARCH_SEEDS,
                        samples_per_stratum=SEARCH_SAMPLES, engine=eng)
    sync()
    secs["sweep"] = time.perf_counter() - t0
    base = sweeps[0].homo_baseline()
    check(SEARCH_BRACKET in base, f"no homogeneous baseline at "
          f"{SEARCH_BRACKET} mm^2 in seed 0's sweep")
    e_homo = base[SEARCH_BRACKET]

    t0 = time.perf_counter()
    ga = run_ga(sweeps[0], SEARCH_BRACKET, GAConfig(**SEARCH_GA),
                loop="host", engine=eng)
    sync()
    secs["ga"] = time.perf_counter() - t0
    check(ga is not None and np.isfinite(ga.best_fitness),
          "GA found no finite fitness")

    def eq8(m):             # Eq. 8 against seed 0's baseline at the bracket
        tw = m["tops_w"].max(axis=1)
        return np.asarray([fitness(e, e_homo, t, tw.max())
                           for e, t in zip(m["energy"], tw)])

    t0 = time.perf_counter()
    bo = run_bayes(PARITY_WORKLOADS, eq8, BayesConfig(**SEARCH_BO),
                   engine=eng)
    sync()
    secs["bo"] = time.perf_counter() - t0
    check(np.isfinite(bo["best_score"]), "BO found no finite score")

    # examples/dse_search.py's front: (mean energy, area, mean latency)
    sw = sweeps[0]
    valid = sw.valid_mask()
    pts = np.stack([sw.energy[valid].mean(1), sw.area[valid],
                    sw.latency[valid].mean(1)], axis=1)
    t0 = time.perf_counter()
    front = pareto_front(pts)
    on_dev = pareto_mask_device(pts, device=device).cpu().numpy()
    secs["pareto"] = time.perf_counter() - t0
    check(np.array_equal(on_dev, pareto_mask(pts)),
          f"pareto_mask_device on {device} differs from pareto_mask")
    check(np.array_equal(np.flatnonzero(on_dev), np.sort(front)),
          "the two fronts differ")
    return {"sweeps": sweeps, "ga": ga, "bo": bo, "front": front,
            "valid": int(valid.sum()), "secs": secs,
            "stats": dataclasses.asdict(eng.stats)}


def _search_phase(torch, np, dev):
    """Phase 18: the search frontends on the card (``_search``), then the
    same search with a fresh engine on the CPU: the same sampled genomes,
    GA best genome, Pareto indices and BO optimum, and a GA history within
    rel 1e-9."""
    card = _search(np, dev)
    cpu = _search(np, "cpu")
    for s in SEARCH_SEEDS:
        check(np.array_equal(card["sweeps"][s].genomes,
                             cpu["sweeps"][s].genomes),
              f"seed {s}: sampled genomes differ between card and CPU")
    check(np.array_equal(card["ga"].best_genome, cpu["ga"].best_genome),
          "GA best genome differs between card and CPU")
    hc, hp = np.asarray(card["ga"].history), np.asarray(cpu["ga"].history)
    ga_err = float(np.max(np.abs(hc - hp) / np.maximum(np.abs(hp), 1e-300)))
    check(hc.shape == hp.shape and ga_err <= 1e-9,
          f"GA history card vs CPU: rel err {ga_err:.3e} > 1e-9")
    check(np.array_equal(card["front"], cpu["front"]),
          "Pareto indices differ between card and CPU")
    check(np.array_equal(card["bo"]["best_genome"], cpu["bo"]["best_genome"]),
          "BO optimum differs between card and CPU")
    st = card["stats"]
    evals = (st["misses"] * st["workloads"]) / max(st["eval_seconds"], 1e-12)
    out = {"card_s": card["secs"], "cpu_s": cpu["secs"],
           "card_stats": st, "cpu_stats": cpu["stats"],
           "card_evals_per_s": evals,
           "sweep_genomes": {s: len(card["sweeps"][s].genomes)
                             for s in SEARCH_SEEDS},
           "ga_best_fitness": card["ga"].best_fitness,
           "ga_history_rel_err": ga_err, "ga_evaluated": card["ga"].evaluated,
           "bo_best_score": card["bo"]["best_score"],
           "front": card["front"].tolist(), "valid": card["valid"]}
    secs = ", ".join(f"{k} {v:.3f}" for k, v in card["secs"].items())
    cpu_secs = ", ".join(f"{k} {v:.3f}" for k, v in cpu["secs"].items())
    _phase(18, "search", f"exact engine on {PARITY_WORKLOADS} on {dev}: "
           f"sweep seeds {list(SEARCH_SEEDS)} x {SEARCH_SAMPLES}/stratum "
           f"({sum(out['sweep_genomes'].values())} genomes), GA at "
           f"{SEARCH_BRACKET:.0f} mm^2 ({card['ga'].evaluated} evaluated, "
           f"best fitness {card['ga'].best_fitness:+.6f}), BO (best Eq. 8 "
           f"{card['bo']['best_score']:+.6f}), Pareto front "
           f"{len(card['front'])} of {card['valid']} valid (pareto_front "
           f"== pareto_mask_device); card s: {secs}; "
           f"{evals:.1f} evaluations/s over the engine's evaluate time; "
           f"engine hits {st['hits']} misses {st['misses']} skips "
           f"{st['skips']}; CPU s: {cpu_secs}; card == CPU: genomes, GA "
           f"best genome, Pareto indices, BO optimum; GA history rel err "
           f"{ga_err:.3e} (limit 1e-9)")
    return out

# the oracle's per-module energies, as ``simulate_plans`` names them
_ORACLE_MODULES = ("compute", "dram", "sram", "irf", "orf", "dsp", "special",
                   "noc", "leakage", "fuse_savings")


def _oracle_vs_plans(np, r, res, what):
    """One ``ChipSim`` result against ``simulate_plans``'s row 0: chip
    metrics, per-module energy and the pipeline keys within rel 1e-9 (abs
    1e-9 pJ for a module the run leaves at zero, as
    tests/test_golden_traces.py holds them), per-tile op counts and gating
    equal.  Returns the largest relative error."""
    pairs = [("latency_s", r.latency_s), ("energy_pj", r.energy_pj),
             ("achieved_tops", r.achieved_tops), ("area_mm2", r.area_mm2),
             ("peak_tops", r.peak_tops)]
    pairs += [(f"energy_{m}_pj", getattr(r.energy_breakdown, m))
              for m in _ORACLE_MODULES]
    pairs += list((r.pipeline or {}).items())
    worst = 0.0
    for k, want in pairs:
        got = float(res[k][0])
        diff = abs(got - want)
        check(diff <= 1e-9 * abs(want) or diff <= 1e-9,
              f"{what} {k}: card {got!r} vs oracle {want!r}")
        if want != 0.0:
            worst = max(worst, diff / abs(want))
    n = len(r.tiles)
    check(res["tile_ops"][0][:n].tolist() == [b.ops for b in r.tiles],
          f"{what}: per-tile op counts differ")
    check(res["power_gated"][0][:n].tolist()
          == [b.power_gated for b in r.tiles], f"{what}: power gating differs")
    active = np.asarray([b.active_s for b in r.tiles])
    err = np.abs(res["tile_active_s"][0][:n] - active) \
        / np.maximum(np.abs(active), 1e-300)
    check(err.max(initial=0.0) <= 1e-9, f"{what}: tile active time rel err "
          f"{err.max():.3e}")
    return max(worst, float(err.max(initial=0.0)))


def _golden_worst(np, want, got, path=""):
    """The largest relative difference of two golden payloads; raises past
    the golden comparator's rtol 1e-6, atol 1e-12 (tests/conftest.py)."""
    if isinstance(want, dict):
        check(set(want) == set(got), f"golden {path}: keys differ")
        return max((_golden_worst(np, want[k], got[k], f"{path}.{k}")
                    for k in want), default=0.0)
    if isinstance(want, list):
        check(len(want) == len(got), f"golden {path}: length differs")
        return max((_golden_worst(np, a, b, f"{path}[{i}]")
                    for i, (a, b) in enumerate(zip(want, got))), default=0.0)
    if isinstance(want, (bool, str)):
        check(want == got, f"golden {path}: {got!r} vs {want!r}")
        return 0.0
    check(np.isclose(got, want, rtol=1e-6, atol=1e-12),
          f"golden {path}: {got!r} vs {want!r}")
    return abs(got - want) / max(abs(want), 1e-300)


def _oracle_phase(torch, np, dev, g2, card_rows):
    """Phase 19: the host ``ChipSim`` oracle and the host compiler beside
    the card -- (a) the golden runs, (b) the per-candidate engines on phase
    7's genomes, (c) the NVDLA points of Table 2."""
    from repro_torch.core.arch import hetero_bls
    from repro_torch.core.calibrate.nvdla import (NVDLA_FULL, NVDLA_SMALL,
                                                  nvdla_chip)
    from repro_torch.core.compiler.mapper import map_graph
    from repro_torch.core.compiler.pipeline import (compile_workload,
                                                    lower_plan)
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.encoding import decode
    from repro_torch.core.dse.engine import EvalEngine, _prepared_graph
    from repro_torch.core.ir import OpNode, OpType, Precision, WorkloadGraph
    from repro_torch.core.simulator.batched import simulate_plans
    from repro_torch.core.simulator.orchestrator import simulate
    from repro_torch.core.workloads import build

    secs = {"compile": 0.0, "card": 0.0, "oracle": 0.0}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        if key == "card":
            torch.cuda.synchronize()
        secs[key] += time.perf_counter() - t0
        return out

    # ---- (a) the golden runs: oracle, card, golden files -------------------
    chip = hetero_bls()
    card_worst, golden_worst, runs = 0.0, 0.0, 0
    for w in GOLDEN_WORKLOADS:
        for mode, suffix in (("latency", ""), ("throughput", "_throughput")):
            plan = timed("compile", lambda: compile_workload(
                build(w), chip, mode=mode))
            r = timed("oracle", lambda: simulate(chip, plan))
            res = timed("card", lambda: simulate_plans(
                [chip], [lower_plan(plan, chip.num_tiles)], device=dev))
            check(res["mode"] == mode, f"{w}: mode {res['mode']}")
            card_worst = max(card_worst, _oracle_vs_plans(
                np, r, res, f"{w}{suffix}"))
            with open(os.path.join(ROOT, "tests", "golden",
                                   f"{w}{suffix}.json")) as fh:
                golden_worst = max(golden_worst, _golden_worst(
                    np, json.load(fh), r.golden_dict(), f"{w}{suffix}"))
            runs += 1
    golden_secs = dict(secs)

    # ---- (b) the per-candidate engines on phase 7's genomes ----------------
    chips = [decode(g, f"x{i}") for i, g in enumerate(g2)]
    t0 = time.perf_counter()
    for w in PARITY_WORKLOADS:
        graph = _prepared_graph(w)
        for c in chips:
            map_graph(graph, c)
    compile_s = time.perf_counter() - t0
    evals = len(g2) * len(PARITY_WORKLOADS)
    n_re = ORACLE_RESCORE_POPULATION
    engine_secs, oracle_worst = {}, 0.0
    for mode in ("latency", "throughput"):
        card = card_rows[mode]
        py_eng = EvalEngine(PARITY_WORKLOADS, config=EngineConfig(
            backend="batched", exact_mapper="python", mode=mode))
        check(py_eng.device.type == DEVICE, f"engine on {py_eng.device}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        py = py_eng.evaluate(g2)
        torch.cuda.synchronize()
        engine_secs[f"python_{mode}"] = time.perf_counter() - t0
        _same_rows(np, py, card, f"{mode}: python mapper vs phase 7's card "
                   "rows")
        t0 = time.perf_counter()
        ora = EvalEngine(PARITY_WORKLOADS, config=EngineConfig(
            backend="oracle", mode=mode)).evaluate(g2)
        engine_secs[f"oracle_{mode}"] = time.perf_counter() - t0
        check(np.array_equal(np.isfinite(ora["latency"]),
                             np.isfinite(card["latency"])),
              f"{mode}: oracle and card ok masks differ")
        for k in _ROWS:
            a, b = ora[k], card[k]
            f = np.isfinite(b)
            check(np.array_equal(f, np.isfinite(a)), f"{mode} {k} mask")
            err = np.abs(a[f] - b[f]) / np.maximum(np.abs(b[f]), 1e-300)
            oracle_worst = max(oracle_worst, float(err.max(initial=0.0)))
        check(oracle_worst <= 1e-9, f"{mode}: oracle vs card rows rel err "
              f"{oracle_worst:.3e} > 1e-9")
        re = EvalEngine(PARITY_WORKLOADS, config=EngineConfig(
            backend="batched", mode=mode)).rescore(g2[:n_re], oracle=True)
        _same_rows(np, re, {k: ora[k][:n_re] for k in _ROWS},
                   f"{mode}: rescore(oracle=True) vs the oracle engine")
        check((re["meta"]["backend"], re["meta"]["mapper"])
              == ("oracle", "python"), f"rescore meta {re['meta']}")

    # ---- (c) the NVDLA points of Table 2 -----------------------------------
    def gemm64():
        g = WorkloadGraph("gemm64", model_precision=Precision.INT8)
        g.add(OpNode("gemm", OpType.MATMUL, m=64, k=64, n=64,
                     precision=Precision.INT8, splittable=False))
        return g

    nvdla = {}
    for point in (NVDLA_SMALL, NVDLA_FULL):
        nv_chip = nvdla_chip(point)
        plan = compile_workload(gemm64(), nv_chip)
        r = simulate(nv_chip, plan)
        res = simulate_plans([nv_chip], [lower_plan(plan, nv_chip.num_tiles)],
                             device=dev)
        _oracle_vs_plans(np, r, res, point.name)
        mosaic = {"latency_us": r.latency_s * 1e6,
                  "energy_nj": r.energy_pj * 1e-3, "area_mm2": r.area_mm2,
                  "tops_per_w": r.tops_per_w}
        ratio = {"latency": mosaic["latency_us"] / point.latency_us,
                 "energy": mosaic["energy_nj"] / point.energy_nj,
                 "area": mosaic["area_mm2"] / point.area_mm2}
        nvdla[point.name] = {"mosaic": mosaic, "ratio": ratio,
                             "paper_ratio": dict(zip(
                                 ("latency", "energy", "area"),
                                 NVDLA_PAPER_RATIOS[point.name]))}

    out = {"golden_runs": runs, "card_vs_oracle_max_rel_err": card_worst,
           "golden_max_rel_err": golden_worst, "golden_secs": golden_secs,
           "compile_s": compile_s, "engine_secs": engine_secs,
           "oracle_vs_card_rows_max_rel_err": oracle_worst,
           "python_evals_per_s": {m: evals / engine_secs[f"python_{m}"]
                                  for m in ("latency", "throughput")},
           "oracle_evals_per_s": {m: evals / engine_secs[f"oracle_{m}"]
                                  for m in ("latency", "throughput")},
           "nvdla": nvdla}
    nv = "; ".join(
        f"{n}: {v['mosaic']['latency_us']:.4f} us, "
        f"{v['mosaic']['energy_nj']:.4f} nJ, {v['mosaic']['area_mm2']:.4f} "
        f"mm^2, {v['mosaic']['tops_per_w']:.4f} TOPS/W, MOSAIC/NVDLA "
        f"latency {v['ratio']['latency']:.3f} (paper "
        f"{v['paper_ratio']['latency']:.2f}), energy "
        f"{v['ratio']['energy']:.3f} ({v['paper_ratio']['energy']:.2f}), "
        f"area {v['ratio']['area']:.3f} ({v['paper_ratio']['area']:.2f})"
        for n, v in nvdla.items())
    es = engine_secs
    _phase(19, "oracle", f"(a) hetero_bls x {len(GOLDEN_WORKLOADS)} golden "
           f"workloads x 2 modes: simulate_plans on {dev} within rel "
           f"{card_worst:.3e} of the host ChipSim (limit 1e-9), tile ops and "
           f"gating equal, golden_dict() max rel err {golden_worst:.3e} "
           f"(limit 1e-6); host compile {golden_secs['compile']:.3f} s, card "
           f"plan execution {golden_secs['card']:.3f} s, oracle walk "
           f"{golden_secs['oracle']:.3f} s. (b) {len(g2)} genomes x "
           f"{len(PARITY_WORKLOADS)} workloads: map_graph alone "
           f"{compile_s:.3f} s; python-mapper engine on {dev} "
           f"{es['python_latency']:.3f} s / {es['python_throughput']:.3f} s "
           f"(latency / throughput; "
           f"{out['python_evals_per_s']['latency']:.1f} / "
           f"{out['python_evals_per_s']['throughput']:.1f} evaluations/s), "
           f"bit for bit phase 7's card rows; oracle engine "
           f"{es['oracle_latency']:.3f} s / {es['oracle_throughput']:.3f} s "
           f"({out['oracle_evals_per_s']['latency']:.1f} / "
           f"{out['oracle_evals_per_s']['throughput']:.1f} evaluations/s), "
           f"max rel err {oracle_worst:.3e} (limit 1e-9), ok masks equal; "
           f"rescore(oracle=True) on {n_re} bit for bit. (c) NVDLA INT8 "
           f"64x64x64 GEMM, oracle == card within 1e-9: {nv}")
    return out


def _scan_error(np, got, want):
    """The scan's rows against exact rows: |got / want - 1| over the
    (genome, workload) pairs finite in both, as median, 99th percentile
    and maximum, and the number of pairs whose ok (finite latency)
    differs."""
    out = {}
    for k in _ROWS:
        a, b = got[k], want[k]
        f = np.isfinite(a) & np.isfinite(b) & (b != 0)
        e = np.abs(a[f] / b[f] - 1.0)
        out[k] = {"median": float(np.median(e)) if e.size else 0.0,
                  "p99": float(np.percentile(e, 99)) if e.size else 0.0,
                  "max": float(e.max(initial=0.0)), "pairs": int(f.sum())}
    out["ok_differs"] = int((np.isfinite(got["latency"])
                             != np.isfinite(want["latency"])).sum())
    return out


def _scan_error_text(err):
    return ", ".join(f"{k} {v['median']:.3e} / {v['p99']:.3e} / "
                     f"{v['max']:.3e}" for k, v in err.items()
                     if k != "ok_differs") \
        + f" (median / p99 / max); ok differs in {err['ok_differs']} pairs"


def _link_chip():
    """tests/test_golden_traces.py's topology-exercising chip: hetero_bls
    on a 2:1 torus grid, narrow NoC links, two interleaved DRAM channels."""
    from repro_torch.core.arch import hetero_bls
    return dataclasses.replace(
        hetero_bls(), name="heteroBLS-link", torus=True, grid_aspect=2.0,
        dram_channels=2, noc_bytes_per_cycle=32.0)


def _scan_link_phase(torch, np, dev, genomes, res4, g1, rt, g2, card_rows,
                     record):
    """Phase 20: (a) the scan backend on the card beside phases 4, 6, 7
    and 17; (b) the link fidelity tier on the card beside the oracle, the
    golden traces and phases 6 and 7."""
    from repro_torch.core.compiler.pipeline import (compile_workload,
                                                    lower_plan)
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.engine import EvalEngine
    from repro_torch.core.simulator.batched import simulate_plans
    from repro_torch.core.simulator.orchestrator import simulate
    from repro_torch.core.workloads import build, workload_names

    names = workload_names()
    secs = {}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    # ---- (a) the scan backend, beside phases 4, 6 and 17 -------------------
    g = genomes[:SCAN_POPULATION]
    eng = EvalEngine(names, config=EngineConfig(mode="latency"))
    check((eng.backend, eng.device.type) == ("scan", DEVICE),
          f"default engine: {eng.backend} on {eng.device}")
    rs = timed("scan_latency", lambda: eng.evaluate(g))
    check(rs["latency"].shape == (len(g), len(names))
          and not np.isnan(rs["latency"]).any(), "scan latency: NaN or shape")
    evals = len(g) * len(names) / secs["scan_latency"]
    err = _scan_error(np, rs, {k: res4[k][:len(g)] for k in _ROWS})
    gt = g1[:SCAN_THROUGHPUT_POPULATION]
    eng_t = EvalEngine(THROUGHPUT_WORKLOADS,
                       config=EngineConfig(mode="throughput"))
    rst = timed("scan_throughput", lambda: eng_t.evaluate(gt))
    evals_t = len(gt) * len(THROUGHPUT_WORKLOADS) / secs["scan_throughput"]
    err_t = _scan_error(np, rst, {k: rt[k][:len(gt)] for k in _ROWS})
    # ---- (a) the scan on the card against the CPU, both modes and tiers ----
    t0 = time.perf_counter()
    cvc_worst = 0.0
    for mode in ("latency", "throughput"):
        for fid in ("aggregate", "link"):
            cfg = EngineConfig(mode=mode, fidelity=fid)
            on_card = EvalEngine(PARITY_WORKLOADS, config=cfg).evaluate(g2)
            on_cpu = EvalEngine(PARITY_WORKLOADS, config=cfg,
                                device="cpu").evaluate(g2)
            for k in _ROWS:
                a, b = on_card[k], on_cpu[k]
                f = np.isfinite(b)
                check(np.array_equal(f, np.isfinite(a)),
                      f"scan {mode}/{fid} {k}: card and CPU inf patterns "
                      f"differ")
                check(np.array_equal(a[~f], b[~f]),
                      f"scan {mode}/{fid} {k}: non-finite values differ")
                e = np.abs(a[f] - b[f]) / np.maximum(np.abs(b[f]), 1e-300)
                cvc_worst = max(cvc_worst, float(e.max(initial=0.0)))
    secs["scan_card_vs_cpu"] = time.perf_counter() - t0
    check(cvc_worst <= 1e-9, f"scan card vs CPU rel err {cvc_worst:.3e} "
          f"> 1e-9")

    # ---- (b) the link tier: the golden runs on the link chip ---------------
    chip = _link_chip()
    t0 = time.perf_counter()
    golden_worst, card_worst = 0.0, 0.0
    for w in GOLDEN_WORKLOADS:
        plan = compile_workload(build(w), chip, mode="throughput")
        r = simulate(chip, plan, fidelity="link")
        check({"ii_chan_bound_s", "ii_link_bound_s"} <= set(r.pipeline),
              f"{w}: the oracle's link bounds are missing")
        with open(os.path.join(ROOT, "tests", "golden",
                               f"{w}_link.json")) as fh:
            golden_worst = max(golden_worst, _golden_worst(
                np, json.load(fh), r.golden_dict(), f"{w}_link"))
        res = simulate_plans([chip], [lower_plan(plan, chip.num_tiles)],
                             fidelity="link", device=dev)
        card_worst = max(card_worst, _oracle_vs_plans(np, r, res,
                                                      f"{w}_link"))
    torch.cuda.synchronize()
    secs["link_golden"] = time.perf_counter() - t0

    # ---- (b) the link tier's engines, beside phases 6 and 7 ----------------
    def link_engine(workloads, mode, **kw):
        return EvalEngine(workloads, config=EngineConfig(
            mode=mode, fidelity="link", **kw))

    gl = g1[:LINK_POPULATION]
    rl = timed("link_exact_throughput", lambda: link_engine(
        THROUGHPUT_WORKLOADS, "throughput", backend="exact").evaluate(gl))
    agg = rt["latency"][:len(gl)]
    fin = np.isfinite(agg)
    check(np.array_equal(fin, np.isfinite(rl["latency"])),
          "link vs phase 6: ok masks differ")
    check((rl["latency"][fin] >= agg[fin]).all(),
          "the link tier's II is below phase 6's aggregate II")
    ii_ratio = rl["latency"][fin] / agg[fin]
    rll = timed("link_exact_latency", lambda: link_engine(
        PARITY_WORKLOADS, "latency", backend="exact").evaluate(g2))
    _same_rows(np, rll, card_rows["latency"], "link latency mode vs phase "
               "7's card rows")
    rx = timed("link_exact_parity", lambda: link_engine(
        PARITY_WORKLOADS, "throughput", backend="exact").evaluate(g2))
    py = timed("link_python", lambda: link_engine(
        PARITY_WORKLOADS, "throughput", backend="batched",
        exact_mapper="python").evaluate(g2))
    _same_rows(np, py, rx, "link: python mapper vs the exact engine")
    n_or = ORACLE_RESCORE_POPULATION
    ora = timed("link_oracle", lambda: link_engine(
        PARITY_WORKLOADS, "throughput", backend="oracle").evaluate(g2[:n_or]))
    oracle_worst = 0.0
    for k in _ROWS:
        a, b = ora[k], rx[k][:n_or]
        f = np.isfinite(b)
        check(np.array_equal(f, np.isfinite(a)), f"link oracle {k} mask")
        e = np.abs(a[f] - b[f]) / np.maximum(np.abs(b[f]), 1e-300)
        oracle_worst = max(oracle_worst, float(e.max(initial=0.0)))
    check(oracle_worst <= 1e-9, f"link oracle vs the exact engine rel err "
          f"{oracle_worst:.3e} > 1e-9")

    out = {"secs": secs, "scan_evals_per_s": evals,
           "scan_throughput_evals_per_s": evals_t,
           "phase4_evals_per_s": record["main_path"]["evals_per_s"],
           "phase17_evals_per_s": record["exact"]["evals_per_s"],
           "phase17_throughput_evals_per_s":
               record["exact"]["throughput_evals_per_s"],
           "scan_error_latency": err, "scan_error_throughput": err_t,
           "scan_card_vs_cpu_max_rel_err": cvc_worst, "scan_meta": rs["meta"],
           "link_golden_max_rel_err": golden_worst,
           "link_card_vs_oracle_max_rel_err": card_worst,
           "link_ii_over_aggregate": {
               "median": float(np.median(ii_ratio)),
               "max": float(ii_ratio.max(initial=1.0)),
               "share_above": float((ii_ratio > 1.0).mean())},
           "link_evals_per_s": len(gl) * len(THROUGHPUT_WORKLOADS)
           / secs["link_exact_throughput"],
           "link_oracle_max_rel_err": oracle_worst}
    lr = out["link_ii_over_aggregate"]
    _phase(20, "scan and link", f"(a) EvalEngine scan/latency on {dev}: "
           f"{len(g)} genomes x {len(names)} workloads in "
           f"{secs['scan_latency']:.3f} s = {evals:.1f} evaluations/s "
           f"(phase 4, batched: {out['phase4_evals_per_s']:.1f}; phase 17, "
           f"exact: {out['phase17_evals_per_s']:.1f}); against phase 4's "
           f"exact rows: {_scan_error_text(err)}; throughput {len(gt)} x "
           f"{len(THROUGHPUT_WORKLOADS)} in {secs['scan_throughput']:.3f} s "
           f"= {evals_t:.1f} evaluations/s (phase 17: "
           f"{out['phase17_throughput_evals_per_s']:.1f}), against phase "
           f"6's rows: {_scan_error_text(err_t)}; {len(g2)} x "
           f"{len(PARITY_WORKLOADS)} x 2 modes x 2 tiers card vs CPU max rel "
           f"err {cvc_worst:.3e} (limit 1e-9), inf patterns equal, "
           f"{secs['scan_card_vs_cpu']:.3f} s. (b) link chip x "
           f"{len(GOLDEN_WORKLOADS)} golden workloads (throughput): "
           f"golden_dict() max rel err {golden_worst:.3e} (limit 1e-6), "
           f"simulate_plans on {dev} within rel {card_worst:.3e} of the "
           f"oracle (limit 1e-9), {secs['link_golden']:.3f} s; exact engine "
           f"fidelity=link on {len(gl)} x {len(THROUGHPUT_WORKLOADS)} in "
           f"{secs['link_exact_throughput']:.3f} s = "
           f"{out['link_evals_per_s']:.1f} evaluations/s (phase 17's "
           f"aggregate: {out['phase17_throughput_evals_per_s']:.1f}), II / "
           f"phase 6's II median {lr['median']:.4f}, max {lr['max']:.4f}, "
           f"above 1 in {lr['share_above']:.4f} of pairs (never below); "
           f"latency mode on {len(g2)} x {len(PARITY_WORKLOADS)} bit for bit "
           f"phase 7's card rows ({secs['link_exact_latency']:.3f} s); "
           f"python mapper bit for bit the exact engine "
           f"({secs['link_python']:.3f} s, exact "
           f"{secs['link_exact_parity']:.3f} s); oracle engine on {n_or} "
           f"within rel {oracle_worst:.3e} (limit 1e-9, "
           f"{secs['link_oracle']:.3f} s)")
    return out


def _same_study(np, a, b, what):
    """Two ``PipelineResult``s bit for bit: sweeps, per (seed, bracket)
    results, the merged front and the evaluation count."""
    check(a.front_points.tobytes() == b.front_points.tobytes() and
          a.front_genomes.tobytes() == b.front_genomes.tobytes(),
          f"{what}: fronts differ")
    check(a.evaluated == b.evaluated, f"{what}: evaluations differ")
    for s in a.seeds:
        for f in ("genomes", "latency", "energy", "tops_w"):
            check(getattr(a.sweeps[s], f).tobytes()
                  == getattr(b.sweeps[s], f).tobytes(),
                  f"{what}: seed {s} sweep {f} differs")
        check(a.results[s].keys() == b.results[s].keys(),
              f"{what}: seed {s} brackets differ")
        for br, r in a.results[s].items():
            q = b.results[s][br]
            check(r.best_fitness == q.best_fitness and r.history == q.history
                  and r.best_genome.tobytes() == q.best_genome.tobytes()
                  and r.evaluated == q.evaluated, f"{what}: ({s}, {br}) GA "
                  f"result differs")
            for k in _ROWS:
                check(np.asarray(r.best_metrics[k]).tobytes()
                      == np.asarray(q.best_metrics[k]).tobytes(),
                      f"{what}: ({s}, {br}) best {k} differs")


def _pipeline_phase(torch, np, dev):
    """Phase 21: the §4 pipeline on PIPELINE_WORKLOADS.  (a) the device GA
    loop and the fused loop on one shared exact engine, bit for bit each
    other, and the fused loop's device configs bit for bit
    ``genomes_to_configs``; (b) ``run_pipeline`` with a checkpoint on the
    card, held against the same study on the CPU, then replayed from its
    checkpoint (every stage resumed, bit for bit); (c) a reduced study
    interrupted after its first refinement and resumed, bit for bit an
    uninterrupted run."""
    import tempfile
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.engine import EvalEngine, genomes_to_configs
    from repro_torch.core.dse.ga import GAConfig, run_ga
    from repro_torch.core.dse.ga_device import _configs_device, run_ga_fused
    from repro_torch.core.dse.objective import AREA_BRACKETS
    from repro_torch.core.dse.pipeline import run_pipeline
    from repro_torch.core.dse.store import SqliteStore
    from repro_torch.core.dse.sweep import run_sweep

    cfg = GAConfig(**PIPELINE_GA)
    secs = {}

    def timed(key, fn):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    # ---- (a) the two GA loops on one shared exact engine -------------------
    eng = EvalEngine(PIPELINE_WORKLOADS, config=EngineConfig(backend="exact"),
                     device=dev)
    sw = timed("a_sweep", lambda: run_sweep(
        PIPELINE_WORKLOADS, PIPELINE_SAMPLES, seed=0, engine=eng))
    ga_d = timed("a_device", lambda: run_ga(
        sw, PIPELINE_BRACKET, cfg, engine=eng, loop="device"))
    check(ga_d is not None and np.isfinite(ga_d.best_fitness),
          "(a) the device loop found no finite fitness")
    # the fused loop on the same engine: its memo preloads the device
    # loop's rows, and it searches the out-of-bracket children the device
    # loop's prefilter skipped; then run_ga's fused loop replays warm
    fused = timed("a_fused", lambda: run_ga_fused(
        sw, PIPELINE_BRACKET, cfg, engine=eng, islands=1))
    ga_f = timed("a_fused_warm", lambda: run_ga(
        sw, PIPELINE_BRACKET, cfg, engine=eng, loop="fused"))
    for r in (fused.result, ga_f):
        check(ga_d.best_genome.tobytes() == r.best_genome.tobytes()
              and ga_d.history == r.history
              and ga_d.evaluated == r.evaluated,
              "(a) run_ga device and fused loops differ")
    tile, chip, area = _configs_device(
        torch.as_tensor(fused.population, device=dev))
    host = genomes_to_configs(fused.population)
    for k, v in list(tile.items()) + list(chip.items()):
        want = host["tile" if k in tile else "chip"][k]
        check(v.cpu().numpy().tobytes()
              == np.ascontiguousarray(want, np.float64).tobytes(),
              f"(a) device config {k} differs from genomes_to_configs")
    check(area.cpu().numpy().tobytes() == host["chip"]["chip_area"].tobytes(),
          "(a) device chip area differs")
    memo_fill = int(fused.memo.used.sum())
    a_out = {"best_fitness": ga_d.best_fitness, "history": ga_d.history,
             "evaluated": ga_d.evaluated, "memo_fill": memo_fill,
             "memo_hits": fused.memo_hits, "fused_searches": fused.searches,
             "engine_stats": dataclasses.asdict(eng.stats)}

    # ---- (b) the study: card, CPU, replay ----------------------------------
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pipeline_", dir=root)
    try:
        def study(device, ck):
            events = []
            res = run_pipeline(PIPELINE_WORKLOADS, seeds=PIPELINE_SEEDS,
                               samples_per_stratum=PIPELINE_SAMPLES, cfg=cfg,
                               checkpoint=os.path.join(tmp, ck),
                               device=device, on_stage=events.append)
            return res, events

        card, ev_card = timed("b_card", lambda: study(dev, "card"))
        check(all(np.isfinite(r.best_fitness) for by_b in card.results.values()
                  for r in by_b.values()) and len(card.front_points) > 0,
              "(b) a refinement found no finite fitness or the front is empty")
        cpu, _ = timed("b_cpu", lambda: study("cpu", "cpu"))
        for s in PIPELINE_SEEDS:
            check(np.array_equal(card.sweeps[s].genomes, cpu.sweeps[s].genomes),
                  f"(b) seed {s}: sweep genomes differ between card and CPU")
            check(card.results[s].keys() == cpu.results[s].keys(),
                  f"(b) seed {s}: refined brackets differ")
            for b, r in card.results[s].items():
                check(np.array_equal(r.best_genome,
                                     cpu.results[s][b].best_genome),
                      f"(b) ({s}, {b}): best genome differs card vs CPU")
        check(np.array_equal(card.front_genomes, cpu.front_genomes),
              "(b) front genomes differ between card and CPU")
        rel = np.abs(card.front_points - cpu.front_points) \
            / np.maximum(np.abs(cpu.front_points), 1e-300)
        fit_rel = [abs(r.best_fitness - cpu.results[s][b].best_fitness)
                   / max(abs(cpu.results[s][b].best_fitness), 1e-300)
                   for s in PIPELINE_SEEDS for b, r in card.results[s].items()]
        worst = max(float(rel.max(initial=0.0)), max(fit_rel, default=0.0))
        check(worst <= 1e-9, f"(b) card vs CPU rel err {worst:.3e} > 1e-9")
        replay, ev_replay = timed("b_replay", lambda: study(dev, "card"))
        check(len(ev_replay) == len(ev_card)
              and all(e.get("resumed") is True for e in ev_replay),
              "(b) the replay recomputed a stage")
        _same_study(np, card, replay, "(b) replay")
        stage_s = dict(card.stage_seconds)
        per_bracket = {}
        for b in AREA_BRACKETS:
            best = card.best(b)
            if best is not None:
                per_bracket[b] = (best.best_fitness,
                                  float(np.mean(best.best_savings_per_wl)))

        # ---- (c) interrupted after the first refinement, resumed -----------
        class Stop(Exception):
            pass

        def tripwire(ev):
            if ev["stage"] == "refine":
                raise Stop

        kw_c = dict(seeds=(0,), brackets=RESUME_BRACKETS,
                    samples_per_stratum=PIPELINE_SAMPLES, cfg=cfg, device=dev)
        ck_c = os.path.join(tmp, "resume")
        try:
            run_pipeline(PIPELINE_WORKLOADS, checkpoint=ck_c,
                         on_stage=tripwire, **kw_c)
            check(False, "(c) the tripwire did not stop the run")
        except Stop:
            pass
        check(not [f for f in os.listdir(ck_c) if f.endswith(".tmp")],
              "(c) a torn record was left behind")
        resumed = timed("c_resume", lambda: run_pipeline(
            PIPELINE_WORKLOADS, checkpoint=ck_c, **kw_c))
        clean = timed("c_clean", lambda: run_pipeline(
            PIPELINE_WORKLOADS, checkpoint=os.path.join(tmp, "clean"),
            **kw_c))
        _same_study(np, resumed, clean, "(c) resumed vs uninterrupted")
        st = SqliteStore(os.path.join(ck_c, "results.sqlite"))
        rows, versions = len(st), st.version_counts()
        st.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = {"secs": secs, "a": a_out, "stage_s": stage_s,
           "evaluated": card.evaluated, "front": len(card.front_points),
           "per_bracket": {str(b): v for b, v in per_bracket.items()},
           "card_vs_cpu_max_rel_err": worst, "sqlite_rows": rows,
           "sqlite_versions": versions}
    brk = "; ".join(f"{b:.0f} mm^2 best {f:+.6f}, mean savings {m:+.4f}"
                    for b, (f, m) in per_bracket.items())
    _phase(21, "pipeline", f"(a) exact engine on {PIPELINE_WORKLOADS} on "
           f"{dev}: sweep seed 0 x {PIPELINE_SAMPLES}/stratum "
           f"({len(sw.genomes)} genomes, {secs['a_sweep']:.3f} s); GA at "
           f"{PIPELINE_BRACKET:.0f} mm^2, {cfg.population} x "
           f"{cfg.generations}: run_ga device ({secs['a_device']:.3f} s) == "
           f"run_ga_fused ({secs['a_fused']:.3f} s: memo fill {memo_fill}, "
           f"hits {fused.memo_hits} of {fused.result.evaluated}, "
           f"{fused.searches} searches) == run_ga fused, warm "
           f"({secs['a_fused_warm']:.3f} s) bit for bit (best "
           f"{ga_d.best_fitness:+.6f}, {ga_d.evaluated} evaluated); fused "
           f"configs == genomes_to_configs. (b) run_pipeline "
           f"seeds {list(PIPELINE_SEEDS)} x {len(AREA_BRACKETS)} brackets, "
           f"checkpointed: card {secs['b_card']:.3f} s (stages: "
           + ", ".join(f"{k} {v:.3f}" for k, v in stage_s.items())
           + f"), {card.evaluated} evaluations, front {len(card.front_points)}"
           f"; {brk}; CPU {secs['b_cpu']:.3f} s, same sweeps, best genomes "
           f"and front genomes, max rel err {worst:.3e} (limit 1e-9); replay "
           f"{secs['b_replay']:.3f} s, every stage resumed, bit for bit. (c) "
           f"seed 0 x brackets {list(RESUME_BRACKETS)} stopped after its "
           f"first refinement, resumed in {secs['c_resume']:.3f} s == "
           f"uninterrupted ({secs['c_clean']:.3f} s) bit for bit; "
           f"results.sqlite {rows} rows, versions {versions}")
    return out


def _service_phase(torch, np, dev, served=None):
    """Phase 22: the evaluation service and the worker cluster on ``dev``
    (see the module docstring).  Every comparison is byte for byte:
    served and clustered rows are content-addressed, so they equal a
    local engine's on the same device.  ``served`` is phase 17's served
    dispatch (``_served_exact``: its tenants' rows, already held against
    phase 4's, and its sqlite store); without it (a script that runs this
    phase alone) the phase makes that dispatch itself, on phase 17's
    genomes, and holds its rows against a local exact engine's."""
    import tempfile
    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.encoding import random_genomes
    from repro_torch.core.dse.engine import EvalEngine
    from repro_torch.core.dse.faults import FaultInjector
    from repro_torch.core.dse.ga import GAConfig, run_ga
    from repro_torch.core.dse.pipeline import run_pipeline
    from repro_torch.core.dse.store import (MemoryLRUStore, SqliteStore,
                                            TieredStore)
    from repro_torch.core.dse.sweep import run_sweep
    from repro_torch.core.workloads import workload_names
    from repro_torch.launch.hillclimb import dse_hillclimb
    from repro_torch.serve.cluster import DSECluster
    from repro_torch.serve.dse_service import (DSEClient, DSEService,
                                               _SeedPool)

    t_phase = time.perf_counter()
    secs = {}
    wait_s = 600.0

    def timed(key, fn):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
        secs[key] = time.perf_counter() - t0
        return out

    def exact(workloads, store=None):
        return EvalEngine(workloads, config=EngineConfig(backend="exact",
                                                         store=store),
                          device=dev)

    def same_rows(got, want, what, keys=("latency", "energy", "tops_w",
                                         "area")):
        for k in keys:
            check(np.asarray(got[k]).tobytes()
                  == np.asarray(want[k]).tobytes(), f"{what}: {k} differs")

    def same_ga(got, want, what):
        check(got is not None and want is not None, f"{what}: no result")
        check(got.best_fitness == want.best_fitness
              and got.best_genome.tobytes() == want.best_genome.tobytes()
              and got.history == want.history
              and got.evaluated == want.evaluated, f"{what}: GA differs")
        same_rows(got.best_metrics, want.best_metrics, what, _ROWS)

    services = []
    tmp = (served["dir"] if served is not None else tempfile.mkdtemp(
        prefix="service_", dir=os.path.join(ROOT, "build")))
    try:
        # ---- (a) a second service on the served dispatch's sqlite file ----
        names = workload_names()

        def service(workloads, store_path=None, **kw):
            store = (TieredStore(MemoryLRUStore(), SqliteStore(store_path))
                     if store_path else None)
            svc = DSEService(exact(workloads, store), **kw).start()
            services.append(svc)
            return svc

        if served is None:
            g = random_genomes(np.random.default_rng(0),
                               POPULATION)[:EXACT_POPULATION]
            served = timed("a_tenants", lambda: _served_exact(
                torch, np, dev, names, g, tmp))
            local = timed("a_local", lambda: exact(names).evaluate(g))
            same_rows(served["rows"], local, "(a) served tenants")
        g_in = served["tenants"]["in-process"]
        warm = service(names, served["store"])
        again = timed("a_warm", lambda: DSEClient(service=warm).evaluate(
            g_in))
        same_rows(again, {k: v[:len(g_in)] for k, v in
                          served["rows"].items()}, "(a) warm service")
        hit_rate = warm.stats.store_hits / max(warm.stats.request_genomes, 1)
        check(hit_rate > 0.5, f"(a) warm store hit rate {hit_rate:.3f}")
        warm.stop()
        warm.engine.store.close()

        # ---- (b) served search and pipeline ---------------------------------
        wl = PIPELINE_WORKLOADS
        bracket = PIPELINE_BRACKET
        sweep = timed("b_sweep", lambda: run_sweep(
            wl, samples_per_stratum=SERVICE_PIPELINE["samples_per_stratum"],
            seed=0, brackets=SERVICE_PIPELINE["brackets"], engine=exact(wl)))
        cfg = GAConfig(**SERVICE_SEARCH)
        fit = sweep.fitness(cfg.alpha)
        in_b = np.nonzero((sweep.bracket == bracket) & np.isfinite(fit))[0]
        seeds = sweep.genomes[in_b[np.argsort(-fit[in_b])][:cfg.seed_top_k]]
        e_homo = sweep.homo_baseline()[bracket]
        svc_b = service(wl)
        events = timed("b_search", lambda: list(DSEClient(
            service=svc_b).search(seeds, bracket, e_homo,
                                  cfg=SERVICE_SEARCH, seed=0)))
        check(events[-1]["event"] == "done", f"(b) search: {events[-1]}")
        res = events[-1]["result"]
        ga_local = timed("b_search_local", lambda: run_ga(
            _SeedPool(wl, seeds, bracket, e_homo), bracket, cfg, seed=0,
            engine=exact(wl)))
        check(res["best_fitness"] == ga_local.best_fitness
              and res["best_genome"] == ga_local.best_genome.tolist()
              and res["history"] == ga_local.history
              and res["evaluated"] == ga_local.evaluated
              and all(res["best_metrics"][k]
                      == np.asarray(ga_local.best_metrics[k]).tolist()
                      for k in _ROWS), "(b) served search differs")
        pipe_cfg = GAConfig(**SERVICE_PIPELINE["cfg"])
        stages = timed("b_pipeline", lambda: list(DSEClient(
            address=svc_b.listen(), timeout=wait_s).pipeline(
                **SERVICE_PIPELINE)))
        check(stages[-1]["event"] == "done", f"(b) pipeline: {stages[-1]}")
        sp = stages[-1]["result"]
        pipe_local = timed("b_pipeline_local", lambda: run_pipeline(
            wl, engine=exact(wl),
            **{**SERVICE_PIPELINE, "cfg": pipe_cfg}))
        check(sp["front"]["points"] == pipe_local.front_points.tolist()
              and sp["front"]["genomes"] == pipe_local.front_genomes.tolist()
              and sp["evaluated"] == pipe_local.evaluated,
              "(b) served pipeline's front differs")
        for b, r in pipe_local.results[0].items():
            got = sp["results"]["0"][str(b)]
            check(got["best_fitness"] == r.best_fitness
                  and got["best_genome"] == r.best_genome.tolist(),
                  f"(b) served pipeline at {b} differs")

        # ---- (d) the hillclimb through a client ------------------------------
        hill = timed("d_client", lambda: dse_hillclimb(
            wl, engine=DSEClient(service=svc_b), **SERVICE_HILLCLIMB))
        hill_local = timed("d_local", lambda: dse_hillclimb(
            wl, engine=exact(wl), **SERVICE_HILLCLIMB))
        for key in ("best_genome", "mean_energy_pj", "area_mm2",
                    "per_workload_latency_s"):
            check(hill[key] == hill_local[key], f"(d) hillclimb {key}")
        b_stats = svc_b.stats.snapshot(svc_b.max_batch)
        svc_b.stop()

        # ---- (c) the cluster under faults ------------------------------------
        def cluster(faults, tag):
            svcs = [service(wl, worker_id=f"{tag}-w{i}")
                    for i in range(CLUSTER_WORKERS)]
            inj = FaultInjector(seed=0, at=faults)
            return DSECluster(svcs, fault_injector=inj, backoff_s=0.01), inj

        # the GA of (b) through the cluster: (b)'s local run is the
        # unfaulted single-engine run
        cl, inj = cluster(CLUSTER_GA_FAULTS, "ga")
        ga_cl = timed("c_ga", lambda: run_ga(
            _SeedPool(wl, seeds, bracket, e_homo), bracket, cfg, seed=0,
            engine=cl, device=dev))
        same_ga(ga_cl, ga_local, "(c) clustered GA")
        fired = {"ga": inj.fired()}
        membership = {"ga": cl.membership()}
        cl_stats = {"ga": cl.cluster_stats.snapshot()}
        cl.close()
        cl, inj = cluster(CLUSTER_PIPELINE_FAULTS, "pipe")
        ck = os.path.join(tmp, "ck")
        pipe_cl = timed("c_pipeline", lambda: run_pipeline(
            wl, engine=exact(wl), cluster=cl, checkpoint=ck,
            **{**SERVICE_PIPELINE, "cfg": pipe_cfg}))
        fired["pipeline"] = inj.fired()
        membership["pipeline"] = cl.membership()
        cl_stats["pipeline"] = cl.cluster_stats.snapshot()
        cl.close()
        for part, faults in (("ga", CLUSTER_GA_FAULTS),
                             ("pipeline", CLUSTER_PIPELINE_FAULTS)):
            for site, at in faults.items():
                check(fired[part][site] == len(at),
                      f"(c) {part}: {site} fired {fired[part][site]} of "
                      f"{len(at)} times")
        _same_study(np, pipe_cl, pipe_local, "(c) clustered pipeline")
        replay_eng = exact(wl)
        replay = timed("c_replay", lambda: run_pipeline(
            wl, engine=replay_eng, checkpoint=ck,
            **{**SERVICE_PIPELINE, "cfg": pipe_cfg}))
        check(replay_eng.stats.dispatches == 0,
              "(c) the local replay of the clustered checkpoint dispatched")
        _same_study(np, replay, pipe_local, "(c) local replay")
    finally:
        for svc in services:
            svc.stop(drain=False)
            svc.engine.store.close()
        shutil.rmtree(tmp, ignore_errors=True)
    secs["phase"] = time.perf_counter() - t_phase

    st = served["stats"]
    out = {"secs": secs, "a_service": st,
           "a_separate_dispatches": served["separate"],
           "a_warm_hit_rate": hit_rate,
           "b_service": b_stats, "c_fired": fired, "c_membership": membership,
           "c_cluster_stats": cl_stats,
           "b_search_best_fitness": res["best_fitness"],
           "b_pipeline_front": len(sp["front"]["points"]),
           "d_mean_energy_pj": hill["mean_energy_pj"]}
    _phase(22, "service", f"{secs['phase']:.3f} s on {dev}. (a) "
           + (f"the served dispatch ({len(names)} workloads, tenants of "
              f"{[len(x) for x in served['tenants'].values()]} genomes) "
              f"{secs['a_tenants']:.3f} s, byte for byte a local exact "
              f"engine ({secs['a_local']:.3f} s); "
              if "a_tenants" in secs else "phase 17's served dispatch: ")
           + f"{st['engine_dispatches']} coalesced dispatches vs "
           f"{served['separate']} separate, {st['inflight_merged']} "
           f"in-flight merges; a second service on its sqlite file: hit "
           f"rate {hit_rate:.3f}, byte for byte ({secs['a_warm']:.3f} s). "
           f"(b) on {wl}: sweep {secs['b_sweep']:.3f} s; served search "
           f"{SERVICE_SEARCH['population']} x {SERVICE_SEARCH['generations']}"
           f" {secs['b_search']:.3f} s == local run_ga "
           f"{secs['b_search_local']:.3f} s (best {res['best_fitness']:+.6f})"
           f"; served pipeline {secs['b_pipeline']:.3f} s == local "
           f"{secs['b_pipeline_local']:.3f} s (front "
           f"{len(sp['front']['points'])}). (c) {CLUSTER_WORKERS}-worker "
           f"cluster: (b)'s GA {secs['c_ga']:.3f} s == (b)'s local run "
           f"under {CLUSTER_GA_FAULTS}; "
           f"run_pipeline(cluster=, checkpoint=) {secs['c_pipeline']:.3f} s "
           f"== unfaulted under {CLUSTER_PIPELINE_FAULTS}; every planted "
           f"fault fired; local replay of its checkpoint "
           f"{secs['c_replay']:.3f} s, no dispatch; membership "
           + json.dumps({p: [m["status"] for m in v]
                         for p, v in membership.items()})
           + f", retried shards {cl_stats['ga']['retried_shards']} + "
           f"{cl_stats['pipeline']['retried_shards']}. (d) dse_hillclimb "
           f"through a DSEClient {secs['d_client']:.3f} s == local "
           f"{secs['d_local']:.3f} s (mean energy "
           f"{hill['mean_energy_pj']:.6e} pJ)")
    return out


def _max_err(got, want, tol):
    """Max abs error of ``got`` against ``want`` (as float32); fails if
    any element is off by more than ``tol * (1 + |want|)``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    check(not bool(bad.any()), f"{int(bad.sum())} of {bad.numel()} elements "
          f"outside rtol/atol {tol} (max abs err {float(err.max()):.4g})")
    return float(err.max())


def _lm_kernel_phase(torch, dev):
    """Phase 9: flash_attention and ssm_scan at the first prefill wave's
    shapes against their plain versions, timed beside their bounds and,
    for flash, beside scaled_dot_product_attention."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import tuning
    from repro_torch.models.registry import get_config

    cfg = get_config(LM_ARCH)
    B, S, L = SERVE_BATCH, max(PROMPT_LENS), 64
    H, D = cfg.n_heads, cfg.head_dim
    Hs, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = torch.Generator(device=dev).manual_seed(9)
    bf16 = torch.bfloat16
    q, k, v = (torch.randn((B, H, S, D), generator=g, device=dev).to(bf16)
               for _ in range(3))
    x = torch.randn((B, S, Hs, P), generator=g, device=dev).to(bf16)
    dt = 0.01 + 0.19 * torch.rand((B, S, Hs), generator=g, device=dev)
    a_log = torch.log(torch.arange(1, Hs + 1, dtype=torch.float32,
                                   device=dev))
    b, c = (torch.randn((B, S, N), generator=g, device=dev).to(bf16)
            for _ in range(2))
    flash = (lambda: kops.flash_attention(q, k, v, causal=True),
             lambda: kref.flash_attention_ref(q, k, v, causal=True))
    # phase 15's attention (starcoder2-15b at batch 4 x 2,048)
    tcfg = get_config(TRAIN_ATTN_ARCH)
    Bt, Ht, St, Dt = TRAIN_ATTN_BATCH, tcfg.n_heads, TRAIN_SEQ, tcfg.head_dim
    qt, kt, vt = (torch.randn((Bt, Ht, St, Dt), generator=g,
                              device=dev).to(bf16) for _ in range(3))
    flash_train = (lambda: kops.flash_attention(qt, kt, vt, causal=True),
                   lambda: kref.flash_attention_ref(qt, kt, vt, causal=True))
    # the non-causal forms of phases 24 and 25 (their own generator, so
    # that the inputs above stay those of earlier runs): llama-3.2-
    # vision's cross-attention of a 512-token prompt over its 1,601 vision
    # tokens, and seamless-m4t's encoder over 960 frames
    gn = torch.Generator(device=dev).manual_seed(91)
    noncausal = {}
    for tag, arch, rows in (("cross", VISION_ARCH, CTX_PROMPT),
                            ("encoder", AUDIO_ARCH, None)):
        ncfg = get_config(arch)
        T = ncfg.num_frontend_tokens
        shapes = ((CTX_BATCH, ncfg.n_heads, rows or T, ncfg.head_dim),) \
            + ((CTX_BATCH, ncfg.n_heads, T, ncfg.head_dim),) * 2
        noncausal[tag] = [torch.randn(sh, generator=gn, device=dev).to(bf16)
                          for sh in shapes]
    ssm = (lambda: kops.ssm_scan(x, dt, a_log, b, c, chunk=L),
           lambda: kref.ssm_scan_ref(x, dt, a_log, b, c, chunk=L))
    # phase 14's scan (mamba2-780m at batch 8 x 2,048)
    scfg = get_config(TRAIN_SSM_ARCH)
    Bm, Sm, Lm = TRAIN_SSM_BATCH, TRAIN_SEQ, tuning.KNOBS.ssd_chunk
    Hm, Pm, Nm = scfg.ssm_heads, scfg.ssm_head_dim, scfg.ssm_state
    xm = torch.randn((Bm, Sm, Hm, Pm), generator=g, device=dev).to(bf16)
    dtm = 0.01 + 0.19 * torch.rand((Bm, Sm, Hm), generator=g, device=dev)
    a_logm = torch.log(torch.arange(1, Hm + 1, dtype=torch.float32,
                                    device=dev))
    bm, cm = (torch.randn((Bm, Sm, Nm), generator=g, device=dev).to(bf16)
              for _ in range(2))
    ssm_train = (lambda: kops.ssm_scan(xm, dtm, a_logm, bm, cm, chunk=Lm),
                 lambda: kref.ssm_scan_ref(xm, dtm, a_logm, bm, cm, chunk=Lm))
    # the float32 CUDA-core scan at the same shape in chunks of 128 (two
    # tiles a chunk), the reference entry point's default
    xf, bf, cf = (t.float() for t in (xm, bm, cm))
    ssm_f32 = (lambda: kops.ssm_scan(xf, dtm, a_logm, bf, cf,
                                     chunk=F32_CHUNK),
               lambda: kref.ssm_scan_ref(xf, dtm, a_logm, bf, cf,
                                         chunk=F32_CHUNK))

    def ssm_case(run, x, b, L, H, shape, tol=SSM_TOL, peak=PEAK_BF16_FLOPS):
        """2 L (L N + L P + 2 N P) flops per (batch, head, tile of L
        rows); x, dt, a_log, b, c read and y written once"""
        Bs, Ss, _, Ps = x.shape
        Ns = b.shape[-1]
        Lt = min(L, SCAN_TILE_ROWS)   # the rows of the kernels' sub-chunks
        return dict(
            run=run, tol=tol, peak=peak,
            ops=2 * Lt * (Lt * Ns + Lt * Ps + 2 * Ns * Ps) * Bs * H
            * (Ss // Lt),
            bytes=2 * x.numel() * x.element_size() + Bs * Ss * H * 4 + H * 4
            + 2 * b.numel() * b.element_size(),
            library=None, shape=shape)
    cases = {
        # 2 products of 2 D flops for every visible (query, key) pair;
        # q, k, v read and o written once
        "flash_attention": dict(
            run=flash, tol=LM_TOL, ops=4 * D * B * H * S * (S + 1) // 2,
            bytes=4 * q.numel() * q.element_size(),
            library=lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            shape=dict(B=B, H=H, S=S, T=S, D=D, causal=True)),
        "flash_attention@train": dict(
            run=flash_train, tol=LM_TOL,
            ops=4 * Dt * Bt * Ht * St * (St + 1) // 2,
            bytes=4 * qt.numel() * qt.element_size(),
            library=lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True),
            shape=dict(B=Bt, H=Ht, S=St, T=St, D=Dt, causal=True)),
        **{f"flash_attention@{tag}": dict(
            run=(lambda t=t: kops.flash_attention(*t, causal=False),
                 lambda t=t: kref.flash_attention_ref(*t, causal=False)),
            tol=LM_TOL,
            # 2 products of 2 D flops for every (query, key) pair, all
            # visible; q, k, v read and o written once
            ops=4 * t[0].numel() * t[1].shape[2],
            bytes=(2 * t[0].numel() + 2 * t[1].numel())
            * t[0].element_size(),
            library=lambda t=t: F.scaled_dot_product_attention(
                *t, is_causal=False),
            shape=dict(B=t[0].shape[0], H=t[0].shape[1], S=t[0].shape[2],
                       T=t[1].shape[2], D=t[0].shape[3], causal=False))
           for tag, t in noncausal.items()},
        "ssm_scan": ssm_case(ssm, x, b, L, Hs,
                             dict(B=B, S=S, H=Hs, P=P, N=N, chunk=L)),
        "ssm_scan@train": ssm_case(ssm_train, xm, bm, Lm, Hm,
                                   dict(B=Bm, S=Sm, H=Hm, P=Pm, N=Nm,
                                        chunk=Lm)),
        "ssm_scan@float32": ssm_case(ssm_f32, xf, bf, F32_CHUNK, Hm,
                                     dict(B=Bm, S=Sm, H=Hm, P=Pm, N=Nm,
                                          chunk=F32_CHUNK, dtype="float32"),
                                     tol=F32_SSM_TOL, peak=PEAK_FP32_FLOPS)}
    out = {}
    for name, cs in cases.items():
        kernel, plain = cs["run"]
        err = _max_err(kernel(), plain(), cs["tol"])
        peak = cs.get("peak", PEAK_BF16_FLOPS)
        ops_ms = cs["ops"] / peak * 1e3
        bytes_ms = cs["bytes"] / PEAK_HBM_BYTES_PER_S * 1e3
        r = out[name] = {
            "max_abs_err": err, "ms": _time_ms(torch, kernel, 20),
            "plain_ms": _time_ms(torch, plain, 5),
            "library_ms": None if cs["library"] is None
            else _time_ms(torch, cs["library"], 20),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops": cs["ops"], "bytes": cs["bytes"], "shape": cs["shape"]}
        lib = "none (no single PyTorch call computes it)" \
            if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (scaled_dot_product_attention)"
        gc.collect()
        torch.cuda.empty_cache()
        dtype = cs["shape"].get("dtype", "bf16")
        _phase(9, "lm kernels", f"{name} at {cs['shape']}, {dtype}: max abs "
               f"err {err:.4g} (limit {cs['tol']} rel + abs); kernel "
               f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
               f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {cs['ops']:.4g} "
               f"flops at {peak:.3g}/s, {cs['bytes']:.4g} B at "
               f"{PEAK_HBM_BYTES_PER_S:.3g} B/s, H100 SXM data sheet); "
               f"library {lib}")
    return out


def _serve_phase(torch, np, dev, n, cfg, expected, profile=False):
    """Phases 10 and 23, the LM serving path: ServeEngine on ``cfg`` serving
    8 requests in admission waves, once cold and once measured (the same
    requests, the same tokens).  ``expected(waves)`` gives each kernel's
    launches in the measured run."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import Request, ServeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = sum(p.numel() * p.element_size()
                     for p in model.parameters()) / 1e9
    rng = np.random.default_rng(0)
    lens = rng.choice(PROMPT_LENS, SERVE_REQUESTS)
    news = rng.choice(NEW_TOKENS, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]

    def serve():
        """One ServeEngine run over the 8 requests; returns the results,
        the (shape, seconds) of every prefill and decode step and the
        wall seconds.  Each step is timed between two synchronisations,
        and its logits must be finite."""
        eng = ServeEngine(cfg, model, max_batch=SERVE_BATCH,
                          max_len=SERVE_MAX_LEN)
        for rid, (prompt, new) in enumerate(zip(prompts, news)):
            eng.submit(Request(rid=rid, prompt=prompt,
                               max_new_tokens=int(new)))
        timed = {"prefill": [], "decode": []}

        def timer(kind, step):
            def run(*a):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, caches = step(*a)
                check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
                      f"non-finite {kind} logits")
                torch.cuda.synchronize()
                timed[kind].append((tuple(a[1].shape),
                                    time.perf_counter() - t))
                return logits, caches
            return run

        eng.prefill = timer("prefill", eng.prefill)
        eng.decode = timer("decode", eng.decode)
        t = time.perf_counter()
        with torch.no_grad():
            results = eng.run()
        return results, timed, time.perf_counter() - t

    cold_results, _, cold_wall = serve()     # first use of every kernel
    kops.reset_launch_counts()               # just before the main path
    results, timed, wall = serve()
    launches = dict(kops.launch_counts)      # read just after
    check(results == cold_results, "the warm run generated other tokens")
    waves = len(timed["prefill"])
    check(waves >= 2, f"{waves} admission waves")
    for name, want in expected(waves).items():
        check(launches[name] == want, f"{name} launched {launches[name]} "
              f"times in {waves} waves, expected {want}")
    check(sorted(results) == list(range(SERVE_REQUESTS)), "lost requests")
    for rid, toks in results.items():
        check(len(toks) == int(news[rid]) and
              all(0 <= t < cfg.vocab for t in toks),
              f"request {rid}: {len(toks)} tokens, want {int(news[rid])}")
    prefill_s = sum(t for _, t in timed["prefill"])
    decode_s = sum(t for _, t in timed["decode"])
    decode_tokens = sum(len(t) for t in results.values()) - SERVE_REQUESTS
    out = {"init_s": init_s, "weights_gb": weights_gb,
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "waves": [{"shape": sh, "ms": t * 1e3}
                     for sh, t in timed["prefill"]],
           "prefill_ms": prefill_s * 1e3, "decode_steps": len(timed["decode"]),
           "decode_ms_per_step": decode_s * 1e3 / max(len(timed["decode"]), 1),
           "decode_tokens": decode_tokens,
           # a decode step reads every weight once (the one-hot MoE
           # dispatch runs all experts)
           "decode_bound_ms": weights_gb * 1e9 / PEAK_HBM_BYTES_PER_S * 1e3,
           "decode_tokens_per_s": decode_tokens / max(decode_s, 1e-9),
           "wall_s": wall, "cold_wall_s": cold_wall, "launches": launches}
    _phase(n, "serve", f"{cfg.name} full width (d_model {cfg.d_model}, "
           f"{cfg.n_layers} layers, {weights_gb:.2f} GB bf16 weights, built "
           f"in {init_s:.2f} s), ServeEngine(max_batch={SERVE_BATCH}, "
           f"max_len={SERVE_MAX_LEN}) on {dev}: {SERVE_REQUESTS} requests, "
           f"prompts {lens.tolist()}, new tokens {news.tolist()}; {waves} "
           f"waves {[w['shape'] for w in out['waves']]} prefilled in "
           f"{out['prefill_ms']:.1f} ms "
           f"({[round(w['ms'], 1) for w in out['waves']]}); "
           f"{out['decode_steps']} decode steps at "
           f"{out['decode_ms_per_step']:.2f} ms (bound "
           f"{out['decode_bound_ms']:.2f} ms: the weights at "
           f"{PEAK_HBM_BYTES_PER_S:.3g} B/s) = "
           f"{out['decode_tokens_per_s']:.1f} decode tokens/s; wall "
           f"{wall:.2f} s (the first, cold run: {cold_wall:.2f} s); max "
           f"memory allocated "
           f"{out['max_memory_allocated_gb']:.2f} GB; launches {launches}")
    out["fresh_ms"] = _prefill_routes_ms(torch, np, model, cfg, dev)
    f = out["fresh_ms"]
    _phase(f"{n}c", "prefill routes", f"{cfg.name}: a ({SERVE_BATCH}, "
           f"{max(PROMPT_LENS)}) prefill into empty caches, median of "
           f"{PREFILL_ROUTE_REPS}: {f['fresh']:.3f} ms told they are empty "
           f"(prefill_step), {f['read_back']:.3f} ms reading each "
           f"attention layer's lengths back")
    if profile:
        out["profile"] = _profile_serve_steps(torch, model, cfg, dev)
    return out


def _prefill_routes_ms(torch, np, model, cfg, dev):
    """The blocks of one (SERVE_BATCH, longest prompt) prefill into empty
    caches, timed between synchronisations, PREFILL_ROUTE_REPS times each
    way, alternating: ``fresh=True`` (``prefill_step``'s route: the
    caches are known empty) and ``fresh=False`` (each attention layer reads
    its caches' lengths back to the host to learn that).  Returns the
    medians in ms."""
    from repro_torch.models.model import _embed, _run_blocks, init_cache

    B, S = SERVE_BATCH, max(PROMPT_LENS)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)
    ms = {True: [], False: []}
    with torch.inference_mode():
        x = _embed(model, tokens)
        pos = torch.arange(S, device=dev).expand(B, S)
        for _ in range(PREFILL_ROUTE_REPS):
            for fresh in (True, False):
                caches = init_cache(cfg, B, SERVE_MAX_LEN, dev)
                torch.cuda.synchronize()
                t = time.perf_counter()
                _run_blocks(model, x, pos, None, caches, fresh=fresh)
                torch.cuda.synchronize()
                ms[fresh].append((time.perf_counter() - t) * 1e3)
                del caches
    return {"fresh": float(np.median(ms[True])),
            "read_back": float(np.median(ms[False]))}


def _layers_card_vs_cpu(torch, np, dev, cfg, rng, ctx_rows=0):
    """``cfg`` with the same weights (``torch.Generator`` seed 0) on the CPU
    and on the card.  Each card layer takes the CPU layer's input, for a
    prefill of 2 x 128 tokens and PARITY_DECODE_STEPS decode steps, and its
    output and the last-position logits must agree within LM_TOL.  With
    ``ctx_rows``, a context of that many rows from ``rng`` goes to every
    layer: a vision model's embeddings, or an encoder-decoder's frames,
    which the encoder turns into the context on the CPU, its layers and
    final norm held the same way.  Returns the largest errors over the
    layer outputs and over the logits."""
    from repro_torch.models import model as M

    cpu = torch.device("cpu")
    ref = M.Model(cfg, device=cpu, generator=torch.Generator().manual_seed(0))
    card = M.Model(cfg, device=dev, generator=None)
    card.load_state_dict(ref.state_dict())
    B, S = 2, 128
    T = S + PARITY_DECODE_STEPS
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)).astype(
        np.int32))
    worst = {"layers": 0.0, "logits": 0.0}

    def held(got, want):
        worst["layers"] = max(worst["layers"],
                              _max_err(got.cpu(), want, LM_TOL))

    ctx = None
    with torch.no_grad():
        if ctx_rows:
            ctx = torch.from_numpy(rng.normal(size=(
                B, ctx_rows, cfg.d_model)).astype(np.float32)).to(
                    M.L.DTYPE)
        if cfg.encoder_layers:
            for i, layer in enumerate(ref.encoder):
                want = layer(ctx)
                held(card.encoder[i](ctx.to(dev)), want)
                ctx = want
            want = M.L.norm(ref.enc_final_norm.scale, ctx, cfg.norm)
            held(M.L.norm(card.enc_final_norm.scale, ctx.to(dev), cfg.norm),
                 want)
            ctx = want
        card_ctx = None if ctx is None else ctx.to(dev)
        caches = {m: M.init_cache(cfg, B, T, m.device) for m in (ref, card)}
        steps = [(toks[:, :S], torch.arange(S).expand(B, S))]
        steps += [(toks[:, t:t + 1], torch.full((B, 1), t)) for t in
                  range(S, T)]
        for tk, pos in steps:
            x = M._embed(ref, tk)
            for i, layer in enumerate(ref.layers):
                want, _ = layer(x, pos, caches[ref][i], ctx)
                got, _ = card.layers[i](x.to(dev), pos.to(dev),
                                        caches[card][i], card_ctx)
                held(got, want)
                x = want
            heads = []
            for m in (ref, card):
                h = M.L.norm(m.final_norm.scale, x.to(m.device), cfg.norm)
                heads.append(M._mask_pad_logits(cfg, M.L.einsum(
                    "bsd,dv->bsv", h, m.head()))[..., -1, :cfg.vocab])
            worst["logits"] = max(worst["logits"],
                                  _max_err(heads[1].cpu(), heads[0], LM_TOL))
    return worst


def _card_vs_cpu_phase(torch, np, dev):
    """Phase 11: reduced Jamba (the repeat axis at 2) with the same weights
    on the CPU and on the card, layer by layer, for the prefill and for 4
    decode steps, within 2e-2.  (Run end to end, the two would part
    wherever a last-bit difference flips a top-2 MoE routing choice;
    tests/test_torch_lm_serve.py pins that sensitivity in the
    reference.)"""
    from repro_torch.models.registry import get_config

    cfg = dataclasses.replace(get_config(LM_ARCH).reduced(),
                              n_layers=PARITY_LAYERS)
    worst = _layers_card_vs_cpu(torch, np, dev, cfg,
                                np.random.default_rng(11))
    _phase(11, "serve card vs CPU", f"{cfg.name} ({cfg.n_layers} layers, "
           f"repeat axis {cfg.n_repeats}), same weights on cpu and {dev}, "
           f"each card layer fed the CPU layer's input: prefill of 2 x 128 "
           f"and {PARITY_DECODE_STEPS} decode steps, max abs err "
           f"{worst['layers']:.4g} over layer outputs, {worst['logits']:.4g} "
           f"over last-position logits (limit {LM_TOL} rel + abs)")
    return worst


def _sass_count(path, opcode):
    """Instructions of ``opcode`` in the SASS of a built library."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    return sum(re.search(rf"\b{opcode}\b", line) is not None
               for line in sass.splitlines())


def _ptxas_usage(log, pattern):
    """Registers and spill bytes that ``ptxas -v`` reported for each
    kernel whose mangled name matches ``pattern`` (its first group names
    the instantiation)."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            hit = re.search(pattern, m.group(1))
            name = hit.group(1) if hit else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage.setdefault(name, {}).update(
                spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage.setdefault(name, {})["registers"] = int(m[1])
    return usage


def _lm_phases(torch, np, dev, record, build_s, profile):
    """Phases 8-11, the LM serving path; returns the kernel lines of
    flash_attention and ssm_scan."""
    from repro_torch.kernels import _build, flash_attention, ssm_scan
    from repro_torch.models.registry import get_config

    t0 = time.perf_counter()
    flash_attention._library()
    flash_attention._bwd_library()
    ssm_scan._library()
    ssm_scan._bwd_library()
    load_s = time.perf_counter() - t0
    libs = ("flash_attention", "flash_attention_bwd", "ssm_scan",
            "ssm_scan_bwd")
    hgmma = {n: _sass_count(_build.library_path(n), "HGMMA") for n in libs}
    check(all(hgmma.values()), f"a tensor-core library has no HGMMA: "
          f"{hgmma}")
    regs = {}
    for n, kern in (("flash_attention", r"flash_fwd_tc_kernelILi\d+E"),
                    ("flash_attention_bwd", r"flash_bwd_tc_kernelILi\d+E"),
                    ("ssm_scan", r"chunk_\w+_kernelILi\d+ELi\d+E"),
                    ("ssm_scan_bwd", r"chunk_grads_kernelILi\d+ELi\d+E")):
        regs.update(_ptxas_usage(_build.build_log(n), rf"({kern})"))
    spills = {k: v for k, v in regs.items() if k.startswith("chunk_")
              and (v.get("spill_stores") or v.get("spill_loads"))}
    check(not spills, f"bf16 scan kernels spill: {spills}")
    record["tc_build"] = {"hgmma": hgmma, "ptxas": regs}
    _phase(8, "build", f"flash_attention built in "
           f"{build_s['flash_attention']:.3f} s, flash_attention_bwd in "
           f"{build_s['flash_attention_bwd']:.3f} s, ssm_scan in "
           f"{build_s['ssm_scan']:.3f} s, ssm_scan_bwd in "
           f"{build_s['ssm_scan_bwd']:.3f} s (with phase 2's, in parallel); "
           f"loaded in {load_s:.3f} s; HGMMA instructions {hgmma}; "
           f"ptxas -v of the tensor-core kernels {regs}")
    record["lm_kernels"] = _lm_kernel_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    check(cfg.n_repeats == 1 and cfg.d_model == 4096,
          f"{cfg.name}: n_repeats {cfg.n_repeats}, d_model {cfg.d_model}")
    n_mamba = sum(m == "mamba" for m, _ in cfg.pattern())
    # each admission wave launches flash_attention once and ssm_scan once
    # per Mamba2 layer
    record["serve"] = _serve_phase(
        torch, np, dev, 10, cfg, lambda waves: {
            "flash_attention": waves, "ssm_scan": n_mamba * waves}, profile)
    gc.collect()
    torch.cuda.empty_cache()
    record["card_vs_cpu_lm"] = _card_vs_cpu_phase(torch, np, dev)
    sites = {"flash_attention": "src/repro/kernels/flash_attention.py:73",
             "ssm_scan": "src/repro/kernels/ssm_scan.py:72"}
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/csrc/{name}.cu",
             "replaces": sites[name],
             "launches": record["serve"]["launches"][name],
             **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}
            for name, r in record["lm_kernels"].items() if name in sites]


def _grad_err(got, want, tol, what):
    """Max abs error of a gradient against the plain version's, and that
    error over the plain gradient's largest magnitude, which must be at
    most ``tol``."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    check(rel <= tol, f"{what}: error {err:.4g} is {rel:.4g} of the "
          f"largest magnitude (> {tol})")
    return err, rel


def _bound(ops, n_bytes, peak_ops):
    ops_ms = ops / peak_ops * 1e3
    bytes_ms = n_bytes / PEAK_HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def _lm_bwd_kernel_phase(torch, dev):
    """Phase 12: the two backward kernels at the training phases' shapes
    against autograd of their plain versions, timed beside the plain
    version's backward (its graph built once), their bounds and, for
    flash, the backward of scaled_dot_product_attention."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import tuning
    from repro_torch.models.registry import get_config

    g = torch.Generator(device=dev).manual_seed(12)
    bf16 = torch.bfloat16
    out = {}

    # ---- ssm_scan_bwd: mamba2-780m, batch 8 x 2,048 ----------------------
    # bf16 in the training phase's chunks, and the float32 CUDA-core
    # kernel in chunks of 128 (two tiles a chunk)
    cfg = get_config(TRAIN_SSM_ARCH)
    B, S = TRAIN_SSM_BATCH, TRAIN_SEQ
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    for name, dtype, L, tol in (
            ("ssm_scan_bwd", bf16, tuning.KNOBS.ssd_chunk, SSM_BWD_TOL),
            ("ssm_scan_bwd@float32", torch.float32, F32_CHUNK,
             F32_SSM_TOL)):
        # the float32 case draws from its own generator, so that the later
        # phases' inputs stay those of earlier runs
        gen = g if dtype == bf16 else \
            torch.Generator(device=dev).manual_seed(121)
        x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
        dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=gen, device=dev)
        a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                       device=dev))
        b, c = (torch.randn((B, S, N), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        dy = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
        ins = [t.detach().requires_grad_() for t in (x, dt, a_log, b, c)]
        y = kref.ssm_scan_ref(*ins, chunk=L)

        def kernel():
            return kops.ssm_scan_bwd(x, dt, a_log, b, c, dy, chunk=L)

        def plain():
            return torch.autograd.grad(y, ins, dy, retain_graph=True)

        errs = [_grad_err(a, w, tol, f"{name} d{n}")
                for n, a, w in zip(("x", "dt", "a_log", "b", "c"), kernel(),
                                   plain())]
        # multiply-adds per (batch, head, tile of Lt rows): the recomputed
        # state, the lower triangles of Q and A, the terms of dc, db, dx
        # and dstate
        Lt = min(L, SCAN_TILE_ROWS)
        ops = 2 * (5 * Lt * P * N + Lt * Lt * (3 * N + 2 * P) // 2) * B * H \
            * (S // Lt)
        esz = x.element_size()
        n_bytes = 3 * x.numel() * esz + 2 * dt.numel() * 4 + 2 * H * 4 \
            + 4 * b.numel() * esz
        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_FP32_FLOPS
        bound_ms, bound_by = _bound(ops, n_bytes, peak)
        out[name] = {
            "max_abs_err": max(e for e, _ in errs),
            "max_rel_err": max(r for _, r in errs), "tol": tol,
            "ms": _time_ms(torch, kernel, 5),
            "plain_ms": _time_ms(torch, plain, 3),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "ops": ops, "bytes": n_bytes, "peak": peak,
            "shape": {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": L,
                      "dtype": str(dtype).replace("torch.", "")}}
        del x, dt, b, c, dy, ins, y
        gc.collect()
        torch.cuda.empty_cache()

    # ---- flash_attention_bwd: starcoder2-15b, batch 4 x 2,048, causal;
    # seamless-m4t's training shapes, non-causal: the encoder over 960
    # frames and the decoder's cross-attention of 512 tokens over them
    # (their own generator, so that the first case's inputs stay those of
    # earlier runs) ----------------------------------------------------------
    acfg = get_config(AUDIO_ARCH)
    frames = acfg.num_frontend_tokens
    gn = torch.Generator(device=dev).manual_seed(122)
    for name, arch, B, S, T, causal, gen in (
            ("flash_attention_bwd", TRAIN_ATTN_ARCH, TRAIN_ATTN_BATCH,
             TRAIN_SEQ, TRAIN_SEQ, True, g),
            ("flash_attention_bwd@encoder", AUDIO_ARCH, ENC_TRAIN_BATCH,
             frames, frames, False, gn),
            ("flash_attention_bwd@cross", AUDIO_ARCH, ENC_TRAIN_BATCH,
             ENC_TRAIN_SEQ, frames, False, gn)):
        cfg = get_config(arch)
        H, D = cfg.n_heads, cfg.head_dim
        q, k, v, do = (torch.randn(sh, generator=gen, device=dev).to(bf16)
                       for sh in ((B, H, S, D), (B, H, T, D), (B, H, T, D),
                                  (B, H, S, D)))
        o, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        y = kref.flash_attention_ref(*ins, causal)
        lib_ins = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_y = F.scaled_dot_product_attention(*lib_ins, is_causal=causal)

        def kernel():
            return kops.flash_attention_bwd(q, k, v, o, lse, do, causal)

        def plain():
            return torch.autograd.grad(y, ins, do, retain_graph=True)

        def library():
            return torch.autograd.grad(lib_y, lib_ins, do, retain_graph=True)

        def kernel_fwd_bwd():
            t = [a.detach().requires_grad_() for a in (q, k, v)]
            return torch.autograd.grad(kops.flash_attention(
                *t, causal=causal), t, do)

        def library_fwd_bwd():
            t = [a.detach().requires_grad_() for a in (q, k, v)]
            return torch.autograd.grad(F.scaled_dot_product_attention(
                *t, is_causal=causal), t, do)

        errs = [_grad_err(a, w, FLASH_BWD_TOL, f"{name} d{n}")
                for n, a, w in zip("qkv", kernel(), plain())]
        pairs = B * H * S * (S + 1) // 2 if causal else B * H * S * T
        ops = 5 * 2 * D * pairs    # s, dP, dV, dK, dQ over the visible pairs
        # q, o, dO in and dq out; k, v in and dk, dv out
        n_bytes = 4 * (q.numel() + k.numel()) * 2 + lse.numel() * 4
        bound_ms, bound_by = _bound(ops, n_bytes, PEAK_BF16_FLOPS)
        out[name] = {
            "max_abs_err": max(e for e, _ in errs),
            "max_rel_err": max(r for _, r in errs),
            "ms": _time_ms(torch, kernel, 5),
            "plain_ms": _time_ms(torch, plain, 3),
            "library_ms": _time_ms(torch, library, 10),
            "bound_ms": bound_ms, "bound_by": bound_by, "ops": ops,
            "bytes": n_bytes, "peak": PEAK_BF16_FLOPS, "tol": FLASH_BWD_TOL,
            "fwd_bwd_ms": _time_ms(torch, kernel_fwd_bwd, 5),
            "library_fwd_bwd_ms": _time_ms(torch, library_fwd_bwd, 10),
            "shape": {"B": B, "H": H, "S": S, "T": T, "D": D,
                      "causal": causal}}
        del q, k, v, do, o, lse, ins, y, lib_ins, lib_y
        gc.collect()
        torch.cuda.empty_cache()
    for name, r in out.items():
        lib = "none (no single PyTorch call computes it)" \
            if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms (the backward of " \
            f"scaled_dot_product_attention; forward + backward: kernels " \
            f"{r['fwd_bwd_ms']:.4f} ms, library " \
            f"{r['library_fwd_bwd_ms']:.4f} ms)"
        _phase(12, "lm backward kernels", f"{name} at {r['shape']}: "
               f"max abs err {r['max_abs_err']:.4g}, at most "
               f"{r['max_rel_err']:.4g} of a gradient's largest magnitude "
               f"(limit {r['tol']}); "
               f"kernel {r['ms']:.4f} ms, plain backward "
               f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
               f"({r['bound_by']}: {r['ops']:.4g} flops at "
               f"{r['peak']:.3g}/s, {r['bytes']:.4g} B at "
               f"{PEAK_HBM_BYTES_PER_S:.3g} B/s, H100 SXM data sheet); "
               f"library {lib}")
    return out


def _horner_phase(torch, dev):
    """Phase 13: ``ops.horner`` on the KAN workload's first layer in
    float32 and bfloat16, bit for bit against the plain version.  The
    counters are zeroed just before the two calls and read just after;
    the comparison reuses their outputs."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref as kref

    g = torch.Generator(device=dev).manual_seed(13)
    cf = torch.randn((KAN_DEGREE + 1,), generator=g, device=dev)
    xs = {"float32": torch.randn((KAN_ELEMENTS,), generator=g, device=dev)}
    xs["bfloat16"] = xs["float32"].to(torch.bfloat16)
    kops.reset_launch_counts()
    ys = {k: kops.horner(x, cf) for k, x in xs.items()}
    torch.cuda.synchronize()
    launches = kops.launch_counts["horner"]
    check(launches == 2, f"horner launched {launches} times, expected 2")
    out = {"launches": launches}
    for k, x in xs.items():
        want = kref.horner_ref(x, cf)
        check(ys[k].dtype == x.dtype and torch.equal(ys[k], want),
              f"horner {k}: not bit for bit the plain version (max abs err "
              f"{float((ys[k].float() - want.float()).abs().max()):.4g})")
        n_bytes = 2 * x.numel() * x.element_size() + cf.numel() * 4
        bound_ms, bound_by = _bound(2 * KAN_DEGREE * x.numel(), n_bytes,
                                    PEAK_FP32_FLOPS)
        dev_names, dev_ms, sessions = _device_ms(
            torch, lambda: kops.horner(x, cf), 20, "horner")
        out[k] = {"max_abs_err": 0.0,
                  "ms": _time_ms(torch, lambda: kops.horner(x, cf), 20),
                  "device_ms": dev_ms, "device_ms_by_name": dev_names,
                  "profiler_sessions": sessions,
                  "plain_ms": _time_ms(torch, lambda: kref.horner_ref(x, cf),
                                       5),
                  "library_ms": None, "bound_ms": bound_ms,
                  "bound_by": bound_by, "bytes": n_bytes}
        r = out[k]
        _phase(13, "horner", f"{k}, {KAN_ELEMENTS} elements (784 x 512 x "
               f"64), degree {KAN_DEGREE}: bit for bit the plain version; "
               f"kernel {r['ms']:.4f} ms (CUDA events), "
               f"{_device_text(dev_ms, dev_names, sessions)}, "
               f"plain {r['plain_ms']:.4f} ms, "
               f"bound {r['bound_ms']:.4f} ms ({bound_by}: {n_bytes:.4g} B at "
               f"{PEAK_HBM_BYTES_PER_S:.3g} B/s, H100 SXM data sheet); "
               f"library none (no single PyTorch call computes it); "
               f"launches in the counted run {launches}")
    return out


def _data(cfg, seq, batch, seed):
    """The data pipeline ``train_loop`` makes for ``cfg``: tokens, and an
    encoder-decoder's frames or a vision model's embeddings."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline

    return SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=seed,
        frontend="audio" if cfg.encoder_layers else cfg.frontend,
        num_frontend_tokens=cfg.num_frontend_tokens, d_model=cfg.d_model))


def _train_phase(torch, np, dev, n, name, cfg, batch, seq, steps, lr,
                 expected, cut, profile=False, after=None):
    """Phases 14, 15 and 25 (c): ``train_loop`` on ``cfg`` from fresh random
    weights (seed 0) for ``steps`` steps of ``batch`` x ``seq`` tokens (and
    the frontend's input the data pipeline adds), remat, AdamW with
    float32 moments, and the loop's checkpoint of the last step (deleted
    after).  The launch counters are zeroed just before and read just
    after: each kernel of ``expected`` launches that many times per step.
    ``profile`` traces one more step after the counted run; ``after(state,
    opt, extra)`` then gets the trained state, the optimiser's config and
    the batch after the last (its record goes under ``after``)."""
    from repro_torch.checkpoint.ckpt import latest_step
    from repro_torch.kernels import ops as kops
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    from repro_torch.train.step import make_train_step

    opt = AdamWConfig(lr=lr)
    ckpt_dir = os.path.join(ROOT, "build", f"chip_smoke_ckpt_{n}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    stamps, losses = [], []

    def on_step(step, metrics):   # the loss was read: the step has ended
        stamps.append(time.perf_counter())
        losses.append(metrics["loss"])

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()                  # just before the main path
    t0 = time.perf_counter()
    out = train_loop(cfg, TrainLoopConfig(
        steps=steps, ckpt_every=steps, ckpt_dir=ckpt_dir, global_batch=batch,
        seq_len=seq, resume=False), opt, on_step=on_step, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kops.launch_counts)         # read just after
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = out.pop("state")
    model = state["params"]
    check(model.device.type == DEVICE, f"trained on {model.device}")
    n_params = sum(p.numel() for p in model.parameters())
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(latest_step(ckpt_dir) == steps, "no checkpoint of the last step")
    r = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
         "params": n_params, "batch": batch, "seq": seq,
         "steps": steps, "losses": losses,
         "ckpt_gb": sum(os.path.getsize(os.path.join(dp, f))
                        for dp, _, fs in os.walk(ckpt_dir) for f in fs) / 1e9,
         "ckpt_save_s": out["ckpt_save_s"], "ckpt_wait_s": out["ckpt_wait_s"]}
    ckpt = (f"checkpoint of {r['ckpt_gb']:.2f} GB: "
            f"{r['ckpt_save_s']:.2f} s in save_async (snapshot to host), "
            f"{r['ckpt_wait_s']:.2f} s waiting for the write")
    del out
    for kernel, per_step in expected.items():
        check(launches[kernel] == per_step * steps,
              f"{kernel} launched {launches[kernel]} times, expected "
              f"{per_step} x {steps}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    ms = sum(step_ms) / len(step_ms)
    r.update({"first_step_ms": (stamps[0] - t0) * 1e3, "step_ms": step_ms,
              "ms_per_step": ms,
              "tokens_per_s": batch * seq / ms * 1e3,
              "max_memory_allocated_gb": peak_gb, "wall_s": wall,
              "launches": launches})
    _phase(n, name, f"train_loop on {cfg.name} (d_model {cfg.d_model}, "
           f"{cfg.n_layers} layers{cut}, {n_params / 1e9:.3f}e9 parameters) "
           f"on {dev}: {steps} steps of {batch} x {seq} tokens, remat, "
           f"AdamW(float32 moments, lr {lr} x warmup_cosine); "
           f"losses {[round(x, 4) for x in losses]}; steps 2-{steps} at "
           f"{ms:.1f} ms ({[round(x, 1) for x in step_ms]}) = "
           f"{r['tokens_per_s']:.0f} tokens/s (step 1, with the model's "
           f"init: {r['first_step_ms']:.0f} ms); max memory allocated "
           f"{peak_gb:.2f} GB; {ckpt}; wall {wall:.1f} s; launches "
           f"{launches}")
    if profile:
        step_fn = make_train_step(cfg, opt)
        extra = {k: torch.from_numpy(v).to(dev) for k, v in
                 _data(cfg, seq, batch, 0).batch(steps).items()}

        def run():   # reading the loss synchronises
            nonlocal state
            state, metrics = step_fn(state, extra)
            float(metrics["loss"])

        r["profile"] = _trace(torch, run)
        _phase(f"{n}b", "profile", json.dumps(r["profile"]))
    if after is not None:
        extra = {k: torch.from_numpy(v).to(dev) for k, v in
                 _data(cfg, seq, batch, 0).batch(steps).items()}
        r["after"] = after(state, opt, extra)
    del state, model
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _reshard_full_width(torch, np, cfg, state, opt, extra):
    """Phase 15 (c): the trained full-width state through
    ``ElasticMesh.reshard_state`` onto the (1, 1) mesh of an NCCL group of
    one rank (destroyed after): every parameter and moment comes back a
    plain tensor on the card, bit for bit, and one more step from it
    gives a finite loss through the flash kernels."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import (AXIS_MAP_SINGLE,
                                                  resolve_specs)
    from repro_torch.kernels import ops as K
    from repro_torch.models.model import param_specs
    from repro_torch.train.fault import ElasticMesh
    from repro_torch.train.step import make_train_step

    old_p = dict(state["params"].named_parameters())
    old_mu = state["opt"]["mu"]
    try:
        em = ElasticMesh()
        mesh = em.mesh()
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda",
              f"ElasticMesh().mesh(): {mesh}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = em.reshard_state(state, mesh, resolve_specs(
            param_specs(cfg), AXIS_MAP_SINGLE))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    def same(a, b, what):
        if isinstance(b, dict):
            for k in b:
                same(a[k], b[k], f"{what}.{k}")
            return 0
        check(type(a) in (torch.Tensor, torch.nn.Parameter)
              and a.device.type == "cuda" and a is not b
              and a.dtype == b.dtype and torch.equal(a, b),
              f"reshard_state: {what} not bit for bit on the card")
        return a.numel() * a.element_size()

    n_bytes = sum(same(p, old_p[n], n)
                  for n, p in new["params"].named_parameters())
    n_bytes += sum(same(v, old_mu[n][k], f"{n}.{k}")
                   for n, m in new["opt"]["mu"].items()
                   for k, v in m.items())
    check(int(new["step"]) == int(state["step"]), "reshard_state: step")
    del old_p, old_mu
    K.reset_launch_counts()
    _, metrics = make_train_step(cfg, opt)(new, extra)
    loss = float(metrics["loss"])
    launches = dict(K.launch_counts)
    check(np.isfinite(loss) and launches["flash_attention_bwd"] > 0,
          f"the step after reshard_state: loss {loss}, launches {launches}")
    out = {"secs": secs, "gb": n_bytes / 1e9, "next_loss": loss,
           "launches": launches}
    _phase("15c", "reshard", f"the trained state ({n_bytes / 1e9:.2f} GB: "
           f"parameters and float32 moments) through "
           f"ElasticMesh.reshard_state onto the (1, 1) mesh in {secs:.2f} s "
           f"(gathered to the host, re-placed): bit for bit, plain tensors "
           f"on the card; the next step's loss {loss:.4f}; launches "
           f"{launches}")
    return out


def _grads_off(got, want, float32=False):
    """Per leaf, each element of ``got`` within GRAD_RTOL of itself plus
    GRAD_ATOL of the leaf's largest magnitude in ``want`` (F32_TOL and
    F32_TOL in ``float32``; in bf16 the leaves in FLOAT32_ONLY are
    skipped); the leaves in ZERO_GRAD within 2^-20 of the largest gradient
    of any leaf, on both sides.  Returns the leaves off (a line each) and
    the largest share of its leaf's largest magnitude that an element's
    error, less its relative part, takes (what the absolute tolerance must
    cover)."""
    rtol, atol = (F32_TOL, F32_TOL) if float32 else (GRAD_RTOL, GRAD_ATOL)
    gmax = max(float(w.float().abs().max()) for w in want.values())
    need, off = 0.0, []
    for name, w in want.items():
        g, w = got[name].float().cpu(), w.float().cpu()
        if name.endswith(ZERO_GRAD):
            big = max(float(g.abs().max()), float(w.abs().max()))
            if big > 2.0 ** -20 * gmax:
                off.append(f"{name} {big:.4g} where the gradient is zero "
                           f"(largest gradient {gmax:.4g})")
            continue
        if not float32 and name.endswith(FLOAT32_ONLY):
            continue
        lmax = float(w.abs().max())
        d = (g - w).abs()
        bad = d > rtol * w.abs() + atol * lmax
        if bool(bad.any()):
            off.append(f"{name} {int(bad.sum())} of {bad.numel()} elements "
                       f"(max abs err {float(d.max()):.4g}, the leaf's "
                       f"largest {lmax:.4g})")
        elif lmax > 0:
            need = max(need, float(((d - rtol * w.abs()) / lmax).max()))
    return off, need


def _float32_only_spread(per_dtype):
    """The largest distance of a FLOAT32_ONLY leaf's bf16 gradient from its
    float32 one, over the leaf's largest magnitude (a reading)."""
    g16, g32 = per_dtype["bfloat16"], per_dtype["float32"]
    return max((float((g16[n].float() - g32[n]).abs().max())
                / max(float(g32[n].abs().max()), 1e-30)
                for n in g32 if n.endswith(FLOAT32_ONLY)), default=0.0)


def _block_grads(torch, block, x, cot, pos, ctx=None):
    """The gradients of ``block``'s output against ``cot`` for its
    parameters and its input ``x`` ("input"), on the CPU; ``ctx`` is the
    context of a cross-attention layer."""
    dtype = next(block.parameters()).dtype
    dev = next(block.parameters()).device
    x = x.to(dev, dtype).requires_grad_()
    if ctx is not None:
        ctx = ctx.to(dev, dtype)
    names, ps = zip(*block.named_parameters())
    gs = torch.autograd.grad(block(x, pos.to(dev), None, ctx)[0],
                             (x,) + ps, cot.to(dev, dtype),
                             allow_unused=True)
    return {n: (torch.zeros_like(p) if g is None else g).cpu()
            for n, p, g in zip(("input",) + names, (x,) + ps, gs)}


def _train_card_vs_cpu_phase(torch, np, dev, phase=16,
                             archs=TRAIN_PARITY_ARCHS):
    """Phases 16 and 25 (b): one training step's loss and gradients
    (``make_grads_fn``, remat) of the reduced ``archs`` with the same
    weights on the CPU and the card, in bf16 and with the models made
    float32; the batch carries the frames or vision embeddings that the
    data pipeline gives the config.  Jamba's and llama-3.2-vision's
    gradients are compared layer by layer (each card block fed the CPU
    block's input, the context and one random output gradient): Jamba's
    top-2 routing turns on the last bit of bf16 router logits (phase 11),
    and five bf16 layers carry a last-bit difference past 2e-2 of
    llama-3.2-vision's logits (tests/test_torch_lm_context.py).  Planted
    faults must be rejected: the loss of the card's bf16 model with its
    first layer's matrices rounded through float8 e4m3, and with its last
    layer dropped; the gradients of the card's models with a zeroed dq
    (the attention's) or db (mamba2's SSD scan)."""
    import copy

    from repro_torch.kernels import ops as kops
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config
    from repro_torch.train.step import make_grads_fn

    cpu = torch.device("cpu")
    out = {}

    def loss_off(dtype, got, want):
        return abs(got - want) > LOSS_RTOL[dtype] * abs(want)

    for arch in archs:
        cfg = get_config(arch).reduced()
        bf16 = M.Model(cfg, device=cpu,
                       generator=torch.Generator().manual_seed(16))
        models = {"bfloat16": bf16, "float32": copy.deepcopy(bf16).float()}
        batch = _data(cfg, 128, 2, 16).batch(0)
        grads_of = make_grads_fn(cfg, remat=True)

        def on(d, m):
            return grads_of(m, {k: torch.from_numpy(v).to(d)
                                for k, v in batch.items()})

        def card_copy(m):
            c = M.Model(cfg, device=dev, generator=None)
            if m.embed.dtype == torch.float32:
                c.float()
            with torch.no_grad():
                c.load_state_dict(m.state_dict())
            return c

        r, runs = {}, {}
        for dtype, m in models.items():
            (lc, gc_), (lg, gg) = on(cpu, m), on(dev, card_copy(m))
            lc, lg = float(lc), float(lg)
            check(not loss_off(dtype, lg, lc), f"{arch} {dtype}: loss {lg} "
                  f"on the card, {lc} on the CPU")
            r[dtype] = {"loss_cpu": lc, "loss_card": lg,
                        "loss_rel_err": abs(lg - lc) / abs(lc)}
            runs[dtype] = (gc_, gg)
        spread = _float32_only_spread({t: g[0] for t, g in runs.items()})
        if arch.startswith(LAYER_BY_LAYER):
            rng = np.random.default_rng(16)
            B, S = batch["tokens"].shape
            pos = torch.arange(S).expand(B, S)
            ctx = batch.get("vision_embeds")
            if ctx is not None:
                ctx = torch.from_numpy(ctx)
            need = {"bfloat16": 0.0, "float32": 0.0}
            with torch.no_grad():
                x = M._embed(bf16, torch.from_numpy(batch["tokens"]))
            cards = {t: card_copy(m) for t, m in models.items()}
            for i in range(len(bf16.layers)):
                cot = torch.from_numpy(rng.normal(size=x.shape).astype(
                    np.float32))
                per = {t: [_block_grads(torch, mm.layers[i], x, cot, pos,
                                        ctx)
                           for mm in (m, cards[t])]
                       for t, m in models.items()}
                for t, (want, got) in per.items():
                    off, n = _grads_off(got, want, float32=t == "float32")
                    check(not off, f"{arch} {t} layer {i}: gradients off: "
                          + "; ".join(off))
                    need[t] = max(need[t], n)
                spread = max(spread, _float32_only_spread(
                    {t: g[0] for t, g in per.items()}))
                with torch.no_grad():
                    x = bf16.layers[i](x, pos, None, None if ctx is None
                                       else ctx.to(x.dtype))[0]
            del cards
        else:
            need = {}
            for t, (gc_, gg) in runs.items():
                off, need[t] = _grads_off(gg, gc_, float32=t == "float32")
                check(not off, f"{arch} {t}: gradients off: "
                      + "; ".join(off))
        for t in need:
            r[t]["grad_atol_needed"] = need[t]
        r["d_skip_bf16_from_float32_cpu"] = spread
        # planted faults: the loss of a faulty bf16 forward on the card
        lc = r["bfloat16"]["loss_cpu"]
        for fault in ("fp8_first_layer", "drop_last_layer"):
            m = card_copy(bf16)
            with torch.no_grad():
                if fault == "fp8_first_layer":
                    # the first layer the input meets: an encoder-
                    # decoder's first encoder layer
                    first = (m.encoder or m.layers)[0]
                    for p in first.parameters():
                        if p.dim() >= 2:
                            p.copy_(p.to(torch.float8_e4m3fn).to(p.dtype))
                else:
                    del m.layers[-1]
            lf = float(on(dev, m)[0])
            check(loss_off("bfloat16", lf, lc), f"{arch}: the loss limit "
                  f"passes a planted fault ({fault}: {lf} against {lc})")
            r[f"loss_rel_err_{fault}"] = abs(lf - lc) / abs(lc)
        # planted faults: a zeroed dq or db on the card
        # (a model held layer by layer has no whole-model gradients to
        # hold a fault against)
        fault = ("db", "ssm_scan", 3) if arch == "mamba2-780m" \
            else None if arch.startswith(LAYER_BY_LAYER) \
            else ("dq", "flash_attention", 0)
        if fault:
            name, fn, arg = fault
            real = getattr(kops, fn)

            def faulty(*args, **kw):
                args = list(args)
                args[arg] = args[arg].detach()
                return real(*args, **kw)

            setattr(kops, fn, faulty)
            try:
                for t, m in models.items():
                    off, _ = _grads_off(on(dev, card_copy(m))[1],
                                        runs[t][0], float32=t == "float32")
                    check(bool(off), f"{arch} {t}: the gradient check "
                          f"passes a zeroed {name}")
                    r[t][f"zeroed_{name}_leaves_off"] = off
            finally:
                setattr(kops, fn, real)
        out[arch] = r
        del bf16, models, runs
    _phase(phase, "train card vs CPU", "; ".join(
        f"{a} (reduced"
        f"{', layer by layer' if a.startswith(LAYER_BY_LAYER) else ''})"
        f": loss rel err bf16 {r['bfloat16']['loss_rel_err']:.3g}, float32 "
        f"{r['float32']['loss_rel_err']:.3g} (planted: first layer in fp8 "
        f"{r['loss_rel_err_fp8_first_layer']:.3g}, last layer dropped "
        f"{r['loss_rel_err_drop_last_layer']:.3g}); gradients need atol "
        f"{r['bfloat16']['grad_atol_needed']:.3g} (bf16), "
        f"{r['float32']['grad_atol_needed']:.3g} (float32); d_skip's bf16 "
        f"gradient {r['d_skip_bf16_from_float32_cpu']:.3g} of its largest "
        f"from the float32 one on the CPU"
        + "".join(f"; zeroed {k.split('_')[1]} rejected in {t} ({len(v)} "
                  f"leaves off: {', '.join(x.split()[0] for x in v)})"
                  for t in ("bfloat16", "float32")
                  for k, v in r[t].items() if k.startswith("zeroed_"))
        for a, r in out.items()) + f" (limits: loss {LOSS_RTOL} rel; "
        f"gradients per leaf {GRAD_RTOL} rel + {GRAD_ATOL} of the leaf's "
        f"largest in bf16, {F32_TOL} + {F32_TOL} in float32, d_skip in "
        f"float32 only)")
    return out


def _train_phases(torch, np, dev, record, profile):
    """Phases 12-16, the LM training path and horner; returns the kernel
    lines of flash_attention_bwd, ssm_scan_bwd and horner."""
    import dataclasses as dc

    from repro_torch.models.registry import get_config

    record["lm_bwd_kernels"] = _lm_bwd_kernel_phase(torch, dev)
    record["horner"] = _horner_phase(torch, dev)
    ssm_cfg = get_config(TRAIN_SSM_ARCH)
    check(ssm_cfg.n_layers == 48 and ssm_cfg.d_model == 1536,
          f"{ssm_cfg.name}: {ssm_cfg.n_layers} layers, d_model "
          f"{ssm_cfg.d_model}")
    # the mixer's forward launches twice per layer and step (the forward
    # and its rematerialisation in the backward), its backward once
    n_mamba = ssm_cfg.n_layers
    record["train"] = _train_phase(
        torch, np, dev, 14, "train", ssm_cfg, TRAIN_SSM_BATCH, TRAIN_SEQ,
        TRAIN_SSM_STEPS, TRAIN_SSM_LR,
        {"ssm_scan": 2 * n_mamba, "ssm_scan_bwd": n_mamba}, "",
        profile=profile)
    attn_cfg = dc.replace(get_config(TRAIN_ATTN_ARCH),
                          n_layers=TRAIN_ATTN_LAYERS)
    check(attn_cfg.d_model == 6144 and attn_cfg.d_ff == 24576,
          f"{attn_cfg.name}: d_model {attn_cfg.d_model}")
    n_attn = attn_cfg.n_layers
    record["train_attention"] = _train_phase(
        torch, np, dev, 15, "train attention", attn_cfg, TRAIN_ATTN_BATCH,
        TRAIN_SEQ, TRAIN_ATTN_STEPS, TRAIN_ATTN_LR,
        {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn},
        f", cut from {get_config(TRAIN_ATTN_ARCH).n_layers}",
        profile=profile,
        after=lambda state, opt, extra: _reshard_full_width(
            torch, np, attn_cfg, state, opt, extra))
    record["train_card_vs_cpu"] = _train_card_vs_cpu_phase(torch, np, dev)
    bwd = record["lm_bwd_kernels"]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/layers.py:140",
         "launches": record["train_attention"]["launches"][
             "flash_attention_bwd"],
         **{k: bwd["flash_attention_bwd"][k] for k in keys}},
        {"name": "ssm_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/ssm_scan_bwd.cu",
         "replaces": "src/repro/models/layers.py:417",
         "launches": record["train"]["launches"]["ssm_scan_bwd"],
         **{k: bwd["ssm_scan_bwd"][k] for k in keys}},
        {"name": "horner", "route": "cuda",
         "source": "src/repro_torch/csrc/horner.cu",
         "replaces": "src/repro/kernels/horner.py:37",
         "launches": record["horner"]["launches"],
         **{k: record["horner"]["float32"][k] for k in keys}}]


def _context_serve_phase(torch, np, dev):
    """Phase 24: llama-3.2-vision and seamless-m4t whole, served through the
    steps of ``serve/step.py`` with a context (the reference's engine
    passes none): (4, 512) prompts, one prefill and CTX_DECODE_STEPS greedy
    decode steps, the vision embeddings (4, 1601, 4096) or the encoder's
    output over (4, 960, 1024) frames as ``ctx``; once cold, once
    measured, the same tokens.  In the measured run the counters are
    zeroed just before and read after each part: ``encode`` launches
    flash_attention once per encoder layer, the prefill once per layer
    and once more per ``xattn``, a decode step never."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.model import Model, _layer_kinds, encode
    from repro_torch.models.registry import get_config
    from repro_torch.serve.step import (greedy_sample, make_decode_step,
                                        make_prefill_step)

    out = {}
    for arch in (VISION_ARCH, AUDIO_ARCH):
        cfg = get_config(arch)
        kinds = [m for m, _ in _layer_kinds(cfg)]
        n_xattn = kinds.count("attn") if cfg.encoder_layers else 0
        want = {"encode": cfg.encoder_layers,
                "prefill": len(kinds) + n_xattn, "decode": 0}
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights_gb = sum(p.numel() * p.element_size()
                         for p in model.parameters()) / 1e9
        rng = np.random.default_rng(24)
        T = cfg.num_frontend_tokens
        front = torch.from_numpy(rng.normal(size=(
            CTX_BATCH, T, cfg.d_model)).astype(np.float32)).to(dev)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
            CTX_BATCH, CTX_PROMPT)).astype(np.int32)).to(dev)
        prefill = make_prefill_step(cfg, SERVE_MAX_LEN)
        decode = make_decode_step(cfg)

        def timed(fn, *a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a)
            torch.cuda.synchronize()
            return r, (time.perf_counter() - t) * 1e3

        def finite(logits, what):
            check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
                  f"{cfg.name}: non-finite {what} logits")

        def serve():
            """encode (for the encoder-decoder), prefill, greedy decode;
            returns the tokens, the ms of each part and the launches after
            each."""
            ms, seen = {}, {}
            kops.reset_launch_counts()
            with torch.inference_mode():
                ctx = front
                if cfg.encoder_layers:
                    ctx, ms["encode"] = timed(encode, model,
                                              front.to(torch.bfloat16))
                seen["encode"] = dict(kops.launch_counts)
                (logits, caches), ms["prefill"] = timed(prefill, model, toks,
                                                        ctx)
                seen["prefill"] = dict(kops.launch_counts)
                finite(logits, "prefill")
                nxt = greedy_sample(logits)
                gen = [nxt]
                torch.cuda.synchronize()
                t = time.perf_counter()
                for step in range(CTX_DECODE_STEPS):
                    pos = torch.full((CTX_BATCH,), CTX_PROMPT + step,
                                     dtype=torch.int32, device=dev)
                    logits, caches = decode(model, nxt[:, None], pos,
                                            caches, ctx)
                    finite(logits, "decode")
                    nxt = greedy_sample(logits)
                    gen.append(nxt)
                torch.cuda.synchronize()
                ms["decode_per_step"] = (time.perf_counter() - t) * 1e3 \
                    / CTX_DECODE_STEPS
                seen["decode"] = dict(kops.launch_counts)
            return torch.stack(gen, 1).cpu(), ms, seen

        cold, _, _ = serve()                 # first use of these shapes
        tokens, ms, seen = serve()
        check(torch.equal(tokens, cold), f"{cfg.name}: the warm run "
              f"generated other tokens")
        check(bool(((tokens >= 0) & (tokens < cfg.vocab)).all()),
              f"{cfg.name}: tokens outside the vocabulary")
        got = {"encode": seen["encode"]["flash_attention"],
               "prefill": seen["prefill"]["flash_attention"]
               - seen["encode"]["flash_attention"],
               "decode": seen["decode"]["flash_attention"]
               - seen["prefill"]["flash_attention"]}
        check(got == want, f"{cfg.name}: flash_attention launched {got}, "
              f"expected {want}")
        launches = seen["decode"]
        r = out[arch] = {
            "n_layers": cfg.n_layers, "encoder_layers": cfg.encoder_layers,
            "d_model": cfg.d_model, "weights_gb": weights_gb,
            "init_s": init_s, "ctx_rows": T, "ms": ms,
            "flash_launches_by_part": got, "launches": launches,
            # a decode step reads every weight once
            "decode_bound_ms": weights_gb * 1e9 / PEAK_HBM_BYTES_PER_S * 1e3,
            "max_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9}
        enc = f"encode of {T} frames {ms['encode']:.2f} ms, " \
            if cfg.encoder_layers else ""
        _phase(24, "serve with context", f"{cfg.name} full width and depth "
               f"({cfg.n_layers} layers"
               + (f" + {cfg.encoder_layers} encoder layers"
                  if cfg.encoder_layers else
                  f", {kinds.count('cross_attn')} cross-attention") +
               f", d_model {cfg.d_model}, {weights_gb:.2f} GB bf16 weights, "
               f"built in {init_s:.2f} s) on {dev}, context of {T} rows: "
               f"{enc}prefill of {CTX_BATCH} x {CTX_PROMPT} "
               f"{ms['prefill']:.2f} ms, {CTX_DECODE_STEPS} greedy decode "
               f"steps at "
               f"{ms['decode_per_step']:.2f} ms (bound "
               f"{r['decode_bound_ms']:.2f} ms: the weights at "
               f"{PEAK_HBM_BYTES_PER_S:.3g} B/s); the same tokens cold and "
               f"warm; flash_attention launches {got} (expected); max "
               f"memory allocated {r['max_memory_allocated_gb']:.2f} GB")
        del model, front, toks
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _context_phases(torch, np, dev, record):
    """Phases 23-25, the configs that need MLA, a context or the encoder;
    returns the kernel lines of the flash kernels' non-causal forms."""
    from repro_torch.models.registry import get_config

    mla = get_config(MLA_ARCH)
    check(mla.mla and mla.n_layers == 27 and mla.first_k_dense == 1
          and (mla.n_experts, mla.top_k, mla.n_shared_experts) == (64, 6, 2),
          f"{mla.name}: not the published deepseek-v2-lite")
    gc.collect()
    torch.cuda.empty_cache()
    # MLA's products are einsums, and no layer scans: no kernel launches
    record["serve_mla"] = _serve_phase(
        torch, np, dev, 23, mla,
        lambda waves: {"flash_attention": 0, "ssm_scan": 0})
    gc.collect()
    torch.cuda.empty_cache()
    record["serve_context"] = _context_serve_phase(torch, np, dev)

    # ---- 25 (a): the reduced configs, card against CPU, layer by layer ---
    rng = np.random.default_rng(25)
    worst = record["context_card_vs_cpu"] = {
        arch: _layers_card_vs_cpu(torch, np, dev, get_config(arch).reduced(),
                                  rng, rows)
        for arch, rows in ((MLA_ARCH, 0), (VISION_ARCH, CTX_PARITY_ROWS),
                           (AUDIO_ARCH, CTX_PARITY_ROWS))}
    _phase("25a", "context card vs CPU", "; ".join(
        f"{a} (reduced, {get_config(a).reduced().n_layers} layers"
        f"{', context of %d rows' % CTX_PARITY_ROWS if a != MLA_ARCH else ''}"
        f"): max abs err {w['layers']:.4g} over layer outputs, "
        f"{w['logits']:.4g} over last-position logits" for a, w in
        worst.items()) + f"; same weights on cpu and {dev}, each card layer "
        f"fed the CPU layer's input (the encoder's too) and context, prefill "
        f"of 2 x 128 and {PARITY_DECODE_STEPS} decode steps (limit {LM_TOL} "
        f"rel + abs)")
    # ---- 25 (b): one training step's loss and gradients ------------------
    record["context_train_card_vs_cpu"] = _train_card_vs_cpu_phase(
        torch, np, dev, "25b", (AUDIO_ARCH, VISION_ARCH))
    # ---- 25 (c): seamless-m4t whole, trained -----------------------------
    enc = get_config(AUDIO_ARCH)
    check(enc.encoder_layers == 12 and enc.n_layers == 12
          and enc.d_model == 1024, f"{enc.name}: not seamless-m4t-medium")
    # per step: the encoder once (not rematerialised, as in the
    # reference), each decoder layer's self-attention and xattn twice
    # (the forward and its rematerialisation); each backward once
    dec = enc.n_layers * 2
    record["train_encoder"] = _train_phase(
        torch, np, dev, "25c", "train encoder-decoder", enc,
        ENC_TRAIN_BATCH, ENC_TRAIN_SEQ, ENC_TRAIN_STEPS, ENC_TRAIN_LR,
        {"flash_attention": enc.encoder_layers + 2 * dec,
         "flash_attention_bwd": enc.encoder_layers + dec},
        f" + {enc.encoder_layers} encoder layers over "
        f"{enc.num_frontend_tokens} frames")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    served = record["serve_context"]
    fwd, bwd = record["lm_kernels"], record["lm_bwd_kernels"]
    lines = [
        {"name": f"flash_attention@{tag}", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:73",
         "launches": served[arch]["launches"]["flash_attention"],
         **{k: fwd[f"flash_attention@{tag}"][k] for k in keys}}
        for tag, arch in (("cross", VISION_ARCH), ("encoder", AUDIO_ARCH))]
    lines += [
        {"name": f"flash_attention_bwd@{tag}", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/layers.py:140",
         "launches": record["train_encoder"]["launches"][
             "flash_attention_bwd"],
         **{k: bwd[f"flash_attention_bwd@{tag}"][k] for k in keys}}
        for tag in ("encoder", "cross")]
    return lines


def _shard_phase(torch, np, dev, record):
    """Phase 26: the sharding layer's one-device meaning on the card."""
    import torch.distributed as dist

    from repro_torch.core.dse.api import EngineConfig
    from repro_torch.core.dse.encoding import random_genomes
    from repro_torch.core.dse.engine import EvalEngine
    from repro_torch.distributed.overlap import ring_allgather_matmul
    from repro_torch.distributed.sharding import (AXIS_MAP_SINGLE,
                                                  resolve_specs)
    from repro_torch.kernels import ops as K
    from repro_torch.launch.mesh import (candidate_sharding,
                                         default_islands,
                                         make_mesh_for_devices)
    from repro_torch.models.model import Model, param_specs
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.fault import ElasticMesh
    from repro_torch.train.step import init_train_state, make_train_step

    out = {}
    t0 = time.perf_counter()
    try:
        # ---- (a) the (1, 1) mesh and the ring matmul ----------------------
        mesh = make_mesh_for_devices(1)
        check(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
              and dist.get_backend() == "nccl"
              and tuple(mesh.mesh_dim_names) == ("data", "model"),
              f"make_mesh_for_devices(1): {mesh} on {dist.get_backend()}")
        S, D, F = RING_SHAPE
        gen = torch.Generator().manual_seed(26)
        x = torch.randn(S, D, generator=gen).to(dev)
        w = torch.randn(D, F, generator=gen).to(dev)
        y = ring_allgather_matmul(x, w, mesh.get_group("model"))
        ref = torch.matmul(x, w)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max() / ref.abs().max())
        check(tuple(y.shape) == (S, F) and err <= 1e-6,
              f"ring_allgather_matmul: shape {tuple(y.shape)}, rel err "
              f"{err:.3g}")
        out["ring"] = {"shape": [S, D, F], "max_rel_err": err,
                       "ms": _time_ms(torch, lambda: ring_allgather_matmul(
                           x, w, mesh.get_group("model")), 10),
                       "matmul_ms": _time_ms(torch, lambda: torch.matmul(
                           x, w), 10)}
        del x, w, y, ref
        # ---- (b) the sharded engine on one device --------------------------
        g = random_genomes(np.random.default_rng(26), SHARD_POPULATION)
        check(candidate_sharding() is None
              and default_islands(SHARD_POPULATION) == 1,
              "one card: candidate_sharding must be None and "
              "default_islands 1")
        out["engines"] = {}
        for backend in ("batched", "exact"):
            secs = {}
            rows = {}
            for shard in (True, False):
                eng = EvalEngine(SHARD_WORKLOADS, config=EngineConfig(
                    backend=backend, shard=shard), device=dev)
                check(eng._devices is None, "one card: no device split")
                t1 = time.perf_counter()
                rows[shard] = eng.evaluate(g)
                secs[shard] = time.perf_counter() - t1
            for k in ("latency", "energy", "tops_w", "area"):
                check(np.array_equal(rows[True][k], rows[False][k]),
                      f"{backend}: shard=True {k} differs from shard=False")
            out["engines"][backend] = {"shard_s": secs[True],
                                       "unsharded_s": secs[False]}
        # ---- (c) a resumed run through reshard_state -----------------------
        cfg = get_config(ELASTIC_ARCH).reduced()
        pipe = _data(cfg, ELASTIC_SEQ, ELASTIC_BATCH, 0)
        opt_cfg = AdamWConfig(lr=3e-3)
        specs = resolve_specs(param_specs(cfg), AXIS_MAP_SINGLE)

        def run(reshard_at):
            model = Model(cfg, device=dev, generator=torch.Generator(
                device=dev).manual_seed(0))
            state = init_train_state(cfg, model, opt_cfg)
            step = make_train_step(cfg, opt_cfg)
            losses = []
            for i in range(ELASTIC_STEPS):
                if i == reshard_at:
                    em = ElasticMesh()
                    state = em.reshard_state(state, em.mesh(), specs)
                    check(all(type(p) is torch.nn.Parameter
                              and p.device.type == "cuda"
                              for p in state["params"].parameters()),
                          "reshard_state: parameters not plain on the card")
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in pipe.batch(i).items()}
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            return losses

        K.reset_launch_counts()
        clean = run(None)
        resumed = run(ELASTIC_AT)
        launches = dict(K.launch_counts)
        rel = abs(resumed[-1] - clean[-1]) / abs(clean[-1])
        check(np.isfinite(clean[-1]) and rel <= ELASTIC_RTOL,
              f"resumed loss {resumed[-1]!r} vs {clean[-1]!r}: rel {rel:.3g}")
        check(launches["flash_attention"] > 0
              and launches["flash_attention_bwd"] > 0,
              f"the training steps ran no flash kernel: {launches}")
        out["elastic"] = {"clean": clean, "resumed": resumed,
                          "final_rel": rel, "launches": launches}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    out["phase_s"] = time.perf_counter() - t0
    e = out["engines"]
    _phase(26, "sharding", f"{out['phase_s']:.3f} s on {dev}. (a) (1, 1) "
           f"mesh over an NCCL group of one rank; ring_allgather_matmul "
           f"{S}x{D} @ {D}x{F} float32 max rel err {err:.3g} against "
           f"torch.matmul ({out['ring']['ms']:.4f} ms against "
           f"{out['ring']['matmul_ms']:.4f} ms, events); (b) shard=True on "
           f"{SHARD_POPULATION} genomes x {SHARD_WORKLOADS} bit for bit "
           f"shard=False (default_islands({SHARD_POPULATION}) == 1): "
           + ", ".join(f"{b} {v['shard_s']:.3f} s / {v['unsharded_s']:.3f} s"
                       for b, v in e.items())
           + f"; (c) reduced {ELASTIC_ARCH} {ELASTIC_STEPS} steps of "
           f"{ELASTIC_BATCH} x {ELASTIC_SEQ}, reshard_state at step "
           f"{ELASTIC_AT}: last loss {out['elastic']['resumed'][-1]:.7g} "
           f"against {out['elastic']['clean'][-1]:.7g} uninterrupted (rel "
           f"{rel:.3g}, limit {ELASTIC_RTOL}); launches {launches}")
    record["sharding"] = out


def _dryrun_phase(record):
    """Phase 27: one production cell of the dry-run on the fake (16, 16)
    mesh (host work) and the mesh search's top three."""
    from repro_torch.core.tpu_dse import search_mesh
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import analyze
    from repro_torch.models.registry import get_config

    arch, shape = DRYRUN_CELL
    t0 = time.perf_counter()
    rec = run_cell(arch, shape)
    secs = time.perf_counter() - t0
    check("error" not in rec, f"dry-run {arch} {shape}: {rec.get('error')}"
          f"\n{rec.get('traceback', '')}")
    a = analyze(rec)
    check(rec["flops_per_device"] > 0 and a["collective_s"] > 0,
          f"dry-run {arch} {shape}: no flops or no collectives")
    ranked = search_mesh(get_config(arch), chips=256, global_batch=256,
                         seq_len=4096)
    top = [{"dp": c.knobs.dp, "tp": c.knobs.tp,
            "microbatches": c.knobs.microbatches, "remat": c.knobs.remat,
            "step_s": c.step_s, "hbm_gib": c.hbm_gib, "fits": c.fits}
           for c in ranked[:3]]
    check(top and top[0]["fits"], "search_mesh: the best mesh does not fit")
    coll = rec["collectives"]
    record["dryrun"] = {"cell": rec, "analysis": {
        k: a[k] for k in ("compute_s", "memory_s", "collective_s",
                          "dominant", "useful_ratio", "roofline_frac")},
        "wall_s": secs, "search_mesh_top3": top}
    _phase(27, "dry-run", f"{arch} {shape} on the fake {rec['mesh']} mesh "
           f"({rec['n_devices']} ranks), traced in {secs:.3f} s on the "
           f"host: {rec['flops_per_device']:.6g} flops, "
           f"{rec['bytes_per_device']:.6g} bytes a device; collectives "
           + ", ".join(f"{k} {v['count']} x, {v['bytes']:.6g} B"
                       for k, v in sorted(coll.items()))
           + f"; peak {rec['memory']['peak_bytes'] / 2**30:.3f} GiB a "
           f"device; at the H100's data-sheet rates compute "
           f"{a['compute_s'] * 1e3:.3f} ms, memory {a['memory_s'] * 1e3:.3f}"
           f" ms, collective {a['collective_s'] * 1e3:.3f} ms "
           f"({a['dominant']}). search_mesh top 3: " + "; ".join(
               f"dp {c['dp']} tp {c['tp']} mb {c['microbatches']} remat "
               f"{c['remat']} {c['step_s'] * 1e3:.3f} ms {c['hbm_gib']:.2f} "
               f"GiB" for c in top))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    ap.add_argument("--profile", action="store_true",
                    help="also trace, with torch.profiler, one DSE engine "
                         "micro-batch of each exact backend (resnet50_int8, "
                         "512 genomes), one "
                         "(4, 512) prefill wave, one decode step and one "
                         "step of each training phase: device busy share "
                         "and the kernels that take the time")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "GPU", file=sys.stderr)
        return 2

    import numpy as np

    from repro_torch.kernels import _build

    t_start = _T0[0] = time.perf_counter()
    dev = torch.device(DEVICE)
    record = {}

    # ---- 1. card -----------------------------------------------------------
    card = _card_line()
    print(card, flush=True)
    record["card"] = card
    kind = torch.cuda.get_device_name(0)
    _phase(1, "card", f"{card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")

    # ---- 2. build: every kernel, one nvcc each, all started together -------
    build_s = _build.build_all()
    record["build_s"] = build_s
    _phase(2, "build", f"dse_eval built in {build_s['dse_eval']:.3f} s "
           f"(all {len(build_s)} kernels in parallel: "
           f"{max(build_s.values()):.3f} s; {' '.join(_build.NVCC_FLAGS)})")

    dse_kernel = _dse_phases(torch, np, dev, args, record)
    gc.collect()
    torch.cuda.empty_cache()
    kernels = [dse_kernel] + _lm_phases(torch, np, dev, record, build_s,
                                        args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += _train_phases(torch, np, dev, record, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    kernels += _context_phases(torch, np, dev, record)
    gc.collect()
    torch.cuda.empty_cache()
    _shard_phase(torch, np, dev, record)
    _dryrun_phase(record)

    record["total_s"] = time.perf_counter() - t_start
    record["phase_end_s"] = dict(_ELAPSED)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1, default=float)
    print(f"total {record['total_s']:.1f} s; each phase's last line at "
          + ", ".join(f"{k} {v:.1f}" for k, v in _ELAPSED.items()) + " s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
