"""PyTorch port on the card: the hand-written CUDA kernels (``dse_eval``,
``flash_attention`` and its backward, ``ssm_scan`` and its backward,
``horner``) against their plain versions, the MLA and cross-attention
layers and the encoder on the card against the CPU, refused launches, the
batched
engine and the plan-table executor on ``cuda`` against the CPU, the
python-mapper engine bit for bit the batched backend on ``cuda``, the
device search's memo, genetics step, device configs and Eq. 8 on
``cuda`` bit for bit the CPU, and the evaluation service and the worker
cluster over ``cuda`` engines bit for bit a local ``cuda`` engine, and
the sharding layer on one card (a (1, 1) NCCL mesh with the ring matmul,
the sharded engine bit for bit the unsharded one).  Every test
here needs an NVIDIA GPU (and nvcc); elsewhere each one skips with its
reason.  Torch only, no JAX, so the
file runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dse.api import EngineConfig
from repro_torch.core.dse.encoding import random_genomes
from repro_torch.core.dse.engine import EvalEngine
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as P


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(rng, B, T, N):
    tiles = rng.uniform(0.5, 2.0, size=(B, T, P.TILE_FIELDS)).astype(
        np.float32)
    tiles[..., 0] = (rng.random((B, T)) > 0.3)
    tiles[..., 1] = rng.integers(0, 4096, (B, T))
    tiles[..., 2] = 128.0
    tiles[..., 3] = 1e9
    tiles[..., 9] = 4e9
    ops = np.stack([
        rng.integers(0, 3, N), rng.integers(0, 10**6, N),
        rng.integers(1, 10**5, N), rng.integers(1, 10**6, N),
        np.ones(N), 2.0 ** rng.integers(0, 3, N), np.full(N, 512.0)],
        axis=1).astype(np.float32)
    return tiles, ops


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,N", [(8, 8, 128), (16, 24, 256),
                                   (13, 24, 1000)])
def test_cuda_kernel_matches_plain_version(cuda, B, T, N):
    tiles, ops = _inputs(np.random.default_rng(B), B, T, N)
    tt, ot = torch.from_numpy(tiles).to(cuda), torch.from_numpy(ops).to(cuda)
    before = K.launch_counts["dse_eval"]
    got = K.dse_eval(tt, ot)
    torch.cuda.synchronize()
    assert K.launch_counts["dse_eval"] == before + 1
    ref = P.dse_eval_ref(tt, ot).cpu().numpy()
    out = got.cpu().numpy()
    fin = np.isfinite(ref[..., 0])
    np.testing.assert_allclose(out[..., 0][fin], ref[..., 0][fin], rtol=1e-5)
    np.testing.assert_allclose(out[..., 1], ref[..., 1], rtol=1e-4, atol=1.0)
    assert (np.isfinite(out[..., 0]) == fin).all()


def _mixed_inputs(rng, B, T, N):
    """Every class, tiles without MACs, lanes or SFU parallelism, random
    clocks and bandwidths, and sfu kinds outside {1, 2, 4} (the kernel's
    general case)."""
    tiles = rng.uniform(0.5, 2.0, size=(B, T, P.TILE_FIELDS)).astype(
        np.float32)
    tiles[..., 0] = rng.random((B, T)) > 0.3
    tiles[..., 1] = rng.integers(0, 4096, (B, T)) * (rng.random((B, T)) > 0.2)
    tiles[..., 2] = rng.choice([0.0, 16.0, 128.0], (B, T))
    tiles[..., 3] = rng.uniform(0.5e9, 2e9, (B, T))
    tiles[..., 5] = rng.integers(0, 64, (B, T))
    tiles[..., 6] = rng.choice([0.0, 1.0, 4.0, 16.0], (B, T))
    tiles[..., 7] = rng.random((B, T)) > 0.3
    tiles[..., 9] = rng.uniform(1e9, 8e9, (B, T))
    ops = np.stack([
        rng.integers(0, 3, N), rng.integers(0, 10**6, N),
        rng.integers(1, 10**5, N), rng.integers(1, 10**6, N),
        rng.integers(1, 4096, N),
        rng.choice([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 8.0], N),
        rng.choice([0.0, 512.0, 1000.0], N)], axis=1).astype(np.float32)
    return tiles, ops


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 7, 31, 608])
@pytest.mark.parametrize("T", [1, 24, 64])
def test_cuda_dse_eval_seconds_bitwise(cuda, N, T):
    """The kernel's seconds and energy equal the plain version's bit for
    bit (the same IEEE operations in the same order, nothing contracted),
    ops of every class mixed and sfu kinds outside {1, 2, 4}."""
    B = 300
    tiles, ops = _mixed_inputs(np.random.default_rng(N * 100 + T), B, T, N)
    tt, ot = torch.from_numpy(tiles).to(cuda), torch.from_numpy(ops).to(cuda)
    got = K.dse_eval(tt, ot)
    want = P.dse_eval_ref(tt, ot)
    torch.cuda.synchronize()
    assert torch.equal(got[..., 0], want[..., 0])
    assert torch.isfinite(want[..., 0]).any()
    assert torch.equal(got[..., 1], want[..., 1])


@pytest.mark.gpu
def test_cuda_kernel_no_hostable_tile(cuda):
    tiles = np.zeros((2, 4, P.TILE_FIELDS), np.float32)
    tiles[..., 3] = 1e9
    tiles[..., 8] = [1.5, 2.0, 3.0, 4.0]
    tiles[1, :, 0] = 1.0
    ops = np.array([[0, 1000, 10, 100, 1, 1, 0],
                    [1, 0, 50, 100, 1, 1, 0]], np.float32)
    got = K.dse_eval(torch.from_numpy(tiles).to(cuda),
                     torch.from_numpy(ops).to(cuda)).cpu().numpy()
    assert np.isinf(got[..., 0]).all()
    np.testing.assert_allclose(got[..., 1],
                               np.broadcast_to(ops[:, 1] * 1.5
                                               + ops[:, 2] * 0.5, (2, 2)),
                               rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_engine_on_card_matches_cpu(cuda, mode):
    g = random_genomes(np.random.default_rng(5), 32)
    wl = ["kan", "resnet50_int8"]
    cfg = EngineConfig(backend="batched", mode=mode)
    on_card = EvalEngine(wl, config=cfg).evaluate(g)
    on_cpu = EvalEngine(wl, config=cfg, device="cpu").evaluate(g)
    for k in ("latency", "energy", "tops_w"):
        a, b = on_card[k], on_cpu[k]
        fin = np.isfinite(b)
        assert np.array_equal(fin, np.isfinite(a)), k
        err = np.abs(a[fin] - b[fin]) / np.maximum(np.abs(b[fin]), 1e-300)
        assert err.max(initial=0.0) <= 1e-9, (k, err.max())


def _plan_tables(wname, genomes, mode="latency"):
    from repro_torch.core.compiler.pipeline import compile_to_table
    from repro_torch.core.dse.encoding import decode
    from repro_torch.core.workloads import build
    chips = [decode(g, f"x{i}") for i, g in enumerate(genomes)]
    return chips, [compile_to_table(build(wname), c, mode=mode)
                   for c in chips]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_cuda_simulate_plans_matches_cpu(cuda, mode):
    """Host-compiled plan tables (two workloads of one bucket, mixed in one
    batch) executed on the card within rel 1e-9 of the CPU."""
    from repro_torch.core.simulator.batched import simulate_plans
    g = random_genomes(np.random.default_rng(2026), 16)
    chips, tabs = _plan_tables("kan", g[:8], mode)
    chips2, tabs2 = _plan_tables("snn_vgg9", g[8:], mode)
    chips, tabs = chips + chips2, tabs + tabs2
    on_card = simulate_plans(chips, tabs, device=cuda)
    on_cpu = simulate_plans(chips, tabs, device="cpu")
    assert on_card["mode"] == on_cpu["mode"] == mode
    for k, b in on_cpu.items():
        if k == "mode":
            continue
        a = np.asarray(on_card[k], np.float64)
        b = np.asarray(b, np.float64)
        err = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        assert err.max(initial=0.0) <= 1e-9, (k, err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_cuda_python_mapper_engine_is_the_batched_backend(cuda, mode):
    g = random_genomes(np.random.default_rng(2), 16)
    wl = ["kan", "resnet50_int8"]
    py = EvalEngine(wl, config=EngineConfig(
        backend="batched", exact_mapper="python", mode=mode)).evaluate(g)
    bt = EvalEngine(wl, config=EngineConfig(backend="batched",
                                            mode=mode)).evaluate(g)
    for k in ("latency", "energy", "tops_w", "area"):
        assert np.array_equal(py[k], bt[k]), k


@pytest.mark.gpu
def test_cuda_plan_split_on_a_row_that_cannot_split_raises(cuda):
    from repro_torch.core.simulator.batched import (batch_simulate,
                                                    stack_chip_configs,
                                                    stack_plan_tables)
    g = random_genomes(np.random.default_rng(2026), 2)
    chips, tabs = _plan_tables("resnet50_int8", g)
    plans = stack_plan_tables(tabs)
    dsp = int(np.flatnonzero((plans["op_cls"][0] == 1)
                             & (plans["valid"][0] > 0)
                             & (plans["fused"][0] == 0))[0])
    plans["n_split"][1, dsp] = 2
    plans["split_axis"][1, dsp] = 0
    plans["split_mask"][1, dsp, :2] = 1
    with pytest.raises(ValueError, match="Eq. 3"):
        batch_simulate(plans, stack_chip_configs(chips), device=cuda)


def _bf16_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


# S = T = 200 at every head dim: ragged 64-row tiles, and each of the bf16
# kernels' swizzles (32, 64, 128 B; two 128 B atoms at D 128)
_RAGGED = [(2, 3, 200, d) for d in (16, 32, 64, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 3, 256, 64),
                                   (4, 32, 512, 128), (1, 2, 100, 16),
                                   (2, 4, 192, 32)] + _RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain_version(cuda, shape, dtype,
                                                    causal):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = K.launch_counts["flash_attention"]
    got = K.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert K.launch_counts["flash_attention"] == before + 1
    want = P.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **_bf16_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("S,T", [(128, 256), (256, 128), (70, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_cross_lengths(cuda, S, T, dtype):
    """T > S offsets the causal diagonal; T < S leaves rows that see no
    key, which average every key as the reference does.  float32 runs on
    the CUDA cores (2e-5), bfloat16 on the tensor cores (2e-2)."""
    g = torch.Generator(device=cuda).manual_seed(S + T)
    q = torch.randn((1, 2, S, 64), generator=g, device=cuda).to(dtype)
    k = torch.randn((1, 2, T, 64), generator=g, device=cuda).to(dtype)
    v = torch.randn((1, 2, T, 64), generator=g, device=cuda).to(dtype)
    torch.testing.assert_close(K.flash_attention(q, k, v).float(),
                               P.flash_attention_ref(q, k, v).float(),
                               **_bf16_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 8), (2, 128, 3, 32, 16),
                                   (1, 256, 4, 64, 32), (4, 512, 128, 64, 16),
                                   (1, 128, 2, 64, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssm_scan_matches_plain_version(cuda, shape, dtype):
    B, S, H, Pd, N = shape
    g = torch.Generator(device=cuda).manual_seed(S + H)
    x = torch.randn((B, S, H, Pd), generator=g, device=cuda).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=g, device=cuda)
    al = 2 * torch.rand((H,), generator=g, device=cuda) - 1
    b = torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
    c = torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
    before = K.launch_counts["ssm_scan"]
    got = K.ssm_scan(x, dt, al, b, c, chunk=64)
    torch.cuda.synchronize()
    assert K.launch_counts["ssm_scan"] == before + 1
    want = P.ssm_scan_ref(x, dt, al, b, c, chunk=min(64, S))
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)



def _rel_max(got, want):
    """Max abs error over the largest magnitude of ``want``."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 2, 128, 128, 64), (2, 3, 70, 70, 32),
                                   (1, 2, 64, 130, 16), (1, 2, 130, 64, 16),
                                   (1, 4, 256, 256, 128)]
                         + [(b, h, s, s, d) for b, h, s, d in _RAGGED])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_bwd_matches_plain_version(cuda, shape, dtype,
                                                        causal):
    """The backward kernel (through the autograd entry point) against
    autograd of the plain version: within 1e-5 of each gradient's largest
    magnitude in float32, 2e-2 in bfloat16 (the plain version rounds its
    bf16 scores and probabilities, the tensor-core kernel P and dS).
    T < S leaves rows that see no key (uniform weights, no gradient to q,
    k)."""
    B, H, S, T, D = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    q = torch.randn((B, H, S, D), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((B, H, T, D), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((B, H, S, D), generator=g, device=cuda).to(dtype)
    before = dict(K.launch_counts)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    out = K.flash_attention(*qkv, causal=causal)
    got = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert K.launch_counts["flash_attention"] == before["flash_attention"] + 1
    assert K.launch_counts["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(P.flash_attention_ref(*ref, causal), ref, do)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    for name, a, w in zip("qkv", got, want):
        assert a.dtype == dtype
        assert _rel_max(a, w) <= tol, (name, _rel_max(a, w))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 8, 32), (2, 128, 3, 32, 16, 64),
                                   (1, 256, 4, 64, 128, 64),
                                   (2, 512, 8, 64, 16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssm_scan_bwd_matches_plain_version(cuda, shape, dtype):
    """The backward kernel (through the autograd entry point) against
    autograd of the plain version: within 1e-4 of each gradient's largest
    magnitude in float32 (tests/test_kernels.py's forward tolerance),
    5e-2 in bfloat16."""
    B, S, H, Pd, N, L = shape
    g = torch.Generator(device=cuda).manual_seed(S + H + N)
    x = torch.randn((B, S, H, Pd), generator=g, device=cuda).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=g, device=cuda)
    al = 2 * torch.rand((H,), generator=g, device=cuda) - 1
    b, c = (torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    dy = torch.randn((B, S, H, Pd), generator=g, device=cuda).to(dtype)
    before = dict(K.launch_counts)
    ins = [t.clone().requires_grad_() for t in (x, dt, al, b, c)]
    got = torch.autograd.grad(K.ssm_scan(*ins, chunk=L), ins, dy)
    torch.cuda.synchronize()
    assert K.launch_counts["ssm_scan"] == before["ssm_scan"] + 1
    assert K.launch_counts["ssm_scan_bwd"] == before["ssm_scan_bwd"] + 1
    ref = [t.clone().requires_grad_() for t in (x, dt, al, b, c)]
    want = torch.autograd.grad(P.ssm_scan_ref(*ref, chunk=L), ref, dy)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, w in zip(("x", "dt", "a_log", "b", "c"), got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert _rel_max(a, w) <= tol, (name, _rel_max(a, w))


# (B, S, H, P, N, chunk): a chunk that is not a multiple of 16 (one 64-row
# tile with 16 rows masked; the last tile's rows past S read as zeros),
# chunks of 128 rows (two tiles a chunk), of 96 (64 + 32) and of 256 (four
# tiles), at N 16 and N 128 and at each P of the bf16 kernels
_CHUNKS = [(1, 48, 2, 64, 16, 48), (1, 48, 2, 64, 128, 48),
           (2, 144, 3, 32, 16, 48), (2, 256, 3, 64, 16, 128),
           (1, 256, 2, 16, 128, 128), (1, 192, 2, 64, 32, 96),
           (1, 256, 2, 64, 128, 256)]


def _ssm_inputs(cuda, shape, dtype):
    B, S, H, Pd, N, _ = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn((B, S, H, Pd), generator=g, device=cuda).to(dtype)
    dt = 0.01 + 0.19 * torch.rand((B, S, H), generator=g, device=cuda)
    al = 2 * torch.rand((H,), generator=g, device=cuda) - 1
    b, c = (torch.randn((B, S, N), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    dy = torch.randn((B, S, H, Pd), generator=g, device=cuda).to(dtype)
    return x, dt, al, b, c, dy


@pytest.mark.gpu
@pytest.mark.parametrize("shape", _CHUNKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssm_scan_chunk_lengths(cuda, shape, dtype):
    """Chunk lengths other than 64: the forward within the limits of
    test_cuda_ssm_scan_matches_plain_version, the gradients within those
    of test_cuda_ssm_scan_bwd_matches_plain_version.  Both dtypes walk a
    chunk in tiles of at most 64 rows, so chunks of 128 and 256 rows run
    at N 128 in float32 too."""
    L = shape[-1]
    x, dt, al, b, c, dy = _ssm_inputs(cuda, shape, dtype)
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    before = dict(K.launch_counts)
    got = K.ssm_scan(x, dt, al, b, c, chunk=L)
    want = P.ssm_scan_ref(x, dt, al, b, c, chunk=L)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    ins = [t.clone().requires_grad_() for t in (x, dt, al, b, c)]
    grads = torch.autograd.grad(K.ssm_scan(*ins, chunk=L), ins, dy)
    torch.cuda.synchronize()
    assert K.launch_counts["ssm_scan"] == before["ssm_scan"] + 2
    assert K.launch_counts["ssm_scan_bwd"] == before["ssm_scan_bwd"] + 1
    ref = [t.clone().requires_grad_() for t in (x, dt, al, b, c)]
    wants = torch.autograd.grad(P.ssm_scan_ref(*ref, chunk=L), ref, dy)
    for name, a, w in zip(("x", "dt", "a_log", "b", "c"), grads, wants):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert _rel_max(a, w) <= tol, (name, _rel_max(a, w))


@pytest.mark.gpu
def test_cuda_ssm_scan_bf16_any_p_and_n(cuda):
    """Head dims and state widths the tensor-core kernels do not
    instantiate (P 24, 80, 128 at N 160) run in bfloat16 as groups of at
    most 64 columns and 128 states (``kernels/ssm_scan.py::split_scan``):
    the forward and the gradients within 5e-2 of the plain version's.  The
    launchers count their launches, and the counts rise by one per group
    (``tc_launches``), so every group ran on the tensor-core kernels and
    nothing fell back to the plain version.  (These shapes raised
    ValueError before the kernels ran them.)"""
    from repro_torch.kernels.ssm_scan import tc_launches

    for Pd in (24, 80, 128):
        shape = (1, 128, 2, Pd, 160, 64)
        x, dt, al, b, c, dy = _ssm_inputs(cuda, shape, torch.bfloat16)
        n = tc_launches(Pd, 160)
        assert n == 2 * -(-Pd // 64)
        before = dict(K.launch_counts)
        got = K.ssm_scan(x, dt, al, b, c, chunk=64)
        want = P.ssm_scan_ref(x, dt, al, b, c, chunk=64)
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                                   atol=5e-2)
        grads = K.ssm_scan_bwd(x, dt, al, b, c, dy, chunk=64)
        torch.cuda.synchronize()
        assert K.launch_counts["ssm_scan"] == before["ssm_scan"] + n
        assert K.launch_counts["ssm_scan_bwd"] == before["ssm_scan_bwd"] + n
        ref = [t.clone().requires_grad_() for t in (x, dt, al, b, c)]
        wants = torch.autograd.grad(P.ssm_scan_ref(*ref, chunk=64), ref, dy)
        for name, a, w in zip(("x", "dt", "a_log", "b", "c"), grads, wants):
            assert a.dtype == w.dtype and a.shape == w.shape, (Pd, name)
            assert _rel_max(a, w) <= 5e-2, (Pd, name, _rel_max(a, w))


@pytest.mark.gpu
def test_cuda_ssm_scan_bf16_chunk_256(cuda):
    """A bfloat16 chunk of 256 rows (four tiles), which the kernels
    refused before they took any chunk that divides S: the forward and the
    gradients within 5e-2 of the plain version's."""
    x, dt, al, b, c, dy = _ssm_inputs(cuda, (1, 256, 2, 64, 16, 256),
                                      torch.bfloat16)
    before = dict(K.launch_counts)
    got = K.ssm_scan(x, dt, al, b, c, chunk=256)
    want = P.ssm_scan_ref(x, dt, al, b, c, chunk=256)
    torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                               atol=5e-2)
    grads = K.ssm_scan_bwd(x, dt, al, b, c, dy, chunk=256)
    torch.cuda.synchronize()
    assert K.launch_counts["ssm_scan"] == before["ssm_scan"] + 1
    assert K.launch_counts["ssm_scan_bwd"] == before["ssm_scan_bwd"] + 1
    ref = [t.clone().requires_grad_() for t in (x, dt, al, b, c)]
    wants = torch.autograd.grad(P.ssm_scan_ref(*ref, chunk=256), ref, dy)
    for name, a, w in zip(("x", "dt", "a_log", "b", "c"), grads, wants):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        assert _rel_max(a, w) <= 5e-2, (name, _rel_max(a, w))


@pytest.mark.gpu
def test_cuda_attention_long_step_on_a_filled_cache(cuda):
    """``Attention`` in bf16 at head dim 128: a prefill of 24 tokens into
    an empty cache, then a step of 1,024 tokens (above ``_Q_CHUNK``, a
    multiple of it), which runs the tensor-core flash kernel over the
    first 1,048 cache rows (a strided view of the cache; 1,048 keys for
    1,024 queries, not a multiple of 64).  Outputs and caches are held
    against the same module on the CPU (the plain version) at 2e-2."""
    import copy
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_config

    cfg = dataclasses.replace(get_config("starcoder2-15b").reduced(),
                              d_head=128, n_kv_heads=2)
    host = L.Attention(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    mods = {"cpu": host, "cuda": copy.deepcopy(host).to(cuda)}
    B, S0, step = 2, 24, 1024
    shape = (B, S0 + step + 8, cfg.n_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.normal(size=(B, n, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16) for n in (S0, step)]
    outs, caches = {}, {}
    before = K.launch_counts["flash_attention"]
    with torch.no_grad():
        for dev, mod in mods.items():
            cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
                     "v": torch.zeros(shape, dtype=torch.bfloat16),
                     "len": torch.zeros((B,), dtype=torch.int32)}
            cache = {k: v.to(dev) for k, v in cache.items()}
            outs[dev] = []
            for s0, x in zip((0, S0), xs):
                pos = torch.arange(s0, s0 + x.shape[1], dtype=torch.int32)
                y, cache = mod(x.to(dev), pos.expand(B, -1).to(dev), cache)
                outs[dev].append(y)
            caches[dev] = cache
    torch.cuda.synchronize()
    # the prefill and the long step, each through the kernel
    assert K.launch_counts["flash_attention"] == before + 2
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=2e-2, atol=2e-2)
    for key in ("k", "v"):
        torch.testing.assert_close(caches["cuda"][key].float().cpu(),
                                   caches["cpu"][key].float(), rtol=2e-2,
                                   atol=2e-2)
    assert caches["cuda"]["len"].tolist() == [S0 + step] * B


def _card_and_cpu(cuda, module):
    """``module`` (on the CPU) and a copy of it on the card."""
    import copy

    return {"cpu": module, "cuda": copy.deepcopy(module).to(cuda)}


def _bf16(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(torch.bfloat16)


@pytest.mark.gpu
def test_cuda_mla_layer_matches_the_cpu(cuda):
    """deepseek-v2-lite's MLA layer (reduced) in bf16: a prefill of 24
    tokens into an empty latent cache of 32 rows, then one-token steps
    until the last write clamps to the final row.  Outputs and the latent
    cache are held against the same module on the CPU at 2e-2; MLA is
    einsum, so the flash kernel never launches."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config

    cfg = get_config("deepseek-v2-lite-16b").reduced()
    mods = _card_and_cpu(cuda, L.MLA(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    B, T = 2, 32
    rng = np.random.default_rng(6)
    steps = [(0, 24)] + [(s, 1) for s in range(24, T + 1)]
    xs = [_bf16(rng, B, n, cfg.d_model) for _, n in steps]
    outs, caches = {}, {}
    before = K.launch_counts["flash_attention"]
    with torch.no_grad():
        for dev, mod in mods.items():
            cache = M._init_layer_cache(cfg, "attn", B, T, dev)
            outs[dev] = []
            for (s0, n), x in zip(steps, xs):
                pos = torch.arange(s0, s0 + n, dtype=torch.int32)
                y, cache = mod(x.to(dev), pos.expand(B, -1).to(dev), cache)
                outs[dev].append(y)
            caches[dev] = cache
    torch.cuda.synchronize()
    assert K.launch_counts["flash_attention"] == before
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   rtol=2e-2, atol=2e-2)
    for key in ("ckv", "kr"):
        torch.testing.assert_close(caches["cuda"][key].float().cpu(),
                                   caches["cpu"][key].float(), rtol=2e-2,
                                   atol=2e-2)
    assert caches["cuda"]["len"].tolist() == [T + 1] * B


@pytest.mark.gpu
@pytest.mark.parametrize("S", [512, 1])
def test_cuda_cross_attention_matches_the_cpu(cuda, S):
    """llama-3.2-vision's cross-attention at its head dim (128) with two
    query heads per kv head, over 1,601 context rows (the vision tokens;
    ragged against the kernel's tiles): a prompt of 512 through the
    non-causal flash kernel, one token through ``_sdpa_direct``, against
    the same module on the CPU at 2e-2."""
    import dataclasses

    from repro_torch.models import layers as L
    from repro_torch.models.registry import get_config

    cfg = dataclasses.replace(get_config("llama-3.2-vision-11b").reduced(),
                              d_head=128, n_kv_heads=2)
    mods = _card_and_cpu(cuda, L.Attention(
        cfg, device="cpu", generator=torch.Generator().manual_seed(1)))
    rng = np.random.default_rng(7)
    x, ctx = _bf16(rng, 2, S, cfg.d_model), _bf16(rng, 2, 1601, cfg.d_model)
    pos = torch.arange(S).expand(2, -1)
    before = K.launch_counts["flash_attention"]
    with torch.no_grad():
        outs = {dev: mod(x.to(dev), pos.to(dev), None,
                         cross_ctx=ctx.to(dev))[0]
                for dev, mod in mods.items()}
    torch.cuda.synchronize()
    assert K.launch_counts["flash_attention"] == before + (S > 1)
    torch.testing.assert_close(outs["cuda"].float().cpu(),
                               outs["cpu"].float(), rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_cuda_encode_matches_the_cpu(cuda):
    """seamless-m4t's encoder (reduced, at its head dim 64) over 200 frames
    in bf16: one non-causal flash launch per encoder layer, the output
    against the same model on the CPU at 2e-2."""
    import dataclasses

    from repro_torch.models import model as M
    from repro_torch.models.registry import get_config

    cfg = dataclasses.replace(get_config("seamless-m4t-medium").reduced(),
                              d_head=64)
    host = M.Model(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(2))
    card = M.Model(cfg, device=cuda, generator=None)
    card.load_state_dict(host.state_dict())
    frames = _bf16(np.random.default_rng(8), 2, 200, cfg.d_model)
    before = K.launch_counts["flash_attention"]
    with torch.no_grad():
        want = M.encode(host, frames)
        got = M.encode(card, frames.to(cuda))
    torch.cuda.synchronize()
    assert K.launch_counts["flash_attention"] == before + cfg.encoder_layers
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000, 8192, 1 << 20])
@pytest.mark.parametrize("degree", [0, 1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_horner_bitwise_plain_version(cuda, n, degree, dtype):
    """No fused multiply-add on either side: bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(n + degree)
    x = torch.randn((n,), generator=g, device=cuda).to(dtype)
    cf = torch.randn((degree + 1,), generator=g, device=cuda)
    before = K.launch_counts["horner"]
    got = K.horner(x, cf)
    torch.cuda.synchronize()
    assert K.launch_counts["horner"] == before + 1
    want = P.horner_ref(x, cf)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 9, (1 << 20) + 3])
@pytest.mark.parametrize("degree", [8, 17])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_horner_vectors_and_edges(cuda, n, degree, dtype, offset):
    """Lengths that are no multiple of the 16-byte vector, a view that
    starts off a 16-byte boundary (x[1:]), and degree 17 (past the 16
    coefficients held in registers): bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7 * n + degree + offset)
    x = torch.randn((n + offset,), generator=g, device=cuda).to(dtype)
    x = x[offset:]
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    cf = torch.randn((degree + 1,), generator=g, device=cuda) * 0.5
    before = K.launch_counts["horner"]
    got = K.horner(x, cf)
    torch.cuda.synchronize()
    assert K.launch_counts["horner"] == before + 1
    want = P.horner_ref(x, cf)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_refused_launch_raises(cuda):
    """An unsupported head dim, bf16 tensors that do not start on a
    16-byte boundary (the tensor-core kernels read by TMA) and too many
    coefficients raise on the card; nothing falls back to the plain
    version."""
    before = dict(K.launch_counts)
    q = torch.zeros((1, 2, 64, 24), device=cuda)
    with pytest.raises(ValueError):
        K.flash_attention(q, q, q)
    base = torch.zeros((2 * 64 * 64 + 1,), device=cuda,
                       dtype=torch.bfloat16)
    q = base[1:].view(1, 2, 64, 64)   # contiguous, 2 bytes in
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError):
        K.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        K.horner(torch.zeros((8,), device=cuda),
                 torch.zeros((20000,), device=cuda))
    assert K.launch_counts == before


# ------------------------------------------------ the device search (A10)

@pytest.mark.gpu
@pytest.mark.parametrize("cap,n", [(64, 200), (1 << 15, 600)])
def test_cuda_device_memo_tables_equal_the_cpu(cuda, cap, n):
    from repro_torch.core.dse import device_memo as M
    rng = np.random.default_rng(n)
    keys = torch.as_tensor(rng.integers(0, 40, (n, 43)).astype(np.int32))
    keys[: n // 4] = keys[n // 4: n // 2]       # in-batch duplicates
    vals = torch.as_tensor(rng.standard_normal((n, 3, 2)))
    upd = torch.as_tensor(rng.random(n) < 0.8)
    tables = []
    for dev in ("cpu", cuda):
        m = M.memo_insert(M.memo_init(cap, 2, dev), keys.to(dev),
                          vals.to(dev), upd.to(dev))
        hit, out = M.memo_lookup(m, keys.to(dev))
        tables.append([t.cpu() for t in (*m, hit, out[hit])])
    for a, b in zip(*tables):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_genetics_configs_and_fitness_equal_the_cpu(cuda):
    from repro_torch.core.dse import ga_device as G
    from repro_torch.core.dse.engine import genomes_to_configs
    rng = np.random.default_rng(7)
    pop = random_genomes(rng, 200).astype(np.int32)
    fit = rng.normal(size=200)
    fit[::7] = -np.inf
    out = []
    for dev in ("cpu", cuda):
        d = G.TorchDraws(200)(1, 200, 5, 20, dev)[0]
        child, canon = G.genetics_step(
            torch.as_tensor(pop, device=dev),
            torch.as_tensor(fit, device=dev), d, 20, 0.8, 0.2)
        out.append((child.cpu(), canon.cpu()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    g = out[1][0].numpy()
    host = genomes_to_configs(g)
    tile, chip, area = G._configs_device(torch.as_tensor(g, device=cuda))
    for k, v in tile.items():
        assert np.array_equal(v.cpu().numpy(), host["tile"][k]), k
    for k, v in chip.items():
        assert np.array_equal(v.cpu().numpy(), host["chip"][k]), k
    assert np.array_equal(area.cpu().numpy(), host["chip"]["chip_area"])
    m = {"energy": rng.uniform(1, 5, (200, 3)),
         "tops_w": rng.uniform(0.1, 2, (200, 3)),
         "latency": rng.uniform(1e-4, 1e-2, (200, 3)),
         "area": host["chip"]["chip_area"]}
    e_homo = rng.uniform(2, 4, 3)
    for b in (100.0, 200.0, 800.0):
        assert G.fitness_device(m, e_homo, b, 0.05, cuda).tobytes() == \
            G.fitness_device(m, e_homo, b, 0.05, "cpu").tobytes()


# ------------------------------------- the service and the cluster (A11)

def _cuda_exact(cuda):
    return EvalEngine(["kan"], config=EngineConfig(backend="exact"),
                      device=cuda)


def _same_rows(a, b, keys=("latency", "energy", "tops_w", "area")):
    for k in keys:
        assert np.asarray(a[k]).tobytes() == np.asarray(b[k]).tobytes(), k


@pytest.mark.gpu
@pytest.mark.parametrize("transport", ["client", "tcp"])
def test_cuda_service_equals_a_local_cuda_engine(cuda, transport):
    from repro_torch.serve.dse_service import DSEClient, DSEService
    g = random_genomes(np.random.default_rng(5), 10)
    svc = DSEService(_cuda_exact(cuda)).start()
    try:
        cl = (DSEClient(service=svc) if transport == "client"
              else DSEClient(address=svc.listen(), timeout=120.0))
        try:
            res = cl.evaluate(g)
            _same_rows(res, _cuda_exact(cuda).evaluate(g))
            _same_rows(cl.rescore(g), _cuda_exact(cuda).rescore(g))
        finally:
            cl.close()
    finally:
        svc.stop()
    cpu = EvalEngine(["kan"], config=EngineConfig(backend="exact"),
                     device="cpu").evaluate(g)
    for k in ("latency", "energy", "tops_w"):
        fin = np.isfinite(cpu[k])
        assert np.array_equal(fin, np.isfinite(res[k])), k
        err = np.abs(res[k][fin] - cpu[k][fin]) \
            / np.maximum(np.abs(cpu[k][fin]), 1e-300)
        assert err.max(initial=0.0) <= 1e-9, k


def _ga_inputs(cuda):
    from repro_torch.core.dse.ga import GAConfig
    from repro_torch.core.dse.sweep import run_sweep
    sweep = run_sweep(["kan"], samples_per_stratum=4, seed=0,
                      brackets=(100.0, 200.0), engine=_cuda_exact(cuda))
    return sweep, GAConfig(population=12, generations=3, seed_top_k=6,
                           early_stop=10_000)


@pytest.mark.gpu
def test_cuda_cluster_under_a_worker_kill_equals_an_unfaulted_run(cuda):
    from repro_torch.core.dse.faults import FaultInjector
    from repro_torch.core.dse.ga import run_ga
    from repro_torch.serve.cluster import DSECluster
    from repro_torch.serve.dse_service import DSEService
    sweep, cfg = _ga_inputs(cuda)
    clean = run_ga(sweep, 200.0, cfg, seed=0, engine=_cuda_exact(cuda))
    inj = FaultInjector(seed=0, at={"worker_kill": (3,)})
    svcs = [DSEService(_cuda_exact(cuda), worker_id=f"gpu-w{i}").start()
            for i in range(2)]
    cl = DSECluster(svcs, fault_injector=inj, backoff_s=0.01)
    try:
        served = run_ga(sweep, 200.0, cfg, seed=0, engine=cl, device=cuda)
    finally:
        cl.close()
        for s in svcs:
            s.stop(drain=False)
    assert inj.fired()["worker_kill"] == 1
    assert served.best_fitness == clean.best_fitness
    assert served.best_genome.tobytes() == clean.best_genome.tobytes()
    assert served.history == clean.history
    _same_rows(served.best_metrics, clean.best_metrics,
               ("latency", "energy", "tops_w"))


@pytest.mark.gpu
def test_cuda_served_search_runs_its_genetics_on_cuda(cuda, monkeypatch):
    from repro_torch.core.dse import ga_device as G
    from repro_torch.core.dse.ga import run_ga
    from repro_torch.serve.dse_service import DSEClient, DSEService
    sweep, cfg = _ga_inputs(cuda)
    seeds = sweep.genomes[:8]
    e_homo = sweep.homo_baseline()[200.0]
    devices = []
    real = G.genetics_step

    def spy(pop, *a, **kw):
        devices.append(pop.device.type)
        return real(pop, *a, **kw)

    monkeypatch.setattr(G, "genetics_step", spy)
    svc = DSEService(_cuda_exact(cuda)).start()
    try:
        events = list(DSEClient(service=svc).search(
            seeds, 200.0, e_homo, cfg=dict(population=12, generations=3,
                                           seed_top_k=6, early_stop=10_000),
            seed=0))
    finally:
        svc.stop()
    assert events[-1]["event"] == "done", events[-1]
    assert devices and set(devices) == {"cuda"}
    from repro_torch.serve.dse_service import _SeedPool
    local = run_ga(_SeedPool(["kan"], seeds, 200.0, e_homo), 200.0, cfg,
                   seed=0, engine=_cuda_exact(cuda))
    res = events[-1]["result"]
    assert res["best_fitness"] == local.best_fitness
    assert res["best_genome"] == local.best_genome.tolist()


@pytest.mark.gpu
def test_cuda_one_rank_mesh_and_ring_matmul(cuda):
    """``make_mesh_for_devices(1)`` makes a (1, 1) mesh over an NCCL group
    of one rank; the ring matmul on it (no send) is ``x @ w``."""
    import torch.distributed as dist

    from repro_torch.distributed.overlap import ring_allgather_matmul
    from repro_torch.launch.mesh import make_mesh_for_devices
    assert not dist.is_initialized()
    try:
        mesh = make_mesh_for_devices(1)
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
        assert dist.get_backend() == "nccl"
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(512, 256, generator=gen).to(cuda)
        w = torch.randn(256, 384, generator=gen).to(cuda)
        y = ring_allgather_matmul(x, w, mesh.get_group("model"))
        torch.testing.assert_close(y, x @ w, rtol=1e-6, atol=0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["batched", "exact"])
def test_cuda_sharded_engine_equals_the_unsharded_one(cuda, backend):
    """One card: ``shard=True`` keeps the one-device path, bit for bit."""
    from repro_torch.launch.mesh import candidate_sharding, default_islands
    g = random_genomes(np.random.default_rng(26), 16)
    assert candidate_sharding() is None and default_islands(16) == 1
    a = EvalEngine(["kan"], config=EngineConfig(backend=backend, shard=True),
                   device=cuda).evaluate(g)
    b = EvalEngine(["kan"], config=EngineConfig(backend=backend),
                   device=cuda).evaluate(g)
    for k in ("latency", "energy", "tops_w", "area"):
        assert np.array_equal(a[k], b[k]), k
