"""PyTorch port, the mixers of the LM substrate that deepseek-v2-lite,
llama-3.2-vision and seamless-m4t add, in bf16 against the JAX package on
``reduced()`` configs: MLA with its latent cache (prefill, decode, a
clamped write into a full cache), cross-attention with GQA over a context
of another length, ``encode``, a decoder layer with ``xattn``, and the
reference's context-free ``cross_attn`` layer.  Then every config of
``repro_torch/configs`` builds and runs on the CPU, and the serving
engine admits waves into a model whose cross-attention layers have no
cache.

The reference is compiled with ``xla_allow_excess_precision`` off
(tests/test_torch_lm_serve.py ``strict``); outputs are held within 2e-2,
the tolerance of the bf16 serving tests."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.registry import get_config as jax_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokenPipeline  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402
from repro_torch.models.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.step import make_decode_step  # noqa: E402
from repro_torch.serve.step import make_prefill_step  # noqa: E402
from test_torch_lm_serve import _setup, strict  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)
BF16 = jnp.bfloat16


def _cfgs(arch, **kw):
    return tuple(dataclasses.replace(c.reduced(), **kw)
                 for c in (jax_config(arch), get_config(arch)))


def _load(module, tree):
    """Every parameter of ``module`` from the leaf at its path in
    ``tree``, bit for bit."""
    for name, p in module.named_parameters():
        leaf = tree
        for part in name.split("."):
            leaf = leaf[part]
        p.data = to_torch(np.asarray(leaf))
    return module


def _bf16(rng, *shape):
    """The same bf16 values for both sides."""
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32), BF16)
    return a, to_torch(np.asarray(a))


def _close(want, got, what=""):
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want, np.float32), **TOL,
                               err_msg=what)


def _positions(s0, n, B=2):
    return np.broadcast_to(np.arange(s0, s0 + n, dtype=np.int32),
                           (B, n)).copy()


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_pair():
    jc, tc = _cfgs("deepseek-v2-lite-16b")
    p = JL.init_mla(jax.random.PRNGKey(1), jc)
    return jc, tc, p, _load(TL.MLA(tc, device="cpu", generator=None), p)


def test_mla_without_cache_matches_reference(rng):
    """The training form: the S new tokens, causal by position."""
    jc, _, p, mod = _mla_pair()
    jx, tx = _bf16(rng, 2, 24, jc.d_model)
    pos = _positions(0, 24)
    want, _ = strict(lambda p, x, pos: JL.mla_attention(p, jc, x, pos))(
        p, jx, jnp.asarray(pos))
    got, cache = mod(tx, torch.from_numpy(pos))
    assert cache is None and got.dtype == torch.bfloat16
    _close(want, got)


def test_mla_prefill_decode_and_clamped_write(rng):
    """A prefill of 24 tokens into an empty latent cache of 32 rows, then
    one-token steps until ``len`` passes the cache's end: the last write
    clamps to the final row (the reference's ``dynamic_update_slice``).
    Outputs, the latent cache (``ckv``, ``kr``) and ``len`` against the
    reference at every step."""
    jc, tc, p, mod = _mla_pair()
    B, T = 2, 32
    mla = strict(lambda p, x, pos, c: JL.mla_attention(p, jc, x, pos, c))
    jcache = JM._init_layer_cache(jc, "attn", B, T)
    tcache = TM._init_layer_cache(tc, "attn", B, T, "cpu")
    assert set(tcache) == set(jcache) == {"ckv", "kr", "len"}
    steps = [(0, 24)] + [(s, 1) for s in range(24, T + 1)]
    for s0, n in steps:
        jx, tx = _bf16(rng, B, n, jc.d_model)
        pos = _positions(s0, n)
        want, jcache = mla(p, jx, jnp.asarray(pos), jcache)
        got, tcache = mod(tx, torch.from_numpy(pos), tcache)
        _close(want, got, f"step at {s0}")
        for key in ("ckv", "kr"):
            _close(jcache[key], tcache[key], f"{key} at {s0}")
        assert np.array_equal(np.asarray(jcache["len"]), tcache["len"])
    assert tcache["len"].tolist() == [T + 1] * B


# ---------------------------------------------------------------------------
# cross-attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [24, 1])
def test_cross_attention_gqa_other_length(rng, S):
    """Two query heads per kv head, queries over a context of 40 rows:
    k and v from the context, no rope, no mask.  A prompt of 24 tokens
    goes through the flash path, one token through ``_sdpa_direct``."""
    jc, tc = _cfgs("llama-3.2-vision-11b", n_kv_heads=2)
    p = JL.init_attention(jax.random.PRNGKey(2), jc)
    mod = _load(TL.Attention(tc, device="cpu", generator=None), p)
    jx, tx = _bf16(rng, 2, S, jc.d_model)
    jctx, tctx = _bf16(rng, 2, 40, jc.d_model)
    pos = _positions(7, S)
    want, _ = strict(lambda p, x, pos, ctx: JL.attention(
        p, jc, x, pos, None, cross_ctx=ctx))(p, jx, jnp.asarray(pos), jctx)
    got, cache = mod(tx, torch.from_numpy(pos), None, cross_ctx=tctx)
    assert cache is None
    _close(want, got)


def test_encode_matches_reference(rng):
    """Reduced seamless-m4t's encoder stack and final norm over 24 frames
    (non-causal, no rope; layernorm and gelu)."""
    jc, tc, params, model = _setup("seamless-m4t-medium", None)
    assert len(model.encoder) == jc.encoder_layers == 2
    jf, tf = _bf16(rng, 2, 24, jc.d_model)
    want = strict(functools.partial(JM.encode, jc))(params, jf)
    with torch.no_grad():
        got = TM.encode(model, tf)
    _close(want, got)


@pytest.mark.parametrize("with_ctx", [True, False])
def test_decoder_layer_with_xattn(rng, with_ctx):
    """Reduced seamless-m4t's decoder layer: self-attention, then
    ``xattn`` over the encoder's output (16 rows against 24 tokens), then
    the FFN; without a context ``xattn`` is skipped."""
    jc, tc, params, model = _setup("seamless-m4t-medium", None)
    block = model.layers[0]
    assert block.xattn is not None
    p = jax.tree.map(lambda a: a[0], params["blocks"][0])
    jx, tx = _bf16(rng, 2, 24, jc.d_model)
    jctx, tctx = _bf16(rng, 2, 16, jc.d_model)
    if not with_ctx:
        jctx = tctx = None
    pos = _positions(0, 24)
    want, _ = strict(lambda p, x, pos, ctx: JM._layer_fwd(
        jc, "attn", "dense", p, x, pos, ctx, None))(
            p, jx, jnp.asarray(pos), jctx)
    with torch.no_grad():
        got, _ = block(tx, torch.from_numpy(pos), None, tctx)
    _close(want, got)


@pytest.mark.parametrize("S", [16, 1])
def test_cross_attn_layer_without_context(rng, S):
    """The reference's ``cross_attn`` layer called without a context runs
    causal self-attention with rope over the new tokens only, and keeps
    no cache: a one-token step attends to itself alone, so its attention
    output is ``o(v(h))`` exactly."""
    jc, tc, params, model = _setup("llama-3.2-vision-11b", None)
    j = [m for m, _ in jc.pattern()].index("cross_attn")
    block = model.layers[j]
    assert block.mixer == "cross_attn"
    p = jax.tree.map(lambda a: a[0], params["blocks"][j])
    jx, tx = _bf16(rng, 2, S, jc.d_model)
    pos = _positions(5, S)
    want, jc_out = strict(lambda p, x, pos: JM._layer_fwd(
        jc, "cross_attn", "dense", p, x, pos, None, None))(
            p, jx, jnp.asarray(pos))
    with torch.no_grad():
        got, cache = block(tx, torch.from_numpy(pos), None)
        assert cache is None and jc_out is None
        _close(want, got)
        if S == 1:
            h = block.norm1(tx)
            out, _ = block.attn(h, torch.from_numpy(pos), None)
            assert torch.equal(out, block.attn.o(block.attn.v(h)))


# ---------------------------------------------------------------------------
# every config on the CPU, and the engine around cache-free layers
# ---------------------------------------------------------------------------

def _context(cfg, model, B, gen):
    """The context a config's cross-attention reads: the encoder's output
    over 16 frames, or the vision embeddings; None otherwise."""
    if cfg.encoder_layers:
        return TM.encode(model, torch.randn(
            (B, 16, cfg.d_model), generator=gen).to(torch.bfloat16))
    if cfg.frontend == "vision":
        return torch.randn((B, cfg.num_frontend_tokens, cfg.d_model),
                           generator=gen)
    return None


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_config_builds_and_runs(arch):
    """``Model(get_config(a).reduced(), device="cpu")`` builds for all ten
    configs, and ``forward``, ``loss_fn`` (with the frames or vision
    embeddings the data pipeline gives it) and the serve steps run and
    give finite values."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    model = TM.Model(cfg, device="cpu", generator=gen)
    B, S = 2, 64
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen)
    with torch.no_grad():
        ctx = _context(cfg, model, B, gen)
        logits = TM.forward(model, toks, ctx)
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
    batch = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B,
        frontend="audio" if cfg.encoder_layers else cfg.frontend,
        num_frontend_tokens=cfg.num_frontend_tokens,
        d_model=cfg.d_model)).batch(0)
    with torch.no_grad():
        loss = TM.loss_fn(model, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert np.isfinite(float(loss))
    last, caches = make_prefill_step(cfg, S + 4)(model, toks, ctx)
    assert len(caches) == cfg.n_layers
    assert [c is None for c in caches] == [
        m == "cross_attn" for m, _ in TM._layer_kinds(cfg)]
    step, caches = make_decode_step(cfg)(
        model, toks[:, :1], torch.full((B,), S, dtype=torch.int32), caches,
        ctx)
    for out in (last, step):
        assert out.shape == (B, 1, cfg.vocab_padded)
        assert bool(torch.isfinite(out[..., :cfg.vocab]).all())


def test_serve_engine_admits_waves_around_cache_free_layers():
    """Reduced llama-3.2-vision has a cross-attention layer, whose cache
    is None: the engine's scatter of each wave's fresh caches skips it
    (the reference's tree map skips None leaves).  Two slots, three
    requests: the third waits for a retired slot and is admitted into
    the caches the first wave filled."""
    cfg = get_config("llama-3.2-vision-11b").reduced()
    model = TM.Model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    eng = ServeEngine(cfg, model, max_batch=2, max_len=128)
    for rid, (n, new) in enumerate([(64, 3), (32, 5), (48, 4)]):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, n).astype(np.int32), max_new_tokens=new))
    got = eng.run()
    assert {k: len(v) for k, v in got.items()} == {0: 3, 1: 5, 2: 4}
    assert all(0 <= t < cfg.vocab for v in got.values() for t in v)
