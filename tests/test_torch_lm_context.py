"""PyTorch port, the three LM configs that need a context or the dense
prefix, whole, in bf16 against the JAX package on ``reduced()`` configs:
deepseek-v2-lite (MLA, the unscanned dense prefix, shared and routed
experts), llama-3.2-vision (cross-attention layers over vision
embeddings) and seamless-m4t (the encoder, the decoder's ``xattn`` over
its output).  The weights carried across bit for bit (prefix, stacked
blocks, stacked encoder); ``forward``, teacher-forced ``decode_step`` and
the serve steps with the context within 2e-2; ``ServeEngine``'s tokens;
and the loss and gradients within tests/test_torch_train_step.py's
limits.

The reference is compiled with ``xla_allow_excess_precision`` off
(tests/test_torch_lm_serve.py ``strict``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.serve import step as JS  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402
from repro_torch.serve import step as TS  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.train.step import make_grads_fn  # noqa: E402
from test_torch_lm_serve import _logits, _setup, strict  # noqa: E402
from test_torch_train_step import _as_port, _check_grads  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)
DEEPSEEK, VISION, SEAMLESS = ("deepseek-v2-lite-16b", "llama-3.2-vision-11b",
                              "seamless-m4t-medium")
ARCHS = [DEEPSEEK, VISION, SEAMLESS]
FRAMES = 16     # encoder frames of the reduced seamless-m4t


def _tokens(cfg, B=2, S=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _frontend(jc, B=2, seed=1):
    """The frontend's input of a config, as the data pipeline draws it:
    ``frames`` (B, 16, d_model) for an encoder-decoder, ``vision_embeds``
    (B, num_frontend_tokens, d_model) for a vision model; float32."""
    rng = np.random.default_rng(seed)
    if jc.encoder_layers:
        return {"frames": rng.normal(size=(B, FRAMES, jc.d_model)).astype(
            np.float32)}
    if jc.frontend == "vision":
        return {"vision_embeds": rng.normal(
            size=(B, jc.num_frontend_tokens, jc.d_model)).astype(np.float32)}
    return {}


def _contexts(jc, params, model, B=2):
    """Each side's context for the serve steps: the encoder's output over
    the frames (each side its own encoder), or the vision embeddings;
    None for deepseek."""
    front = _frontend(jc, B)
    if "frames" in front:
        f = front["frames"]
        want = strict(functools.partial(JM.encode, jc))(
            params, jnp.asarray(f, jnp.bfloat16))
        with torch.no_grad():
            got = TM.encode(model, torch.from_numpy(f).to(torch.bfloat16))
        return want, got
    if "vision_embeds" in front:
        v = front["vision_embeds"]
        return jnp.asarray(v), torch.from_numpy(v)
    return None, None


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_copy_bitwise(arch):
    """Every leaf of the reference's tree lands bit for bit in the
    parameter of the same name, by the layout: ``prefix[j]`` -> layer j;
    ``blocks[j][r]`` -> layer ``first_k_dense + r * len(pattern) + j``;
    ``encoder`` row i -> ``encoder.i``; and every parameter has a leaf."""
    jc, tc, params, model = _setup(arch, None)
    tree = jax.tree.map(np.asarray, params)
    k, n_pat = jc.first_k_dense, len(jc.pattern())
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [p.key if hasattr(p, "key") else p.idx for p in path]
        rest = ".".join(str(x) for x in keys[2:])
        if keys[0] == "prefix":
            want[f"layers.{keys[1]}.{rest}"] = leaf
        elif keys[0] == "blocks":
            for r in range(jc.n_repeats):
                want[f"layers.{k + r * n_pat + keys[1]}.{rest}"] = leaf[r]
        elif keys[0] == "encoder":
            name = ".".join(str(x) for x in keys[1:])
            for i in range(jc.encoder_layers):
                want[f"encoder.{i}.{name}"] = leaf[i]
        else:
            want[".".join(str(x) for x in keys)] = leaf
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    for name, p in got.items():
        w = to_torch(want[name])
        assert w.dtype == p.dtype and w.shape == p.shape, name
        assert torch.equal(w.view(as_int[p.dtype]),
                           p.view(as_int[p.dtype])), name
    if k:
        assert isinstance(model.layers[0].ffn, TM.L.FFN)
        assert isinstance(model.layers[k].ffn, TM.L.MoE)
        assert isinstance(model.layers[0].attn, TM.L.MLA)


@pytest.mark.parametrize("arch", [DEEPSEEK, SEAMLESS])
def test_forward_with_context(arch):
    """Prefill logits over every position, with each side's context
    (llama-3.2-vision's is held layer by layer, below)."""
    jc, tc, params, model = _setup(arch, None)
    toks = _tokens(jc)
    jctx, tctx = _contexts(jc, params, model)
    want = strict(lambda p, t, c: JM.forward(jc, p, t, c))(
        params, jnp.asarray(toks), jctx)
    with torch.no_grad():
        got = TM.forward(model, torch.from_numpy(toks), tctx)
    np.testing.assert_allclose(_logits(got, tc), _logits(want, jc), **TOL)


def test_vision_forward_layer_by_layer():
    """Reduced llama-3.2-vision (four self-attention layers, then one
    cross-attention layer over the vision embeddings): every port layer,
    fed the reference's input to that layer, gives the reference's
    output, and the final norm and head give its logits."""
    jc, tc, params, model = _setup(VISION, None)
    toks = _tokens(jc)
    jctx, tctx = _contexts(jc, params, model)
    B, S = toks.shape
    pattern = jc.pattern()
    layer = {kinds: strict(lambda p, x, pos, c, kinds=kinds: JM._layer_fwd(
        jc, *kinds, p, x, pos, c, None)[0]) for kinds in set(pattern)}
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    tpos = torch.arange(S).expand(B, S)
    x = params["embed"][jnp.asarray(toks)]
    with torch.no_grad():
        for i, block in enumerate(model.layers):
            y = layer[pattern[i]](jax.tree.map(lambda a: a[0],
                                               params["blocks"][i]),
                                  x, pos, jctx.astype(jnp.bfloat16))
            got, _ = block(to_torch(np.asarray(x)), tpos, None,
                           tctx.to(torch.bfloat16))
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(y, np.float32), **TOL,
                                       err_msg=f"layer {i} {pattern[i]}")
            x = y

    def head(p, x):
        x = JM.L.norm(p["final_norm"], x, jc.norm)
        return JM._mask_pad_logits(jc, x @ p["lm_head"]["w"])

    want = strict(head)(params, x)
    with torch.no_grad():
        tx = TM.L.norm(model.final_norm.scale, to_torch(np.asarray(x)),
                       tc.norm)
        got = TM._mask_pad_logits(tc, TM.L.einsum("bsd,dv->bsv", tx,
                                                  model.head()))
    np.testing.assert_allclose(_logits(got, tc), _logits(want, jc), **TOL)


def test_reference_vision_forward_moves_under_one_bit():
    """Why llama-3.2-vision's whole forward is held layer by layer:
    flipping the last bit of one embedding element moves the reference's
    own logits outside the 2e-2 tolerance (five bf16 layers carry a one-
    ulp difference into about one hidden element in twenty by the last
    layer), so two implementations whose float32 arithmetic differs in
    the last bit (a few bf16 elements of the first layer's output) cannot
    agree end to end at that tolerance."""
    jc, _, params, model = _setup(VISION, None)
    toks = jnp.asarray(_tokens(jc))
    jctx, _ = _contexts(jc, params, model)
    forward = strict(lambda p, t, c: JM.forward(jc, p, t, c))
    base = _logits(forward(params, toks, jctx), jc)
    embed = np.asarray(params["embed"]).copy()
    embed.view(np.uint16)[int(toks[0, 0]), 3] ^= 1
    moved = _logits(forward(dict(params, embed=jnp.asarray(embed)), toks,
                            jctx), jc)
    assert not np.allclose(moved, base, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_with_context(arch):
    """Teacher-forced one-token decode from empty caches, with the
    context at every step."""
    jc, tc, params, model = _setup(arch, None)
    toks = _tokens(jc, S=8)
    B, S = toks.shape
    jctx, tctx = _contexts(jc, params, model)
    decode = strict(lambda p, t, pos, c, ctx: JM.decode_step(
        jc, p, t, pos, c, ctx))
    jcaches = JM.init_cache(jc, B, S)
    tcaches = TM.init_cache(tc, B, S, "cpu")
    with torch.no_grad():
        for t in range(S):
            want, jcaches = decode(params, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.full((B,), t, jnp.int32), jcaches,
                                   jctx)
            got, tcaches = TM.decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32), tcaches, tctx)
            np.testing.assert_allclose(_logits(got, tc), _logits(want, jc),
                                       **TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_with_context(arch):
    """``make_prefill_step`` over a prompt of 64 tokens into caches of 72
    rows, then 4 greedy ``make_decode_step`` steps, both with the context
    (the reference's steps with ``ctx``): the last-position logits at
    every step, and the same greedy tokens."""
    jc, tc, params, model = _setup(arch, None)
    toks = _tokens(jc, seed=2)
    B, S = toks.shape
    jctx, tctx = _contexts(jc, params, model)
    jpre = strict(lambda p, t, c: JS.make_prefill_step(jc, S + 8)(p, t, c))
    jdec = strict(lambda p, t, pos, cs, c: JS.make_decode_step(jc)(
        p, t, pos, cs, c))
    tpre, tdec = TS.make_prefill_step(tc, S + 8), TS.make_decode_step(tc)
    want, jcaches = jpre(params, jnp.asarray(toks), jctx)
    got, tcaches = tpre(model, torch.from_numpy(toks), tctx)
    for t in range(S, S + 4):
        np.testing.assert_allclose(_logits(got, tc), _logits(want, jc),
                                   **TOL, err_msg=f"position {t}")
        nxt = np.asarray(JS.greedy_sample(want))
        assert np.array_equal(TS.greedy_sample(got).numpy(), nxt)
        want, jcaches = jdec(params, jnp.asarray(nxt[:, None]),
                             jnp.full((B,), t, jnp.int32), jcaches, jctx)
        got, tcaches = tdec(model, torch.from_numpy(nxt[:, None]),
                            torch.full((B,), t, dtype=torch.int32), tcaches,
                            tctx)
    np.testing.assert_allclose(_logits(got, tc), _logits(want, jc), **TOL)


@pytest.mark.parametrize("arch", [DEEPSEEK, VISION])
def test_serve_engine_matches_reference(arch):
    """Continuous batching (two slots, three requests, left-padded waves):
    the port's engine generates the reference's tokens.  Neither engine
    passes a context, so llama-3.2-vision's cross-attention layers serve
    their context-free form, and their caches are None."""
    jc, tc, params, model = _setup(arch, None)
    rng = np.random.default_rng(1)
    spec = [(64, 3), (128, 6), (64, 4)]
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32)
               for n, _ in spec]
    ref = JEngine(jc, params, max_batch=2, max_len=256)
    ref.prefill = strict(JS.make_prefill_step(jc, 256))
    ref.decode = strict(JS.make_decode_step(jc))
    port = ServeEngine(tc, model, max_batch=2, max_len=256)
    for eng, req in ((ref, JRequest), (port, Request)):
        for rid, (prompt, (_, new)) in enumerate(zip(prompts, spec)):
            eng.submit(req(rid=rid, prompt=prompt, max_new_tokens=new))
    want = ref.run()
    got = port.run()
    assert {k: len(v) for k, v in got.items()} == {0: 3, 1: 6, 2: 4}
    assert got == want


def _batch(jc, B=2, S=64):
    toks = np.random.default_rng(3).integers(0, jc.vocab, (B, S + 1)).astype(
        np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], **_frontend(jc)}


@pytest.mark.parametrize("arch", [DEEPSEEK, SEAMLESS])
def test_loss_and_grads_match_reference(arch):
    """One training step's loss and gradients (remat), seamless-m4t's
    batch with its frames: the loss within 1e-5 relative, every gradient
    by tests/test_torch_train_step.py's ``_check_grads`` (the encoder's
    among them).  (llama-3.2-vision's is held layer by layer, below.)"""
    jc, tc, params, model = _setup(arch, None)
    batch = _batch(jc)
    jl, jg = strict(jax.value_and_grad(functools.partial(JM.loss_fn, jc)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    loss, grads = make_grads_fn(tc, remat=True)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    want = _as_port(tc, jg, names)
    assert set(grads) == set(want)
    if jc.encoder_layers:
        assert any(n.startswith("encoder.") and float(g.abs().max()) > 0
                   for n, g in grads.items())
    _check_grads(grads, want)


def test_vision_loss_and_grads_layer_by_layer():
    """Reduced llama-3.2-vision with its vision embeddings, layer by
    layer (see test_reference_vision_forward_moves_under_one_bit): every
    block, fed the reference's input to that block, the context and one
    random output gradient, gives the reference's gradients of its
    parameters and of its input (the cross-attention layer's k and v
    take the context); the final norm and the chunked cross-entropy, fed
    the reference's last hidden state, give its loss (within 1e-5) and the
    gradients of the head and of that state.  The loss goes through
    ``loss_fn`` on both sides too, as a reading of the end-to-end gap."""
    jc, tc, params, model = _setup(VISION, None)
    batch = _batch(jc)
    toks = batch["tokens"]
    B, S = toks.shape
    pattern = jc.pattern()
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    tpos = torch.arange(S).expand(B, S)
    jctx = jnp.asarray(batch["vision_embeds"], jnp.bfloat16)
    tctx = torch.from_numpy(batch["vision_embeds"]).to(torch.bfloat16)

    def pullback(kinds, p, x, cot):
        y, vjp = jax.vjp(lambda p, x: JM._layer_fwd(
            jc, *kinds, p, x, pos, jctx, None)[0], p, x)
        return (y,) + vjp(cot)

    compiled = {}
    rng = np.random.default_rng(5)
    x = params["embed"][jnp.asarray(toks)]
    for i, block in enumerate(model.layers):
        p = jax.tree.map(lambda a: a[0], params["blocks"][i])
        cot = jnp.asarray(rng.normal(size=x.shape), jnp.bfloat16)
        if pattern[i] not in compiled:
            compiled[pattern[i]] = strict(functools.partial(pullback,
                                                            pattern[i]))
        y, jgp, jgx = compiled[pattern[i]](p, x, cot)
        tx = to_torch(np.asarray(x)).requires_grad_()
        names, ps = zip(*block.named_parameters())
        gs = torch.autograd.grad(block(tx, tpos, None, tctx)[0],
                                 (tx,) + ps, to_torch(np.asarray(cot)))
        got = dict(zip(("input",) + names, gs))
        want = {"input": np.asarray(jgx, np.float32)}
        flat, _ = jax.tree_util.tree_flatten_with_path(jgp)
        for path, leaf in flat:
            want[".".join(k.key for k in path)] = leaf
        assert set(want) == set(got), i
        _check_grads(got, want)
        x = y

    def head_loss(p, x):
        h = JM.L.norm(p["final_norm"], x, jc.norm)
        return JM._chunked_ce(jc, h, p["lm_head"]["w"],
                              jnp.asarray(batch["labels"]))

    head = {"final_norm": params["final_norm"], "lm_head": params["lm_head"]}
    jl, (jgh, jgx) = strict(jax.value_and_grad(head_loss, (0, 1)))(head, x)
    tx = to_torch(np.asarray(x)).requires_grad_()
    scale, w = model.final_norm.scale, model.head()
    tl = TM._chunked_ce(tc, TM.L.norm(scale, tx, tc.norm), w,
                        torch.from_numpy(batch["labels"]))
    gs, gw, gx = torch.autograd.grad(tl, (scale, w, tx))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _check_grads({"final_norm.scale": gs, "lm_head.w": gw, "x": gx},
                 {"final_norm.scale": jgh["final_norm"]["scale"],
                  "lm_head.w": jgh["lm_head"]["w"], "x": jgx})
