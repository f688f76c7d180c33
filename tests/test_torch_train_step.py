"""PyTorch port, the training step on the CPU against the JAX package on
``reduced()`` configs: ``loss_fn`` and its gradients, AdamW (float32 and
int8 moments), the warmup-cosine schedule, int8 gradient compression and
microbatched gradient accumulation.

Weights and optimizer states are carried across bit for bit
(``params_from_jax``, ``opt_state_from_jax``).  The loss and gradients
are held against the reference compiled with ``xla_allow_excess_precision``
off (tests/test_torch_lm_serve.py).  The optimizer, schedule and
compression are held against the reference evaluated op by op
(``jax.disable_jit``): compiled, XLA rewrites a division by a constant
into a multiplication by its reciprocal and contracts multiply-adds into
fused ones, which the written program does not do."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.models.registry import get_config as jax_config  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro.optim import schedule as JS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import (opt_state_from_jax,  # noqa: E402
                                        params_from_jax, to_torch)
from repro_torch.models.convert import _by_port_name  # noqa: E402
from repro_torch.models.convert import layer_index  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.optim import schedule as TS  # noqa: E402
from repro_torch.train.step import make_grads_fn  # noqa: E402

_STRICT = {"xla_allow_excess_precision": False}


def _strict(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_STRICT)(*args)


def _setup(arch, n_layers=None):
    """The reference's param tree and the port's model with the same
    weights, drawn by the port (``torch.Generator`` seed 0) and stacked
    into the tree's layout (``jax.eval_shape`` of ``init_params``: the
    reference's own init compiles for longer than these tests run)."""
    jc, tc = jax_config(arch).reduced(), get_config(arch).reduced()
    if n_layers:
        jc = dataclasses.replace(jc, n_layers=n_layers)
        tc = dataclasses.replace(tc, n_layers=n_layers)
    model = TM.Model(tc, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(functools.partial(JM.init_params, jc),
                            jax.random.PRNGKey(0))
    ps = {n: p.detach() for n, p in model.named_parameters()}

    def leaf(path, like):
        keys = [k.key if hasattr(k, "key") else k.idx for k in path]
        if keys[0] == "blocks":
            name = ".".join(keys[2:])
            t = torch.stack([ps[f"layers.{layer_index(tc, keys[1], r)}."
                                f"{name}"] for r in range(tc.n_repeats)])
        else:
            t = ps[".".join(keys)]
        a = t.view(torch.int16).numpy().view(jnp.bfloat16) \
            if t.dtype == torch.bfloat16 else t.numpy()
        assert a.shape == like.shape and a.dtype == like.dtype, keys
        return jnp.asarray(a)

    return jc, tc, jax.tree_util.tree_map_with_path(leaf, shapes), model


def _batch(cfg, B=2, S=64, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _as_port(cfg, tree, names):
    """The reference's per-parameter tree keyed by the port's names."""
    return _by_port_name(cfg, jax.tree.map(np.asarray, tree), names,
                         lambda t: not isinstance(t, dict))


# bf16 gradients, summed in other orders: each element within 2e-2 of
# itself plus 2e-2 of its leaf's largest magnitude (the worst leaf of the
# tests below, Mamba2's conv_w in reduced Jamba, needs 1.1e-2).  Float32 gradients: within
# 1e-4 of both (the worst, a_log, needs 2e-5).
GRAD_RTOL, GRAD_ATOL, F32_TOL = 2e-2, 2e-2, 1e-4
# Mamba2's d_skip gradient is a sum of bf16 products of mixed sign that
# cancels, so in bf16 it is mostly rounding: on reduced mamba2 the
# reference's is 4.0e-2 of the leaf's largest magnitude from its float32
# value and the port's 1.2e-2 (in chip_smoke.py's reduced Jamba blocks the
# port's is up to 6.1e-1 off).  It is held in float32 only.
FLOAT32_ONLY = ("mamba.d_skip",)
# The MoE router's gradient is zero: the top-k gates are divided by their
# sum and enter the output only through that sum (repro/models/layers.py
# ``moe``).  What is left is rounding (about 3e-8 of the block's largest
# gradient on both sides), held within 2^-20 of it.
ZERO = ("ffn.router.w",)


def _check_grads(got, want, float32=False):
    """Per leaf, each element of ``got`` within GRAD_RTOL of itself plus
    GRAD_ATOL of the leaf's largest magnitude in ``want`` (F32_TOL and
    F32_TOL in ``float32``; in bf16 the leaves in FLOAT32_ONLY are
    skipped); the leaves in ZERO within 2^-20 of the largest gradient of
    any leaf, on both sides."""
    rtol, atol = (F32_TOL, F32_TOL) if float32 else (GRAD_RTOL, GRAD_ATOL)
    want = {n: np.asarray(w, np.float32) for n, w in want.items()}
    gmax = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        g, w = g.float().numpy(), want[name]
        if name.endswith(ZERO):
            assert max(np.abs(g).max(), np.abs(w).max()) \
                <= 2.0 ** -20 * gmax, name
        elif float32 or not name.endswith(FLOAT32_ONLY):
            np.testing.assert_allclose(g, w, rtol=rtol,
                                       atol=atol * float(np.abs(w).max()),
                                       err_msg=name)


def _float32(jc, params):
    """The reference's loss and gradients with the model in float32."""
    saved = JM._DTYPE
    JM._DTYPE = jnp.float32
    try:
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
        return _strict(jax.value_and_grad(functools.partial(JM.loss_fn, jc)),
                       p32, {k: jnp.asarray(v)
                             for k, v in _batch(jc).items()})
    finally:
        JM._DTYPE = saved


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """Reduced ``arch``'s weights and the reference's bf16 and float32
    losses and gradients (by the port's names) on ``_batch``."""
    jc, tc, params, model = _setup(arch)
    batch = _batch(jc)
    jl, jg = _strict(jax.value_and_grad(functools.partial(JM.loss_fn, jc)),
                     params, {k: jnp.asarray(v) for k, v in batch.items()})
    jl32, jg32 = _float32(jc, params)
    names = [n for n, _ in model.named_parameters()]
    return (tc, model.state_dict(), batch, float(jl),
            _as_port(tc, jg, names), float(jl32), _as_port(tc, jg32, names))


def _port_grads(arch, dtype=torch.bfloat16):
    tc, weights, batch, *_ = _reference(arch)
    model = TM.Model(tc, device="cpu", generator=None)
    model.load_state_dict(weights)
    if dtype == torch.float32:
        model.float()
    return make_grads_fn(tc, remat=True)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("arch", ["starcoder2-15b", "mamba2-780m"])
def test_loss_and_grads_match_reference(arch):
    """GQA and gelu with an untied head (starcoder2); Mamba2 blocks with
    no FFN, tied embeddings and a padded vocab (mamba2).  In bf16 the loss
    within 1e-5 (float32 sums over the chunk's rows in other orders) and
    the gradients by ``_check_grads``; the same model in float32 (the
    only check of d_skip) within 1e-6 (loss) and F32_TOL (gradients)."""
    _, _, _, jl, jg, jl32, jg32 = _reference(arch)
    loss32, grads32 = _port_grads(arch, torch.float32)
    np.testing.assert_allclose(float(loss32), jl32, rtol=1e-6)
    _check_grads(grads32, jg32, float32=True)
    loss, grads = _port_grads(arch)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    _check_grads(grads, jg)


def _drop_grad(monkeypatch, fault):
    """Plant a fault: the attention's dq or the SSD scan's db is zero."""
    from repro_torch.kernels import ops as kops

    name, arg = {"dq": ("flash_attention", 0), "db": ("ssm_scan", 3)}[fault]
    real = getattr(kops, name)

    def faulty(*args, **kw):
        args = list(args)
        args[arg] = args[arg].detach()
        return real(*args, **kw)

    monkeypatch.setattr(kops, name, faulty)


@pytest.mark.parametrize("arch,fault", [("starcoder2-15b", "dq"),
                                        ("mamba2-780m", "db")])
def test_grad_checks_reject_a_planted_fault(arch, fault, monkeypatch):
    """A zeroed dq (the attention's) or db (the SSD scan's) leaves the
    loss as it is and moves only the gradients that flow through it (the
    q projection; the B columns of in_proj and conv_w): both the bf16 and
    the float32 checks above reject it."""
    _, _, _, jl, jg, _, jg32 = _reference(arch)
    _drop_grad(monkeypatch, fault)
    loss32, grads32 = _port_grads(arch, torch.float32)
    loss, grads = _port_grads(arch)
    np.testing.assert_allclose(float(loss), jl, rtol=1e-5)
    with pytest.raises(AssertionError):
        _check_grads(grads32, jg32, float32=True)
    with pytest.raises(AssertionError):
        _check_grads(grads, jg)


def _block_grads(block, x, cot, pos):
    """The gradients of ``block``'s output against ``cot`` for its
    parameters and its input ``x`` ("input"), in the block's dtype."""
    dtype = next(block.parameters()).dtype
    x = x.to(dtype).requires_grad_()
    names, ps = zip(*block.named_parameters())
    grads = torch.autograd.grad(block(x, pos, None)[0], (x,) + ps,
                                cot.to(dtype), allow_unused=True)
    return {n: torch.zeros_like(q) if g is None else g
            for n, q, g in zip(("input",) + names, (x,) + ps, grads)}


def test_jamba_loss_and_grads_layer_by_layer():
    """Reduced Jamba (attention, Mamba2, dense and MoE blocks), layer by
    layer: every block, fed the reference's input to that block and one
    random output gradient, gives the reference's gradients of its
    parameters and of its input; the final norm and the chunked
    cross-entropy, fed the reference's last hidden state, give its loss
    (within 1e-5) and the gradients of the head and of that state.  (End
    to end a last-bit difference can flip a top-2 routing choice: see
    tests/test_torch_lm_serve.py.)"""
    jc, tc, params, model = _setup("jamba-v0.1-52b")
    batch = _batch(jc)
    toks = batch["tokens"]
    B, S = toks.shape
    pattern = jc.pattern()
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    tpos = torch.arange(S).expand(B, S)

    def pullback(kinds, p, x, cot):
        fwd = functools.partial(JM._layer_fwd, jc, *kinds)
        y, vjp = jax.vjp(lambda p, x: fwd(p, x, pos, None, None)[0], p, x)
        return (y,) + vjp(cot)

    compiled = {}
    rng = np.random.default_rng(5)
    x = params["embed"][jnp.asarray(toks)]
    for i, block in enumerate(model.layers):
        p = jax.tree.map(lambda a: a[0], params["blocks"][i])
        cot = jnp.asarray(rng.normal(size=x.shape), jnp.bfloat16)
        if pattern[i] not in compiled:
            compiled[pattern[i]] = jax.jit(functools.partial(
                pullback, pattern[i])).lower(p, x, cot).compile(
                    compiler_options=_STRICT)
        y, jgp, jgx = compiled[pattern[i]](p, x, cot)
        got = _block_grads(block, to_torch(np.asarray(x)),
                           to_torch(np.asarray(cot)), tpos)
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
    jl, (jgh, jgx) = _strict(jax.value_and_grad(head_loss, (0, 1)), head, x)
    tx = to_torch(np.asarray(x)).requires_grad_()
    scale, w = model.final_norm.scale, model.head()
    tl = TM._chunked_ce(tc, TM.L.norm(scale, tx, tc.norm), w,
                        torch.from_numpy(batch["labels"]))
    gs, gw, gx = torch.autograd.grad(tl, (scale, w, tx))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _check_grads({"final_norm.scale": gs, "lm_head.w": gw, "x": gx},
                 {"final_norm.scale": jgh["final_norm"]["scale"],
                  "lm_head.w": jgh["lm_head"]["w"], "x": jgx})


@pytest.mark.parametrize("moments", ["fp32", "int8"])
@pytest.mark.parametrize("clip", [1e9, 1e-3])
def test_apply_updates_matches_reference(moments, clip):
    """Two AdamW steps on reduced starcoder2 (two repeats of its block:
    the converters' stacked layout), the second from the reference's
    state after the first, carried across by ``opt_state_from_jax``.
    Without clipping the parameters and moments are bit for bit the
    reference's.  The global norm sums squares over every leaf (1.3e5
    elements in the largest) in another order: within 1e-5.  With
    clipping it enters every element, so the moments agree within 1e-5
    relative (int8 moments within one quantization level) and the
    parameters within one of their ulps (of the step's
    size where the step cancels the value)."""
    jc, tc, params, model = _setup("starcoder2-15b", n_layers=2)
    jcfg = JA.AdamWConfig(lr=1e-2, moments_dtype=moments, grad_clip=clip)
    tcfg = TA.AdamWConfig(lr=1e-2, moments_dtype=moments, grad_clip=clip)
    rng = np.random.default_rng(3)

    def grads_like(p):
        return jnp.asarray(rng.normal(size=p.shape), p.dtype)

    with jax.disable_jit():
        opt = JA.init_opt_state(params, jcfg)
        g1 = jax.tree.map(grads_like, params)
        params, opt, _ = JA.apply_updates(params, g1, opt, jcfg,
                                          jnp.float32(0.5))
        model = params_from_jax(tc, jax.tree.map(np.asarray, params),
                                device="cpu")
        topt = opt_state_from_jax(tc, opt, model)
        g2 = jax.tree.map(grads_like, params)
        params, opt, jn = JA.apply_updates(params, g2, opt, jcfg,
                                           jnp.float32(0.7))
    names = [n for n, _ in model.named_parameters()]
    tg = {n: to_torch(v) for n, v in _as_port(tc, g2, names).items()}
    _, topt, tn = TA.apply_updates(model, tg, topt, tcfg,
                                   torch.tensor(0.7))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
    assert int(topt["step"]) == int(opt["step"]) == 2
    want_p = _as_port(tc, params, names)
    want_mu = _by_port_name(tc, jax.tree.map(np.asarray, opt["mu"]), names,
                            lambda t: isinstance(t, dict) and set(t) == {
                                "m", "v"})
    exact = clip > 1
    for name, p in model.named_parameters():
        w = to_torch(want_p[name])
        if exact:
            assert torch.equal(p.detach(), w), name
        else:
            # one ulp of the value, or of the step (lr) where the step
            # cancels the value
            ulp = 2.0 ** -7 if p.dtype == torch.bfloat16 else 2.0 ** -23
            torch.testing.assert_close(p.detach().float(), w.float(),
                                       rtol=ulp, atol=ulp * tcfg.lr)
        for mom in ("m", "v"):
            got, want = topt["mu"][name][mom], want_mu[name][mom]
            if moments == "int8":
                # a value on a rounding boundary may take the next level
                q, wq = got["q"].int(), to_torch(want["q"]).int()
                assert int((q - wq).abs().max()) <= (0 if exact else 1)
                got, want = got["scale"], to_torch(want["scale"])
            else:
                want = to_torch(want)
            if exact:
                assert torch.equal(got, want), (name, mom)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5,
                                           atol=1e-5 * float(
                                               want.abs().max()))


def test_warmup_cosine_matches_reference():
    """Bit for bit through the warmup and past the end of the decay; in
    the cosine part within one float32 ulp of the cosine (6e-8): the two
    libraries' float32 cos differ in the last bit for a few percent of
    inputs (each also misses the correctly rounded value on some), and
    ``1 + cos`` near the end of the decay keeps that absolute error."""
    steps = np.arange(0, 12000, 7).astype(np.int32)
    with jax.disable_jit():
        want = np.asarray(JS.warmup_cosine(jnp.asarray(steps)))
    got = TS.warmup_cosine(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    flat = (steps <= 200) | (steps >= 10000)
    assert np.array_equal(got[flat], want[flat])
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -24)
    assert float(TS.warmup_cosine(98)) == float(want[steps == 98][0])


def test_compression_matches_reference():
    """Per-tensor int8 compression (round half to even on both sides) and
    three rounds of error feedback, bit for bit."""
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(64, 33)).astype(np.float32) * 1e-3,
         "b": rng.normal(size=(7,)).astype(np.float32)}
    g["b"][:3] = [0.5, 1.5, -2.5]       # ties: even results
    with jax.disable_jit():
        q, s = JC.compress_int8(jnp.asarray(g["b"]))
    tq, ts = TC.compress_int8(torch.from_numpy(g["b"]))
    assert np.array_equal(np.asarray(q), tq.numpy())
    assert np.asarray(s) == ts.numpy() and ts.dtype == torch.float32
    jerr = {k: jnp.zeros(v.shape, jnp.float32) for k, v in g.items()}
    terr = TC.init_error_state({k: torch.from_numpy(v) for k, v in g.items()})
    for _ in range(3):
        with jax.disable_jit():
            jcomp, jerr = JC.ef_compress_tree(
                {k: jnp.asarray(v) for k, v in g.items()}, jerr)
        tcomp, terr = TC.ef_compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, terr)
        for k in g:
            assert np.array_equal(np.asarray(jcomp[k][0]),
                                  tcomp[k][0].numpy())
            assert np.asarray(jcomp[k][1]) == tcomp[k][1].numpy()
            assert np.array_equal(np.asarray(jerr[k]), terr[k].numpy())
    back = TC.decompress_int8(tq, ts)
    assert back.dtype == torch.float32


def test_microbatches_accumulate_in_float32():
    """``microbatches=2``: the loss and the gradients are the float32 sums
    of the two halves' (taken as ``microbatches=1`` takes them), halved,
    bit for bit; and they agree with one pass over the whole batch within
    the loss's float32 rounding and the bf16 gradients' tolerance."""
    _, tc, _, model = _setup("mamba2-780m")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc, B=4, S=32).items()}
    one = make_grads_fn(tc, microbatches=1)
    loss2, g2 = make_grads_fn(tc, microbatches=2)(model, batch)
    halves = [one(model, {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
              for i in range(2)]
    assert torch.equal(loss2, (torch.zeros(()) + halves[0][0]
                               + halves[1][0]) * 0.5)
    for name, g in g2.items():
        assert g.dtype == torch.float32
        want = (torch.zeros(g.shape) + halves[0][1][name]
                + halves[1][1][name]) * 0.5
        assert torch.equal(g, want), name
    loss1, g1 = one(model, batch)
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-6)
    _check_grads(g2, {n: g.float().numpy() for n, g in g1.items()})
