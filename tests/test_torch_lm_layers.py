"""PyTorch port, LM layers: each layer of ``repro_torch.models.layers``
against its JAX counterpart on ``reduced()`` configs, in float32 (params
and inputs cast on both sides, where the point is the algorithm), plus the
traps of the translation: the converter's bf16 bit copy, MoE dispatch past
capacity and tie order, and the tanh GELU.  (The converter's block layout,
``blocks[j][r]`` -> layer ``r * len(pattern) + j``, is checked on every
weight by tests/test_torch_lm_serve.py::test_weights_copy_bitwise.)"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_config as jax_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.numerics import gelu_tanh  # noqa: E402

# float32 on both sides: the sums run in other orders (einsum paths,
# cumsum, XLA's own exp), so agreement is to a few float32 ulps of the
# values' scale, not bitwise
TOL = dict(rtol=1e-5, atol=1e-5)
SSM_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py's ssm_scan


def _cfgs(arch):
    return jax_config(arch).reduced(), get_config(arch).reduced()


def _jit(fn, *static):
    """The JAX side compiled once per call signature (its eager op-by-op
    dispatch compiles every primitive on first use and is slower here)."""
    return jax.jit(fn, static_argnums=static)


def _f32(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


def _load(module, tree):
    """Set every parameter of ``module`` to the float32 leaf of ``tree``
    at the same path."""
    for name, p in module.named_parameters():
        leaf = tree
        for part in name.split("."):
            leaf = leaf[part]
        p.data = to_torch(np.asarray(leaf, np.float32))
    return module


def _x(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(jax_out, torch_out, tol=TOL):
    np.testing.assert_allclose(torch_out.detach().numpy(),
                               np.asarray(jax_out), **tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(rng, kind):
    jx, tx = _x(rng, 2, 8, 64)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _close(JL.norm({"scale": jnp.asarray(scale)}, jx, kind),
           TL.norm(torch.from_numpy(scale), tx, kind))


def test_rope(rng):
    jx, tx = _x(rng, 2, 12, 4, 16)
    pos = rng.integers(0, 500, (2, 12))
    _close(JL.rope(jx, jnp.asarray(pos), 1e6),
           TL.rope(tx, torch.from_numpy(pos), 1e6))


@pytest.mark.parametrize("arch,kv", [("jamba-v0.1-52b", 2),
                                     ("granite-20b", 1),
                                     ("qwen1.5-32b", 4)])
def test_attention_prefill_and_decode(rng, arch, kv):
    """GQA with 2 query heads per kv head (where ``repeat`` and
    ``repeat_interleave`` differ), MQA (granite) and MHA with qkv bias
    (qwen): a prompt without a cache, the same prompt into an empty
    cache, then one decode step against it."""
    jc, tc = (dataclasses.replace(c, n_kv_heads=kv) for c in _cfgs(arch))
    p = _f32(JL.init_attention(jax.random.PRNGKey(0), jc))
    if jc.qkv_bias:
        p = jax.tree.map(lambda a: a + 0.1, p)
    mod = _load(TL.Attention(tc, device="cpu", generator=None), p)
    B, S, T = 2, 16, 24
    jx, tx = _x(rng, B, S, jc.d_model)
    jpos = jnp.broadcast_to(jnp.arange(S), (B, S))
    tpos = torch.arange(S).expand(B, S)
    attention = _jit(JL.attention, 1)
    _close(attention(p, jc, jx, jpos)[0], mod(tx, tpos)[0])

    shape = (B, T, jc.n_kv_heads, jc.head_dim)
    jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
              "len": jnp.zeros((B,), jnp.int32)}
    tcache = {"k": torch.zeros(shape), "v": torch.zeros(shape),
              "len": torch.zeros((B,), dtype=torch.int32)}
    jy, jcache = attention(p, jc, jx, jpos, jcache)
    ty, tcache = mod(tx, tpos, tcache)
    _close(jy, ty)
    for key in ("k", "v", "len"):
        _close(jcache[key], tcache[key])
    jx1, tx1 = _x(rng, B, 1, jc.d_model)
    pos1 = np.array([S, S], np.int32)
    jy, jcache = attention(p, jc, jx1, jnp.asarray(pos1)[:, None], jcache)
    ty, tcache = mod(tx1, torch.from_numpy(pos1)[:, None], tcache)
    _close(jy, ty)
    _close(jcache["k"], tcache["k"])
    assert tcache["len"].tolist() == [S + 1] * B


def _strict(fn):
    """``fn`` compiled with every bf16 primitive rounding (as each PyTorch
    op on a bf16 tensor does; tests/test_torch_lm_serve.py), once per
    input signature."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), str(jnp.asarray(a).dtype))
                           for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)
    return call


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", dict(rtol=2e-2,
                                                         atol=2e-2))])
@pytest.mark.parametrize("step", [3, 1024])
def test_attention_multi_token_step_on_a_filled_cache(rng, dtype, tol, step):
    """A prefill of 24 tokens into an empty cache, then a step of
    ``step`` tokens against it (positions 24 on), outputs and caches
    against the reference's ``attention``.  Weights come over through
    ``models/convert.py``.  A step of 3 tokens takes ``_sdpa_direct``; one
    of 1,024 (above ``_Q_CHUNK``, a multiple of it) takes the reference's
    ``_sdpa_blocked`` and the port's flash path over the first 1,048
    cache rows."""
    jc, tc = (dataclasses.replace(c, n_kv_heads=2)
              for c in _cfgs("starcoder2-15b"))
    jdt = jnp.dtype(dtype)
    p = jax.tree.map(lambda a: jnp.asarray(a, jdt),
                     JL.init_attention(jax.random.PRNGKey(1), jc))
    mod = TL.Attention(tc, device="cpu", generator=None)
    for name, prm in mod.named_parameters():
        leaf = p
        for part in name.split("."):
            leaf = leaf[part]
        prm.data = to_torch(np.asarray(leaf))
    B, S0, T = 2, 24, 24 + step + 8
    attention = _strict(lambda p, x, pos, cache:
                        JL.attention(p, jc, x, pos, cache))
    shape = (B, T, jc.n_kv_heads, jc.head_dim)
    jcache = {"k": jnp.zeros(shape, jdt), "v": jnp.zeros(shape, jdt),
              "len": jnp.zeros((B,), jnp.int32)}
    tcache = {k: to_torch(np.asarray(v)) for k, v in jcache.items()}
    for s0, n in ((0, S0), (S0, step)):
        xs = rng.normal(size=(B, n, jc.d_model)).astype(np.float32)
        jx = jnp.asarray(xs, jdt)
        pos = np.broadcast_to(np.arange(s0, s0 + n, dtype=np.int32), (B, n))
        jy, jcache = attention(p, jx, jnp.asarray(pos), jcache)
        ty, tcache = mod(to_torch(np.asarray(jx)),
                         torch.from_numpy(pos.copy()), tcache)
        assert ty.dtype == getattr(torch, dtype)
        _close(jnp.asarray(jy, jnp.float32), ty.float(), tol)
        for key in ("k", "v"):
            _close(jnp.asarray(jcache[key], jnp.float32),
                   tcache[key].float(), tol)
        assert tcache["len"].tolist() == [s0 + n] * B
        assert np.array_equal(np.asarray(jcache["len"]), tcache["len"])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "starcoder2-15b"])
def test_ffn(rng, arch):
    """silu-gated (jamba) and gelu (starcoder2) FFNs."""
    jc, tc = _cfgs(arch)
    p = _f32(JL.init_ffn(jax.random.PRNGKey(1), jc))
    mod = _load(TL.FFN(tc, device="cpu", generator=None), p)
    jx, tx = _x(rng, 2, 8, jc.d_model)
    _close(_jit(JL.ffn, 1)(p, jc, jx), mod(tx))


def _moe_pair(jc, tc, key=2):
    p = _f32(JL.init_moe(jax.random.PRNGKey(key), jc))
    return p, _load(TL.MoE(tc, device="cpu", generator=None), p)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_routing_and_output(rng, arch):
    """Top-k routing picks the same experts, and the capacity dispatch
    gives the same output (llama4: a shared expert and top-1)."""
    jc, tc = _cfgs(arch)
    p, mod = _moe_pair(jc, tc)
    jx, tx = _x(rng, 2, 32, jc.d_model)
    _close(_jit(JL.moe, 1)(p, jc, jx), mod(tx))
    logits = np.asarray(JL.dense(p["router"], jx))
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                            jc.top_k)
    seen = {}
    mod.router.register_forward_hook(lambda m, i, o: seen.setdefault("o", o))
    mod(tx)
    probs = torch.softmax(seen["o"].float(), -1)
    tidx = torch.sort(probs, dim=-1, descending=True,
                      stable=True)[1][..., :jc.top_k]
    assert np.array_equal(np.asarray(jidx), tidx.numpy())


def test_moe_over_capacity_and_tie_order():
    """A zero router makes every expert tie: both sides then pick experts
    0..k-1 (jax.lax.top_k's index order), every token queues for the
    same k experts, and tokens past the capacity get all-zero dispatch
    rows (jax.nn.one_hot of a position >= cap), so their output is 0."""
    jc, tc = _cfgs("jamba-v0.1-52b")
    p, mod = _moe_pair(jc, tc)
    p["router"]["w"] = jnp.zeros_like(p["router"]["w"])
    mod.router.w.data.zero_()
    S = 32
    cap = max(int(S * jc.top_k / jc.n_experts * 1.25), 4)
    x = np.random.default_rng(3).normal(size=(1, S, jc.d_model)).astype(
        np.float32)
    jy = np.asarray(_jit(JL.moe, 1)(p, jc, jnp.asarray(x)))
    with torch.no_grad():   # the parameters are trainable
        ty = mod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ty, jy, **TOL)
    assert cap < S
    assert np.all(ty[0, cap:] == 0) and np.all(np.abs(ty[0, :cap]).sum(-1)
                                               > 0)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-780m"])
def test_mamba2_prefill_and_decode(rng, arch):
    jc, tc = _cfgs(arch)
    p = _f32(JL.init_mamba2(jax.random.PRNGKey(4), jc))
    p["dt_bias"] = p["dt_bias"] + jnp.asarray(
        rng.normal(size=p["dt_bias"].shape), jnp.float32)
    mod = _load(TL.Mamba2(tc, device="cpu", generator=None), p)
    B, S = 2, 128
    jx, tx = _x(rng, B, S, jc.d_model)
    conv_shape = (B, jc.ssm_conv_width, jc.d_inner + 2 * jc.ssm_state)
    ssm_shape = (B, jc.ssm_heads, jc.ssm_head_dim, jc.ssm_state)
    mamba2 = _jit(JL.mamba2, 1)
    jy, jcache = mamba2(p, jc, jx, {"conv": jnp.zeros(conv_shape),
                                    "ssm": jnp.zeros(ssm_shape)})
    ty, tcache = mod(tx, {"conv": torch.zeros(conv_shape),
                          "ssm": torch.ones(ssm_shape)})
    _close(jy, ty, SSM_TOL)
    _close(jcache["conv"], tcache["conv"])
    assert not tcache["ssm"].any()   # the reference leaves a zero state
    # one recurrent step from a non-zero state
    conv = rng.normal(size=conv_shape).astype(np.float32)
    ssm = rng.normal(size=ssm_shape).astype(np.float32)
    jx1, tx1 = _x(rng, B, 1, jc.d_model)
    jy, jcache = mamba2(p, jc, jx1, {"conv": jnp.asarray(conv),
                                     "ssm": jnp.asarray(ssm)})
    ty, tcache = mod(tx1, {"conv": torch.from_numpy(conv.copy()),
                           "ssm": torch.from_numpy(ssm.copy())})
    _close(jy, ty)
    _close(jcache["conv"], tcache["conv"])
    _close(jcache["ssm"], tcache["ssm"])


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; the port's matches
    it bit for bit in bf16 and differs from the exact (erf) form."""
    x = np.linspace(-6, 6, 4097).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = to_torch(np.asarray(jx))
    got = gelu_tanh(tx).float().numpy()
    assert np.array_equal(got, np.asarray(jax.nn.gelu(jx), np.float32))
    exact = torch.nn.functional.gelu(tx.float()).numpy()
    assert np.abs(got - exact).max() > 1e-3


def test_to_torch_copies_bf16_bits():
    """ml_dtypes' bfloat16 (which torch.from_numpy refuses) is copied
    through its uint16 bits: signed zeros, subnormals, inf and NaN
    included."""
    bits = np.array([0x0000, 0x8000, 0x0001, 0x807f, 0x3f80, 0x7f80,
                     0xff80, 0x7fc1, 0x4049, 0xc2f7], np.uint16)
    a = np.asarray(jnp.asarray(bits).view(jnp.bfloat16))
    assert a.dtype.name == "bfloat16"
    t = to_torch(a)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)

