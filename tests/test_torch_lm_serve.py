"""PyTorch port, the LM serving path in bf16 (the model's own dtype)
against the JAX package on ``reduced()`` configs: the weights carried
across bit for bit, prefill ``forward`` and teacher-forced ``decode_step``
logits, and a ``ServeEngine`` run, within 2e-2 (the tolerance of
test_models_smoke.py::test_decode_matches_prefill_logits).

The reference is compiled with XLA's ``xla_allow_excess_precision`` off.
With it on (the default) XLA may keep a fused chain of bf16 primitives in
float32, so where the jitted reference rounds depends on its fusion
decisions; off, every bf16 primitive rounds, as the program is written
and as each PyTorch op on a bf16 tensor does, and the compiled reference
equals its op-by-op evaluation (``jax.disable_jit``) bit for bit.

Reduced Jamba's whole-prompt forward is compared layer by layer: its
logits move by more than 2e-2 when one input bit flips (pinned below), so
two implementations that round one float32 exp differently cannot agree
end to end at that tolerance."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.models.registry import get_config as jax_config  # noqa: E402
from repro.serve import step as JS  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeEngine as JEngine  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.convert import layer_index  # noqa: E402
from repro_torch.models.convert import params_from_jax, to_torch  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)
_STRICT = {"xla_allow_excess_precision": False}
# (arch, n_layers or None for reduced()'s own depth)
JAMBA16 = ("jamba-v0.1-52b", 16)
DENSE_AND_SSM = [("starcoder2-15b", None), ("qwen1.5-32b", None),
                 ("mamba2-780m", None)]


def strict(fn):
    """``fn`` compiled with every bf16 primitive rounding, once per input
    signature."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(a), str(jnp.asarray(a).dtype))
                           for a in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=_STRICT)
        return compiled[key](*args)

    return call


@functools.lru_cache(maxsize=None)
def _setup(arch, n_layers):
    jc, tc = jax_config(arch).reduced(), get_config(arch).reduced()
    if n_layers:
        jc = dataclasses.replace(jc, n_layers=n_layers)
        tc = dataclasses.replace(tc, n_layers=n_layers)
    params = jax.jit(JM.init_params, static_argnums=0)(
        jc, jax.random.PRNGKey(0))
    model = params_from_jax(tc, jax.tree.map(np.asarray, params),
                            device="cpu")
    return jc, tc, params, model


def _tokens(cfg, B=2, S=64):
    return np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _logits(a, cfg):
    a = a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    return a[..., :cfg.vocab]


@pytest.mark.parametrize("arch", [JAMBA16] + DENSE_AND_SSM,
                         ids=lambda a: a[0])
def test_weights_copy_bitwise(arch):
    """Every leaf of the reference's tree lands bit for bit in the
    parameter of the same name; the stacked blocks land by the layout
    ``blocks[j][r]`` -> layer ``r * len(pattern) + j`` (Jamba at 16
    layers has the repeat axis at 2)."""
    jc, tc, params, model = _setup(*arch)
    tree = jax.tree.map(np.asarray, params)
    n_pat = len(jc.pattern())
    names = dict(model.named_parameters())
    top = {k: v for k, v in tree.items() if k != "blocks"}
    assert len(names) == len(jax.tree.leaves(top)) \
        + len(jax.tree.leaves(tree["blocks"])) * jc.n_repeats
    for name, p in names.items():
        parts = name.split(".")
        if parts[0] == "layers":
            r, j = divmod(int(parts[1]), n_pat)
            assert layer_index(tc, j, r) == int(parts[1])
            leaf, parts = tree["blocks"][j], parts[2:]
        else:
            leaf, r = tree, None
        for part in parts:
            leaf = leaf[part]
        want = to_torch(leaf if r is None else leaf[r])
        assert want.dtype == p.dtype and want.shape == p.shape, name
        as_int = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        assert torch.equal(want.view(as_int[p.dtype]),
                           p.view(as_int[p.dtype])), name
    if jc.n_repeats > 1:   # the repeats differ, so a swapped layout shows
        first, second = model.layers[0], model.layers[n_pat]
        assert not torch.equal(first.mamba.in_proj.w, second.mamba.in_proj.w)


@pytest.mark.parametrize("arch", DENSE_AND_SSM, ids=lambda a: a[0])
def test_forward_matches_reference(arch):
    """GQA and gelu (starcoder2), qkv bias (qwen), tied embeddings and a
    padded vocab (mamba2)."""
    jc, tc, params, model = _setup(*arch)
    toks = _tokens(jc)
    want = strict(functools.partial(JM.forward, jc))(params,
                                                     jnp.asarray(toks))
    with torch.no_grad():
        got = TM.forward(model, torch.from_numpy(toks))
    np.testing.assert_allclose(_logits(got, tc), _logits(want, jc), **TOL)
    pad = got[..., jc.vocab:].float().numpy()
    assert np.array_equal(pad, np.asarray(want, np.float32)[..., jc.vocab:])
    assert (pad < -1e29).all()


def test_jamba_forward_layer_by_layer():
    """Reduced Jamba with the repeat axis at 2: every port layer, fed the
    reference's input to that layer, gives the reference's output, and
    the final norm and head give its logits."""
    jc, tc, params, model = _setup(*JAMBA16)
    toks = _tokens(jc)
    B, S = toks.shape
    pattern = jc.pattern()
    layer = {kinds: strict(functools.partial(JM._layer_fwd, jc, *kinds))
             for kinds in set(pattern)}
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    tpos = torch.arange(S).expand(B, S)
    x = params["embed"][jnp.asarray(toks)]
    with torch.no_grad():
        for i, block in enumerate(model.layers):
            r, j = divmod(i, len(pattern))
            p = jax.tree.map(lambda a: a[r], params["blocks"][j])
            y, _ = layer[pattern[j]](p, x, pos, None, None)
            got, _ = block(to_torch(np.asarray(x)), tpos, None)
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(y, np.float32), **TOL,
                                       err_msg=f"layer {i} {pattern[j]}")
            x = y

        def head(p, x):
            x = JM.L.norm(p["final_norm"], x, jc.norm)
            return JM._mask_pad_logits(jc, x @ p["lm_head"]["w"])

        want = strict(head)(params, x)
        tx = TM.L.norm(model.final_norm.scale, to_torch(np.asarray(x)),
                       tc.norm)
        got = TM._mask_pad_logits(tc, TM.L.einsum("bsd,dv->bsv", tx,
                                                  model.head()))
    np.testing.assert_allclose(_logits(got, tc), _logits(want, jc), **TOL)


def test_reference_jamba_forward_moves_under_one_bit():
    """Why Jamba's whole forward is compared layer by layer: flipping the
    last bit of one embedding element moves the reference's own logits by
    more than the 2e-2 tolerance (its top-2 MoE routing turns on bf16
    router logits, and a flipped choice sends a token through other
    experts)."""
    jc, _, params, _ = _setup(*JAMBA16)
    toks = jnp.asarray(_tokens(jc))
    forward = strict(functools.partial(JM.forward, jc))
    base = _logits(forward(params, toks), jc)
    embed = np.asarray(params["embed"]).copy()
    embed.view(np.uint16)[int(toks[0, 0]), 3] ^= 1
    moved = _logits(forward(dict(params, embed=jnp.asarray(embed)), toks),
                    jc)
    assert np.abs(moved - base).max() > 2e-2 + 2e-2 * np.abs(base).max()


@pytest.mark.parametrize("arch", [JAMBA16] + DENSE_AND_SSM,
                         ids=lambda a: a[0])
def test_decode_matches_reference(arch):
    """Teacher-forced one-token decode from empty caches."""
    jc, tc, params, model = _setup(*arch)
    toks = _tokens(jc, S=8)
    B, S = toks.shape
    decode = strict(functools.partial(JM.decode_step, jc))
    jcaches = JM.init_cache(jc, B, S)
    tcaches = TM.init_cache(tc, B, S, "cpu")
    with torch.no_grad():
        for t in range(S):
            want, jcaches = decode(params, jnp.asarray(toks[:, t:t + 1]),
                                   jnp.full((B,), t, jnp.int32), jcaches)
            got, tcaches = TM.decode_step(
                model, torch.from_numpy(toks[:, t:t + 1]),
                torch.full((B,), t, dtype=torch.int32), tcaches)
            np.testing.assert_allclose(_logits(got, tc), _logits(want, jc),
                                       **TOL, err_msg=f"step {t}")


def test_serve_engine_matches_reference():
    """Continuous batching on reduced Jamba: two slots, three requests
    (the third waits for a retired slot), left-padded waves.  The port
    generates the reference's tokens."""
    jc, tc, params, model = _setup("jamba-v0.1-52b", None)
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
    with torch.no_grad():
        got = port.run()
    assert {k: len(v) for k, v in got.items()} == {0: 3, 1: 6, 2: 4}
    assert got == want
