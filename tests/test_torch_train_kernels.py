"""PyTorch port, the training path's kernels on the CPU: the gradients of
the plain versions of ``ssm_scan`` and ``flash_attention`` (what the
backward kernels are held to on the card) against ``jax.vjp`` of the
reference's jnp functions, and ``horner`` (the last Pallas kernel's
entry point) against ``horner_pallas`` in interpret mode.

The reference is compiled with XLA's ``xla_allow_excess_precision`` off
(see tests/test_torch_lm_serve.py).  Gradients are compared by their
largest error over the gradient's largest magnitude: a gradient is a sum
of many products taken in other orders on the two sides."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as R  # noqa: E402
from repro.kernels.horner import horner_pallas  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402

_STRICT = {"xla_allow_excess_precision": False}


def _vjp(fn, args, cot):
    """``jax.vjp`` of ``fn`` at ``args`` for ``cot``, compiled strictly."""
    def pullback(args, cot):
        return jax.vjp(fn, *args)[1](cot)
    return jax.jit(pullback).lower(args, cot).compile(
        compiler_options=_STRICT)(args, cot)


def _pair(a, dtype):
    j = jnp.asarray(a, dtype)
    return j, to_torch(np.asarray(j))


def _rel_max(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ssm_inputs(rng, B, S, H, P, N, dtype):
    raw = [rng.normal(size=(B, S, H, P)), rng.uniform(0.01, 0.2, (B, S, H)),
           rng.uniform(-1, 1, (H,)), rng.normal(size=(B, S, N)),
           rng.normal(size=(B, S, N)), rng.normal(size=(B, S, H, P))]
    types = [dtype, jnp.float32, jnp.float32, dtype, dtype, dtype]
    pairs = [_pair(a, t) for a, t in zip(raw, types)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# float32: the forward's tolerance (tests/test_kernels.py); bf16: the
# gradients round to bf16 on both sides after float32 sums in other orders
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-4),
                                       (jnp.bfloat16, 2e-2)])
def test_ssm_scan_grads_match_reference(dtype, tol):
    (jx, jdt, jal, jb, jc, jdy), tx = _ssm_inputs(
        np.random.default_rng(0), 2, 128, 3, 16, 8, dtype)
    want = _vjp(functools.partial(JL.ssd_scan_ref, chunk=32),
                (jx, jdt, jal, jb, jc), jdy)
    before = dict(K.launch_counts)
    got = K.ssm_scan_bwd(*tx, chunk=32)
    assert K.launch_counts == before               # CPU: the plain version
    for name, g, w in zip(("x", "dt", "a_log", "b", "c"), got, want):
        assert g.dtype == to_torch(np.asarray(w)).dtype, name
        assert _rel_max(g, w) <= tol, (name, _rel_max(g, w))


def test_ssm_scan_grads_chunk_invariant():
    """The gradients do not depend on the chunk length, as the forward
    does not (test_ssm_scan_chunk_invariance)."""
    _, tx = _ssm_inputs(np.random.default_rng(1), 1, 128, 2, 16, 8,
                        jnp.float32)
    g32 = K.ssm_scan_bwd(*tx, chunk=32)
    g64 = K.ssm_scan_bwd(*tx, chunk=64)
    for name, a, b in zip(("x", "dt", "a_log", "b", "c"), g32, g64):
        assert _rel_max(a, b) <= 1e-4, name


def test_ssm_scan_autograd_entry_point_is_the_plain_grad():
    """On CPU tensors the differentiable entry point takes autograd
    through the plain version: its gradients are ``ssm_scan_bwd``'s."""
    _, (x, dt, al, b, c, dy) = _ssm_inputs(np.random.default_rng(2), 1, 64,
                                           2, 16, 8, jnp.float32)
    ins = [t.clone().requires_grad_() for t in (x, dt, al, b, c)]
    got = torch.autograd.grad(K.ssm_scan(*ins, chunk=32), ins, dy)
    want = K.ssm_scan_bwd(x, dt, al, b, c, dy, chunk=32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("S,T,causal", [(128, 128, True), (64, 192, True),
                                        (96, 96, False)])
@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, 2e-2)])
def test_flash_attention_grads_match_reference(S, T, causal, dtype, tol):
    """Causal self-attention, cross lengths (T > S: the causal diagonal
    moves by T - S) and no mask; float32 to a few ulps of the largest
    gradient, bf16 within the forward's 2e-2."""
    rng = np.random.default_rng(S + T)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(rng.normal(size=shape), dtype) for shape in
        ((1, 2, S, 32), (1, 2, T, 32), (1, 2, T, 32), (1, 2, S, 32)))
    want = _vjp(functools.partial(R.flash_attention_ref, causal=causal),
                (jq, jk, jv), jdo)
    out = K.flash_attention(tq, tk, tv, causal=causal)
    got = K.flash_attention_bwd(tq, tk, tv, out, None, tdo, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == tq.dtype
        assert _rel_max(g, w) <= tol, (name, _rel_max(g, w))


def test_gqa_attention_grads_match_reference():
    """The model's causal attention with 2 query heads per kv head:
    ``repeat_interleave`` before the kernel, whose autograd sums each
    group's gradients back onto its kv head, against ``jax.vjp`` of the
    reference's ``_sdpa``, in float32."""
    rng = np.random.default_rng(7)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=s), jnp.float32)
                                    for s in ((2, 64, 4, 16), (2, 64, 2, 16),
                                              (2, 64, 2, 16)))
    jdo, tdo = _pair(rng.normal(size=(2, 64, 64)), jnp.float32)
    want = _vjp(functools.partial(JL._sdpa, causal=True), (jq, jk, jv), jdo)
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    got = torch.autograd.grad(TL._flash(*ins, causal=True), ins, tdo)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        assert _rel_max(g, w) <= 1e-5, (name, _rel_max(g, w))


def _horner_tol(dtype):   # tests/test_kernels.py::test_horner's
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [64, 1000, 8192])
@pytest.mark.parametrize("degree", [1, 3, 8])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_horner_matches_pallas(n, degree, dtype):
    """The cases of tests/test_kernels.py::test_horner, with its
    tolerances, against the Pallas kernel in interpret mode (what the
    reference's ``ops.horner`` runs off the TPU)."""
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(n,)), dtype)
    jcf, tcf = _pair(rng.normal(size=(degree + 1,)), jnp.float32)
    before = dict(K.launch_counts)
    got = K.horner(tx, tcf)
    assert K.launch_counts == before
    want = horner_pallas(jx, jcf, interpret=True)
    assert got.shape == (n,) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **_horner_tol(dtype))


def test_horner_bf16_output_dtype_quirk():
    """For a bf16 x the reference's jnp oracle ``ref.horner_ref`` returns
    float32 (``zeros_like(x) + coeffs[-1]`` promotes: the coefficient is a
    float32 array, not a weak scalar), while the Pallas kernel, and so
    ``ops.horner``, returns bf16.  The port follows the entry point: x's
    dtype out, the float32 result rounded once."""
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(1000,)), jnp.bfloat16)
    jcf, tcf = _pair(rng.normal(size=(9,)), jnp.float32)
    oracle = R.horner_ref(jx, jcf)
    pallas = horner_pallas(jx, jcf, interpret=True)
    assert oracle.dtype == jnp.float32 and pallas.dtype == jnp.bfloat16
    # the two differ by the bf16 rounding of values up to a few thousand
    assert np.abs(np.asarray(oracle) - np.asarray(pallas, np.float32)).max() \
        > 1.0
    got = K.horner(tx, tcf)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, to_torch(np.asarray(oracle)).to(torch.bfloat16))


def test_horner_checks_inputs():
    x = torch.zeros((8,))
    with pytest.raises(ValueError):
        K.horner(x[None], torch.zeros((3,)))
    with pytest.raises(ValueError):
        K.horner(x, torch.zeros((0,)))
    with pytest.raises(TypeError):
        K.horner(x.double(), torch.zeros((3,)))
    with pytest.raises(TypeError):
        K.horner(x, torch.zeros((3,), dtype=torch.float64))
    with pytest.raises(ValueError):
        K.horner(x, torch.zeros((3,)).to("meta"))
