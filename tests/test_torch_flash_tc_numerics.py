"""PyTorch port, the arithmetic of the bf16 tensor-core flash kernels on
the CPU.  The CUDA kernels (``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``, bf16 paths) run only on the card; here a
plain emulation of where they round is held against the JAX package's
``repro.kernels.ref.flash_attention_ref`` and its ``jax.vjp``, with the
card tests' limits, to show that the design's rounding fits them.

Where the kernels round (everything else is float32), which is where the
reference rounds: bf16 inputs; q k^T as fp32 sums of exact products
(wgmma), rounded to bf16 as the reference's bf16 einsum rounds it; the
forward's softmax in two passes over 64-key tiles, the first for the row
max and sum (online, in log2 units), the second for the weights,
normalised (times 1 / l) and then rounded to bf16 before W V; the output
rounded to bf16; the backward's P recomputed from the bf16 scores and the
forward's row log-sum-exp and rounded to bf16 before P^T dO, dS rounded
to bf16 before dS^T Q and dS K, dq summed in fp32 and rounded once.

The reference is compiled with XLA's ``xla_allow_excess_precision`` off
(see tests/test_torch_lm_serve.py)."""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as R  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402

_STRICT = {"xla_allow_excess_precision": False}
_TILE = 64          # keys per tile of the forward's two passes
_MASK = -1e30       # a hidden score
_LOG2E = 1.4426950408889634
TOL = 2e-2          # tests/test_torch_gpu.py's bf16 limits


def _reference(args, cot, causal):
    """The reference's output and ``jax.vjp`` gradients, compiled
    strictly."""
    def run(args, cot):
        out, pull = jax.vjp(functools.partial(R.flash_attention_ref,
                                              causal=causal), *args)
        return out, pull(cot)
    return jax.jit(run).lower(args, cot).compile(
        compiler_options=_STRICT)(args, cot)


def _masks(S, T, causal):
    """(visible (S, T), sees-no-key (S,)) under the kernels' rule: key j
    is visible to query i iff j <= i + (T - S)."""
    if not causal:
        return torch.ones((S, T), dtype=torch.bool), \
            torch.zeros((S,), dtype=torch.bool)
    vis = torch.arange(T)[None, :] <= torch.arange(S)[:, None] + (T - S)
    return vis, ~vis.any(dim=1)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _scores(q, k):
    """q k^T of bf16 values, rounded to bf16, scaled by 1 / sqrt(D)."""
    return _bf16(q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])


def tc_forward(q, k, v, causal):
    """The bf16 forward kernel's arithmetic: (out as bf16, lse)."""
    q, k, v = q.float(), k.float(), v.float()
    S, T = q.shape[-2], k.shape[-2]
    vis, _ = _masks(S, T, causal)
    s = torch.where(vis, _scores(q, k), torch.full((S, T), _MASK)) * _LOG2E
    m = torch.full(s.shape[:-1], _MASK * _LOG2E)
    l = torch.zeros(s.shape[:-1])
    for k0 in range(0, T, _TILE):                 # pass 1: max and sum
        t = s[..., k0:k0 + _TILE]
        m_new = torch.maximum(m, t.amax(dim=-1))
        l = (l * torch.exp2(m - m_new)
             + torch.exp2(t - m_new[..., None]).sum(dim=-1))
        m = m_new
    out, inv_l = torch.zeros(q.shape), (1 / l)[..., None]
    for k0 in range(0, T, _TILE):                 # pass 2: the weights
        w = torch.exp2(s[..., k0:k0 + _TILE] - m[..., None]) * inv_l
        out = out + _bf16(w) @ v[..., k0:k0 + _TILE, :]
    return out.to(torch.bfloat16), m / _LOG2E + torch.log(l)


def tc_backward(q, k, v, out, lse, dout, causal):
    """The bf16 backward kernel's arithmetic: (dq, dk, dv) as bf16."""
    q, k, v, out, dout = (t.float() for t in (q, k, v, out, dout))
    S, T, D = q.shape[-2], k.shape[-2], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    vis, no_key = _masks(S, T, causal)
    s = _scores(q, k)
    p = torch.where(vis, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    p = torch.where(no_key[:, None], torch.full_like(p, 1.0 / T), p)
    dp = dout @ v.transpose(-1, -2)
    delta = (dout * out).sum(dim=-1, keepdim=True)
    ds = torch.where(vis & ~no_key[:, None], p * (dp - delta),
                     torch.zeros_like(p))
    dv = _bf16(p).transpose(-1, -2) @ dout
    dk = _bf16(ds).transpose(-1, -2) @ q * scale
    dq = _bf16(ds) @ k * scale
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


def _rel_max(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("S,T", [(128, 128), (96, 160), (160, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_tc_rounding_within_card_limits(D, S, T, causal):
    """The emulated kernels against the reference: the forward within
    2e-2 absolute and relative, each gradient within 2e-2 of its largest
    magnitude.  (160, 96) under ``causal`` has 64 rows that see no key."""
    rng = np.random.default_rng(D + S + 3 * T + causal)
    shapes = ((1, 2, S, D), (1, 2, T, D), (1, 2, T, D), (1, 2, S, D))
    js = [jnp.asarray(rng.normal(size=sh), jnp.bfloat16) for sh in shapes]
    q, k, v, dout = (to_torch(np.asarray(j)) for j in js)
    want_out, want_grads = _reference(tuple(js[:3]), js[3], causal)

    out, lse = tc_forward(q, k, v, causal)
    want = np.asarray(want_out, np.float32)
    err = np.abs(out.float().numpy() - want)
    assert (err <= TOL + TOL * np.abs(want)).all(), float(err.max())

    grads = tc_backward(q, k, v, out, lse, dout, causal)
    for name, g, w in zip("qkv", grads, want_grads):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel_max(g, w) <= TOL, (name, _rel_max(g, w))
