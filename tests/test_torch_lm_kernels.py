"""PyTorch port, the LM kernels' plain versions: ``flash_attention`` and
``ssm_scan`` (taken by the wrappers for CPU tensors) against the Pallas
kernels in interpret mode and the reference oracles, with the shapes and
tolerances of tests/test_kernels.py, and the wrappers' input checks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as RO  # noqa: E402
from repro.kernels import ref as R  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_pallas  # noqa: E402
from repro_torch.kernels import ops as K  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor, bit for bit."""
    j = jnp.asarray(a, dtype)
    return j, to_torch(np.asarray(j))


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == jnp.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(1, 1, 128, 64), (2, 3, 256, 64),
                                   (1, 2, 512, 128)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_and_ref(rng, shape, dtype,
                                                      causal):
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=shape), dtype)
                                    for _ in range(3))
    before = dict(K.launch_counts)
    got = np.asarray(K.flash_attention(tq, tk, tv, causal=causal).float())
    assert K.launch_counts == before          # CPU tensors: no launch
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal,
                                    interpret=True)
    ref = R.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               **_tol(dtype))
    np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                               **_tol(dtype))


def test_flash_attention_cross_lengths(rng):
    jq, tq = _pair(rng.normal(size=(1, 2, 128, 64)), jnp.float32)
    jk, tk = _pair(rng.normal(size=(1, 2, 256, 64)), jnp.float32)
    jv, tv = _pair(rng.normal(size=(1, 2, 256, 64)), jnp.float32)
    got = K.flash_attention(tq, tk, tv, causal=True).numpy()
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(
        R.flash_attention_ref(jq, jk, jv, causal=True)), rtol=2e-5,
        atol=2e-5)


def _ssm_inputs(rng, B, S, H, P, N, dtype):
    x = _pair(rng.normal(size=(B, S, H, P)), dtype)
    dt = _pair(rng.uniform(0.01, 0.2, size=(B, S, H)), jnp.float32)
    al = _pair(rng.uniform(-1, 1, size=(H,)), jnp.float32)
    b = _pair(rng.normal(size=(B, S, N)), dtype)
    c = _pair(rng.normal(size=(B, S, N)), dtype)
    return [p[0] for p in (x, dt, al, b, c)], [p[1] for p in (x, dt, al, b,
                                                               c)]


@pytest.mark.parametrize("shape", [(1, 64, 2, 16, 8), (2, 128, 3, 32, 16),
                                   (1, 256, 4, 64, 32)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_ssm_scan_plain_matches_pallas_and_ref(rng, shape, dtype):
    jx, tx = _ssm_inputs(rng, *shape, dtype)
    before = dict(K.launch_counts)
    got = np.asarray(K.ssm_scan(*tx, chunk=32).float())
    assert K.launch_counts == before
    tol = 5e-2 if dtype == jnp.bfloat16 else 1e-4
    pallas = ssm_scan_pallas(*jx, chunk=32, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(got, np.asarray(R.ssm_scan_ref(
        *jx, chunk=32), np.float32), rtol=tol, atol=tol)


def test_ssm_scan_chunk_invariance(rng):
    _, tx = _ssm_inputs(rng, 1, 128, 2, 16, 8, jnp.float32)
    o32 = K.ssm_scan(*tx, chunk=32).numpy()
    o64 = K.ssm_scan(*tx, chunk=64).numpy()
    np.testing.assert_allclose(o32, o64, rtol=1e-4, atol=1e-4)


def test_ssm_scan_default_chunk_is_the_reference_entry_points(rng):
    """With the chunk omitted, ``ops.ssm_scan`` chunks as the reference's
    entry point (``repro/kernels/ops.py::ssm_scan``, 128 rows) does; S =
    256 tells 128 from 64.  The backward's default is the same chunk."""
    jx, tx = _ssm_inputs(rng, 2, 256, 3, 16, 8, jnp.float32)
    got = K.ssm_scan(*tx).numpy()
    want = np.asarray(RO.ssm_scan(*jx, use_pallas=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.from_numpy(got), K.ssm_scan(*tx, chunk=128))
    assert not torch.equal(torch.from_numpy(got), K.ssm_scan(*tx, chunk=64))
    dy = torch.from_numpy(rng.normal(size=got.shape).astype(np.float32))
    for a, w in zip(K.ssm_scan_bwd(*tx, dy), K.ssm_scan_bwd(*tx, dy,
                                                           chunk=128)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("P", [24, 80, 128])
def test_ssm_scan_pad_and_split_matches_unsplit(rng, P):
    """The bf16 kernels' pad-and-split plan (P in groups of at most 64
    columns zero-padded to 16, 32 or 64; N in groups of at most 128
    states), run on the plain version in float32: y and every gradient
    within 1e-5 of its largest magnitude of the unsplit plain version's,
    and ``_tc_args`` takes these shapes."""
    from repro_torch.kernels import ssm_scan as KS

    N = 160
    _, tx = _ssm_inputs(rng, 1, 128, 2, P, N, jnp.float32)
    dy = torch.from_numpy(rng.normal(size=(1, 128, 2, P))
                          .astype(np.float32))
    pg, ng, _ = KS._tc_args(tx[0].bfloat16(), tx[3].bfloat16(),
                            tx[4].bfloat16(), 64)
    assert len(ng) == 2 and all(w in KS.TC_HEAD_DIMS for *_, w in pg)
    assert KS.tc_launches(P, N) == len(pg) * 2

    def plain_bwd(x, dt, al, b, c, g, chunk, acc):
        dx, ddt, da, db, dc = K.ssm_scan_bwd(x, dt, al, b, c, g, chunk)
        for a, d in zip(acc, (da, db, dc)):
            a += d
        return dx, ddt

    def off(a, w):      # by the largest magnitude (ddt reaches hundreds)
        assert a.shape == w.shape and a.dtype == w.dtype
        return float((a - w).abs().max() / w.abs().max())

    got = KS.split_scan(K.ssm_scan, *tx, 64)
    assert off(got, K.ssm_scan(*tx, chunk=64)) <= 1e-5
    grads = KS.split_scan_bwd(plain_bwd, *tx, dy, 64)
    wants = K.ssm_scan_bwd(*tx, dy, chunk=64)
    for name, a, w in zip(("dx", "ddt", "da_log", "db", "dc"), grads,
                          wants):
        assert off(a, w) <= 1e-5, (name, off(a, w))


def test_wrappers_check_inputs():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(TypeError):
        K.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        K.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):                    # head dim 24
        K.flash_attention(*(torch.zeros((1, 2, 8, 24)),) * 3)
    with pytest.raises(ValueError):                    # head counts differ
        K.flash_attention(q, torch.zeros((1, 1, 8, 16)),
                          torch.zeros((1, 1, 8, 16)))
    with pytest.raises(ValueError):                    # not contiguous
        K.flash_attention(torch.zeros((1, 8, 2, 16)).transpose(1, 2), q, q)
    with pytest.raises(ValueError):
        K.flash_attention(q, q.to("meta"), q)
    x = torch.zeros((1, 64, 2, 16))
    dt = torch.zeros((1, 64, 2))
    al = torch.zeros((2,))
    b = torch.zeros((1, 64, 8))
    with pytest.raises(TypeError):                     # dt must be f32
        K.ssm_scan(x, dt.bfloat16(), al, b, b)
    with pytest.raises(TypeError):                     # b, c as x
        K.ssm_scan(x, dt, al, b.bfloat16(), b.bfloat16())
    with pytest.raises(ValueError):                    # 48 % 32 != 0
        K.ssm_scan(x[:, :48], dt[:, :48], al, b[:, :48], b[:, :48],
                   chunk=32)
    with pytest.raises(ValueError):
        K.ssm_scan(x, dt, torch.zeros((3,)), b, b)
    with pytest.raises(ValueError):
        K.ssm_scan(x, dt, al, b.to("meta"), b.to("meta"))
