"""PyTorch port, the arithmetic of the bf16 tensor-core ``ssm_scan``
kernels on the CPU.  The CUDA kernels (``csrc/ssm_scan.cu``,
``csrc/ssm_scan_bwd.cu`` and their shared stages in ``csrc/ssm_tc.cuh``,
bf16 paths) run only on the card; here a plain emulation of their stages
and of where they round is held against the JAX package's
``repro.models.layers.ssd_scan_ref`` and its ``jax.vjp``.

The kernels cut every chunk of L rows into tiles of at most 64 rows (one
tile for L <= 64, two for L <= 128) and run the chunked SSD algorithm on
the tiles, with seg = cumsum(dt a) restarting at each tile; rows of a
64-row tile past the chunk's end count as dt = 0 (nothing decays or
adds) and are masked out of every product that sums over them.  The
stages, each chunk-parallel but (b) and (b'):

- (a)  state_c = X^T diag(u) B, u_j = exp(seg_last - seg_j) dt_j;
- (b)  S_in[k] = S; S = exp(seg_last,k) S + state_c[k], in float32;
- (c)  y = diag(exp(seg)) C S_in^T + W X, W_ij = (C B^T)_ij
       exp(seg_i - seg_j) dt_j for j <= i;
- (a') M = (diag(exp(seg)) dY)^T C;
- (b') D_out[k] = D; D = exp(seg_last,k) D + M[k], from the last tile;
- (c') dx, db, dc, ddt and d a_log from Q = C B^T, A = dY X^T, S_in and
       D_out (see gradients()).

Where they round: bf16 inputs enter products as they are (their products
are exact, the sums float32); every float32 operand of a product (X u,
W, S_in, dY exp(seg), D, the masked A and Q) enters as two bf16 parts,
hi = bf16(v) and lo = bf16(v - hi), so the product errs by about 2^-17
of it; y, dx, db and dc are rounded to bf16 once, at the end.

The reference is compiled with XLA's ``xla_allow_excess_precision`` off
(see tests/test_torch_lm_serve.py)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.layers import ssd_scan_ref  # noqa: E402
from repro_torch.models.convert import to_torch  # noqa: E402

_STRICT = {"xla_allow_excess_precision": False}
_ROWS = 64          # rows of a tile (wgmma's M)
CARD_TOL = 5e-2     # tests/test_torch_gpu.py's bf16 limits
# the emulation's float32 results against the float32 reference: the two
# bf16 parts leave about 2^-17 of each product, the sums' order 1e-6
TIGHT_TOL = 1e-3


def _split(v):
    """A float32 operand as the sum of two bf16 parts."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def _mm2(eq, v, w):
    """einsum of a float32 operand ``v`` (two bf16 parts) and ``w``."""
    hi, lo = _split(v)
    return torch.einsum(eq, hi, w) + torch.einsum(eq, lo, w)


def _tiles(S, L):
    """(rows (nt, 64) into S, valid (nt, 64)) of the kernels' tiles."""
    starts, lens = [], []
    for k in range(S // L):
        for t in range(0, L, _ROWS):
            starts.append(k * L + t)
            lens.append(min(_ROWS, L - t))
    r = torch.arange(_ROWS)
    rows = torch.tensor(starts)[:, None] + r
    valid = r[None, :] < torch.tensor(lens)[:, None]
    return rows.clamp_max(S - 1), valid


class Tiles:
    """The inputs cut into tiles, with seg and its exponentials."""

    def __init__(self, x, dt, a_log, b, c, L):
        S = x.shape[1]
        self.S, self.L = S, L
        self.rows, self.valid = _tiles(S, L)
        v = self.valid.float()
        self.a = -torch.exp(a_log.float())                       # (H,)
        self.x = x.float()[:, self.rows] * v[None, :, :, None, None]
        self.dt = dt.float()[:, self.rows] * v[None, :, :, None]  # (B,nt,64,H)
        self.b = b.float()[:, self.rows] * v[None, :, :, None]    # (B,nt,64,N)
        self.c = c.float()[:, self.rows] * v[None, :, :, None]
        self.seg = torch.cumsum(self.dt * self.a, dim=2)
        self.last = self.seg[:, :, -1:, :]                        # (B,nt,1,H)
        self.dec = torch.exp(self.last[:, :, 0])                  # (B,nt,H)
        self.ex = torch.exp(self.seg) * v[None, :, :, None]
        self.u = torch.exp(self.last - self.seg) * self.dt
        i = torch.arange(_ROWS)
        causal = i[None, :] <= i[:, None]                          # j <= i
        self.mask = (causal[None, :, :] & self.valid[:, :, None]
                     )[None, :, :, :, None]                        # (1,nt,i,j,1)
        rel = self.seg[:, :, :, None, :] - self.seg[:, :, None, :, :]
        self.decay = torch.exp(rel.masked_fill(~self.mask, -1e30))

    def untile(self, t):
        """(B, nt, 64, ...) tile rows back to (B, S, ...)."""
        out = torch.zeros((t.shape[0], self.S) + t.shape[3:])
        out[:, self.rows[self.valid]] = t[:, self.valid]
        return out


def state_c(T):
    """Stage (a): X^T diag(u) B per tile, (B, nt, H, P, N)."""
    return _mm2("btjhp,btjn->bthpn", T.x * T.u[..., None], T.b)


def passing(states, dec, reverse=False):
    """Stages (b) and (b'): the state entering (or the gradient of the
    state leaving) every tile."""
    out, s = torch.empty_like(states), torch.zeros_like(states[:, 0])
    order = range(states.shape[1])
    for k in (reversed(order) if reverse else order):
        out[:, k] = s
        s = dec[:, k, :, None, None] * s + states[:, k]
    return out


def forward(T, s_in):
    """Stage (c), y in float32 (the kernel rounds it to bf16 once)."""
    g = torch.einsum("btin,btjn->btij", T.c, T.b)
    w = g[..., None] * T.decay * T.dt[:, :, None, :, :]      # (B,nt,i,j,H)
    hi, lo = _split(s_in)                                    # (B,nt,H,P,N)
    inter = torch.einsum("btin,bthpn->btihp", T.c, hi) \
        + torch.einsum("btin,bthpn->btihp", T.c, lo)
    y = inter * torch.exp(T.seg)[..., None] \
        + _mm2("btijh,btjhp->btihp", w, T.x)
    return T.untile(y)


def gradients(T, s_in, d_out, dy):
    """Stage (c'): (dx, ddt, d a_log, db, dc) in float32."""
    dyt = dy.float()[:, T.rows] * T.valid.float()[None, :, :, None, None]
    q = torch.einsum("btin,btjn->btij", T.c, T.b)[..., None] \
        * T.decay                                            # (B,nt,i,j,H)
    a = torch.einsum("btihp,btjhp->btijh", dyt, T.x)
    dtj = T.dt[:, :, None, :, :]
    am, qm = a * T.decay * dtj, q * dtj
    prod = a * q
    # dx_j = u_j (B D^T)_j + sum_i Qm_ij dy_i
    hi, lo = _split(d_out)
    bd = torch.einsum("btjn,bthpn->btjhp", T.b, hi) \
        + torch.einsum("btjn,bthpn->btjhp", T.b, lo)
    dx = T.u[..., None] * bd + _mm2("btijh,btihp->btjhp", qm, dyt)
    sv = torch.exp(T.last - T.seg) * (T.x * bd).sum(-1)      # (B,nt,j,H)
    # db_j = u_j (X D)_j + sum_i Am_ij c_i, summed over the heads
    xd = torch.einsum("btjhp,bthpn->btjhn", T.x, hi) \
        + torch.einsum("btjhp,bthpn->btjhn", T.x, lo)
    db = (T.u[..., None] * xd
          + _mm2("btijh,btin->btjhn", am, T.c)).sum(3)
    # dc_i = ex_i (dY S_in)_i + sum_j Am_ij b_j, summed over the heads
    shi, slo = _split(s_in)
    ds = torch.einsum("btihp,bthpn->btihn", dyt, shi) \
        + torch.einsum("btihp,bthpn->btihn", dyt, slo)
    e = T.ex * (T.c[:, :, :, None, :] * ds).sum(-1)          # (B,nt,i,H)
    dc = (T.ex[..., None] * ds
          + _mm2("btijh,btjn->btihn", am, T.b)).sum(3)
    # d seg, then ddt and d a by a reverse cumulative sum over each tile
    dseg = (prod * dtj).sum(3) + e                           # (B,nt,i,H)
    cg = prod.sum(2)                                         # (B,nt,j,H)
    kv = sv * T.dt
    tot = (d_out * s_in).sum((-1, -2))                       # (B,nt,H)
    g = dseg - cg * T.dt - kv
    last = T.dec * tot + kv.sum(2)
    ends = T.valid.sum(1) - 1                                # (nt,)
    g[:, torch.arange(len(ends)), ends] += last
    run = torch.flip(torch.cumsum(torch.flip(g, [2]), 2), [2])
    ddt = (cg + sv + T.a * run) * T.valid.float()[None, :, :, None]
    da_log = (run * T.dt).sum((0, 1, 2)) * T.a
    return (T.untile(dx), T.untile(ddt), da_log, T.untile(db),
            T.untile(dc))


def emulate(x, dt, a_log, b, c, dy, L):
    """The kernels' stages: (y, grads, state_c, S_in), in float32."""
    T = Tiles(x, dt, a_log, b, c, L)
    sc = state_c(T)
    s_in = passing(sc, T.dec)
    y = forward(T, s_in)
    dyt = dy.float()[:, T.rows] * T.valid.float()[None, :, :, None, None]
    m = _mm2("btihp,btin->bthpn", dyt * T.ex[..., None], T.c)
    d_out = passing(m, T.dec, reverse=True)
    return y, gradients(T, s_in, d_out, dy), sc, s_in


def _reference(args, cot, L):
    """The reference's output and ``jax.vjp`` gradients, compiled
    strictly."""
    def run(args, cot):
        out, pull = jax.vjp(functools.partial(ssd_scan_ref, chunk=L), *args)
        return out, pull(cot)
    return jax.jit(run).lower(args, cot).compile(
        compiler_options=_STRICT)(args, cot)


def _chunk_states(x, dt, a_log, b, L):
    """The plain version's state_c and S_in, in float64, (B, nc, H, P, N)."""
    B, S, H, P = x.shape
    nc = S // L
    xr = x.reshape(B, nc, L, H, P)
    dtr = dt.reshape(B, nc, L, H)
    br = b.reshape(B, nc, L, -1)
    seg = np.cumsum(dtr * -np.exp(a_log), axis=2)
    u = np.exp(seg[:, :, -1:, :] - seg) * dtr
    sc = np.einsum("bkjh,bkjn,bkjhp->bkhpn", u, br, xr)
    s_in, s = np.zeros_like(sc), np.zeros_like(sc[:, 0])
    for k in range(nc):
        s_in[:, k] = s
        s = s * np.exp(seg[:, k, -1, :])[:, :, None, None] + sc[:, k]
    return sc, s_in


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(shape, L):
    B, S, H, P, N = shape
    rng = np.random.default_rng(S + H + P + N + L)
    bf = jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(B, S, H, P)), bf)
    dt = jnp.asarray(rng.uniform(0.01, 0.2, size=(B, S, H)), jnp.float32)
    a_log = jnp.asarray(rng.uniform(-1, 1, size=(H,)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(B, S, N)), bf)
    c = jnp.asarray(rng.normal(size=(B, S, N)), bf)
    dy = jnp.asarray(rng.normal(size=(B, S, H, P)), bf)
    return (x, dt, a_log, b, c), dy


_CASES = [(shape, S, L) for shape in ((1, 2, 16, 16), (1, 2, 64, 128))
          for S, L in ((128, 16), (144, 48), (128, 64))]


@pytest.mark.parametrize("shape,S,L", _CASES)
def test_ssm_tc_emulation_within_limits(shape, S, L):
    """The emulated kernels against the reference, (B, S, H, P, N) with
    (B, H, P, N) = ``shape``: y in bf16 within the card tests' 5e-2
    (absolute and relative) of the reference's bf16 y, each gradient in
    its dtype within 5e-2 of its largest magnitude; the emulation's
    float32 y and gradients within 1e-3 (of the largest magnitude) of
    the reference run in float32 on the same values; and the emulated
    stages (a) and (b) (state_c, S_in) within 1e-3 of the plain
    version's."""
    B, H, P, N = shape
    args, dy = _inputs((B, S, H, P, N), L)
    want_y, want_grads = _reference(args, dy, L)
    f32 = tuple(a.astype(jnp.float32) for a in args)
    want_y32, want_grads32 = _reference(f32, dy.astype(jnp.float32), L)

    t = [to_torch(np.asarray(a)) for a in (*args, dy)]
    y, grads, sc, s_in = emulate(*t, L)

    assert _rel(y, want_y32) <= TIGHT_TOL, _rel(y, want_y32)
    want = np.asarray(want_y, np.float32)
    err = np.abs(y.to(torch.bfloat16).float().numpy() - want)
    assert (err <= CARD_TOL + CARD_TOL * np.abs(want)).all(), float(err.max())
    names = ("x", "dt", "a_log", "b", "c")
    for name, g, w, w32, a in zip(names, grads, want_grads, want_grads32,
                                  args):
        assert g.shape == w.shape, name
        assert _rel(g, w32) <= TIGHT_TOL, (name, _rel(g, w32))
        rounded = g.to(torch.bfloat16).float() if a.dtype == jnp.bfloat16 \
            else g
        assert _rel(rounded, w) <= CARD_TOL, (name, _rel(rounded, w))

    if L <= _ROWS:       # one tile a chunk: the tiles are the chunks
        np64 = [np.asarray(a, np.float64) for a in args]
        want_sc, want_s_in = _chunk_states(*np64[:4], L)
        # (B, nt, H, P, N) against (B, nc, H, P, N)
        assert _rel(sc, want_sc) <= TIGHT_TOL, _rel(sc, want_sc)
        assert _rel(s_in[:, 1:], want_s_in[:, 1:]) <= TIGHT_TOL
        assert not s_in[:, 0].any()
