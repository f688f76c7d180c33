"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

``dse_eval_ref`` and ``flash_attention_ref`` port the functions of the
same names in ``repro/kernels/ref.py`` line for line; ``ssm_scan_ref``
delegates, as the reference does, to the model's chunked SSD scan
(``models.layers.ssd_scan_ref``).  ``horner_ref`` is the plain version
of the reference's ``ops.horner`` (the Pallas kernel's entry point):
float32 inside, x's dtype out.  The backward kernels' plain versions are
autograd through these functions.  They are the semantics of record the
CUDA kernels are held to.  The CPU path of ``kernels.ops`` and the tests
use them; on the card, ``chip_smoke.py`` compares the kernels with them.
"""
from __future__ import annotations

import math

import torch

from ..numerics import einsum

__all__ = ["dse_eval_ref", "flash_attention_ref", "ssm_scan_ref",
           "horner_ref", "OP_FIELDS", "TILE_FIELDS"]

# packed layouts shared with the kernel ---------------------------------------
# op row: [op_cls, macs, elems, bytes_total, seq_len, sfu_kind, sfu_n]
OP_FIELDS = 7
# tile row: [exists, num_macs, dsp_lanes, clock_hz, eta, sfu_mask, sfu_par,
#            prec_ok, e_mac_pj, bw_bytes_per_s]
TILE_FIELDS = 10

# candidates per chunk: bounds the (chunk, T, N) intermediates
_CHUNK_ELEMS = 1 << 25


def _dse_eval_rows(tiles: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    exists, num_macs, lanes, clock, eta, sfu_mask, sfu_par, prec_ok, e_mac, \
        bw = [tiles[..., i] for i in range(TILE_FIELDS)]   # (B, T)
    op_cls, macs, elems, bytes_t, seq_len, sfu_kind, sfu_n = \
        [ops[:, i] for i in range(OP_FIELDS)]             # (N,)

    tl = lambda a: a[:, :, None]      # noqa: E731  (B,T,1)
    onp = lambda a: a[None, None, :]  # noqa: E731  (1,1,N)

    mac_ok = (tl(num_macs) > 0) & (tl(prec_ok) > 0)
    c_mac = torch.where(
        mac_ok, onp(macs) / torch.clamp(tl(num_macs) * tl(eta), min=1e-9),
        torch.ceil(2.0 * onp(macs) / torch.clamp(tl(lanes), min=1.0)))
    c_dsp = torch.ceil(2.0 * onp(elems) / torch.clamp(tl(lanes), min=1.0)) \
        * torch.clamp(onp(seq_len), min=1.0) ** 0.5
    native = torch.floor_divide(tl(sfu_mask),
                                torch.clamp(onp(sfu_kind), min=1.0)) % 2 >= 1
    c_sfu_nat = onp(elems) * torch.log2(torch.clamp(onp(sfu_n), min=2.0)) \
        / torch.clamp(tl(sfu_par), min=1.0)
    c_sfu_low = torch.ceil(10.0 * onp(elems)
                           / torch.clamp(tl(lanes), min=1.0))
    c_sfu = torch.where(native, c_sfu_nat, c_sfu_low)
    c_cmp = torch.where(onp(op_cls) == 0.0, c_mac,
                        torch.where(onp(op_cls) == 2.0, c_sfu, c_dsp))
    c_bw = onp(bytes_t) / torch.clamp(tl(bw) / tl(clock), min=1e-9)
    sec = torch.maximum(c_cmp, c_bw) / tl(clock)
    dsp_ok = tl(lanes) > 0
    ok = torch.where(onp(op_cls) == 0.0, mac_ok | dsp_ok, dsp_ok) \
        & (tl(exists) > 0)
    sec = torch.where(ok, sec, torch.inf)
    best_t = torch.argmin(sec, dim=1)                     # (B, N)
    best_sec = torch.gather(sec, 1, best_t[:, None, :])[:, 0, :]
    e_best = torch.gather(e_mac, 1, best_t)
    energy = macs[None, :] * e_best + elems[None, :] * 0.5
    return torch.stack([best_sec, energy], dim=-1)


def dse_eval_ref(tiles: torch.Tensor, ops: torch.Tensor) -> torch.Tensor:
    """Myopic roofline pre-filter (paper Eq. 2 applied per op in isolation).

    tiles: (B, T, TILE_FIELDS) float32; ops: (N, OP_FIELDS) float32.
    Returns (B, N, 2) float32: [best seconds, energy at the best tile].
    Where no tile can host an op the seconds are inf and the energy is
    ``macs * e_mac[tile 0] + 0.5 * elems`` (``argmin`` of all-inf is 0).
    Candidates are processed in chunks; rows are independent.
    """
    B, T, _ = tiles.shape
    N = ops.shape[0]
    step = max(1, _CHUNK_ELEMS // max(T * N, 1))
    return torch.cat([_dse_eval_rows(tiles[s:s + step], ops)
                      for s in range(0, B, step)], dim=0) if B else \
        torch.empty((0, N, 2), dtype=tiles.dtype, device=tiles.device)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (B,H,S,D), k/v: (B,H,T,D).  fp32 softmax, output q.dtype.  The
    scores are taken in q's dtype first (bf16 scores round to bf16), as
    the reference's einsum does."""
    s = einsum("bhsd,bhtd->bhst", q, k).float()
    s = s / math.sqrt(q.shape[-1])
    if causal:
        S, T = s.shape[-2], s.shape[-1]
        tpos = torch.arange(T, device=q.device)
        spos = torch.arange(S, device=q.device)
        s = s.masked_fill(tpos[None, :] > spos[:, None] + (T - S), -1e30)
    w = torch.softmax(s, dim=-1)
    return einsum("bhst,bhtd->bhsd", w.to(q.dtype), v)


def ssm_scan_ref(x, dt, a_log, b, c, chunk: int = 64) -> torch.Tensor:
    """Delegates to the model's chunked SSD scan (single source of
    truth)."""
    from ..models.layers import ssd_scan_ref
    return ssd_scan_ref(x, dt, a_log, b, c, chunk=chunk)


def horner_ref(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """sum_i coeffs[i] x^i with Horner's rule, coeffs lowest degree first.
    Each step multiplies and then adds, each rounded to float32 (no fused
    multiply-add), and the result is cast to x's dtype, as the Pallas
    kernel's output is.  (The reference's jnp oracle of the same name
    returns float32 for a bfloat16 x: its float32 coefficient promotes.)"""
    xf, cf = x.float(), coeffs.float()
    y = torch.zeros_like(xf) + cf[-1]
    for i in range(cf.shape[0] - 2, -1, -1):
        y = y * xf + cf[i]
    return y.to(x.dtype)
