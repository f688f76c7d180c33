"""Building blocks of the LM substrate on PyTorch: the parts of
``repro/models/layers.py`` on the serving and training paths.

Each JAX ``init_*`` function becomes an ``nn.Module`` constructor with
the same shapes, scales and dtypes (weights in bf16, the Mamba2 decay and
step parameters in float32) that draws from an explicit
``torch.Generator``; with ``generator=None`` the weights are left
uninitialised for ``models.convert`` to fill.  Parameter names follow the
keys of the JAX param tree (``attn.q.w``, ``mamba.a_log``, ...), and
dense weights keep the JAX layout ``(d_in, d_out)``: ``y = x @ w``.

Two hand-written kernels sit on this path (``kernels.ops``): the
attention of a whole sequence goes through ``flash_attention`` (causal
self-attention, and non-causal cross-attention over a context of any
length) and the Mamba2 chunked scan of a whole prompt through
``ssm_scan``; under autograd both go through their backward kernels too.
The one-token decode steps stay plain PyTorch, as in the reference, and
so does MLA, whose scores the reference takes by einsum.  Parameters are
trainable; the serving steps run under ``torch.inference_mode()``.  Caches are dicts of
tensors that the layers update in place (the reference returns new ones).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..distributed import sharding as _shard
from ..distributed.sharding import PartitionSpec as P
from ..kernels import ops as kops
from ..launch import tuning
from ..numerics import einsum, gelu_tanh, silu
from .config import ModelConfig

__all__ = ["DTYPE", "Dense", "Norm", "norm", "rope", "Attention", "MLA",
           "FFN", "MoE", "Mamba2", "ssd_scan_ref", "spec_dense", "spec_norm",
           "spec_attention", "spec_mla", "spec_ffn", "spec_moe",
           "spec_mamba2", "COST_MODE"]

DTYPE = torch.bfloat16
Cache = Dict[str, torch.Tensor]
Specs = Dict[str, object]

# Cost-analysis mode (``model.set_scan_unroll``): attention of a whole
# sequence off the card takes ``_sdpa_direct`` instead of the flash
# kernel, the reference's loop-free route for its dry-run cost pass.
# Tensors on the card keep the kernel whatever this says.
COST_MODE: list = [False]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def _normal(shape, scale: float, device, generator) -> nn.Parameter:
    """``scale * N(0, 1)`` drawn in float32, stored in bf16 (as the
    reference's ``_normal``); uninitialised when ``generator`` is None."""
    if generator is None:
        return _param(torch.empty(shape, dtype=DTYPE, device=device))
    t = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return _param((t * scale).to(DTYPE))


# =============================================================================
# dense / norm / rope
# =============================================================================

class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False, *,
                 device, generator):
        super().__init__()
        self.w = _normal((d_in, d_out), 1.0 / math.sqrt(d_in), device,
                         generator)
        self.b = _param(torch.zeros((d_out,), dtype=DTYPE, device=device)) \
            if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = einsum("...i,io->...o", x, self.w)
        if self.b is not None:
            y = y + self.b
        return y


def norm(scale: torch.Tensor, x: torch.Tensor, kind: str = "rmsnorm",
         eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        xf = xf - xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


class Norm(nn.Module):
    def __init__(self, d: int, kind: str = "rmsnorm", *, device):
        super().__init__()
        self.kind = kind
        self.scale = _param(torch.ones((d,), dtype=DTYPE, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm(self.scale, x, self.kind)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# =============================================================================
# sharding specs: each module's parameters by name, with the logical axes
# of the reference's ``spec_*`` functions ("d" FSDP, "m" tensor parallel)
# =============================================================================

def spec_dense(shard_in: Optional[str], shard_out: Optional[str],
               bias: bool = False) -> Specs:
    p = {"w": P(shard_in, shard_out)}
    if bias:
        p["b"] = P(shard_out)
    return p


def spec_norm() -> Specs:
    return {"scale": P(None)}


def spec_attention(cfg: ModelConfig) -> Specs:
    b = cfg.qkv_bias
    return {
        "q": spec_dense("d", "m", b),
        "k": spec_dense("d", "m" if cfg.n_kv_heads > 1 else None, b),
        "v": spec_dense("d", "m" if cfg.n_kv_heads > 1 else None, b),
        "o": spec_dense("m", "d"),
    }


def spec_mla(cfg: ModelConfig) -> Specs:
    return {
        "q": spec_dense("d", "m"),
        "dkv": spec_dense("d", None),
        "kr": spec_dense("d", None),
        "ukv": spec_dense(None, "m"),
        "o": spec_dense("m", "d"),
    }


def spec_ffn(cfg: ModelConfig) -> Specs:
    if cfg.act == "silu":
        return {"wi": spec_dense("d", "m"), "wg": spec_dense("d", "m"),
                "wo": spec_dense("m", "d")}
    return {"wi": spec_dense("d", "m"), "wo": spec_dense("m", "d")}


def spec_moe(cfg: ModelConfig) -> Specs:
    p = {
        "router": spec_dense("d", None),
        # experts shard over the TP axis (EP); d_model over FSDP axis
        "wi": P("m", "d", None),
        "wg": P("m", "d", None),
        "wo": P("m", None, "d"),
    }
    if cfg.n_shared_experts:
        p["shared"] = spec_ffn(cfg)
    return p


def spec_mamba2(cfg: ModelConfig) -> Specs:
    return {
        "in_proj": spec_dense("d", "m"),
        "conv_w": P(None, "m"),
        "a_log": P(None), "dt_bias": P(None), "d_skip": P(None),
        "out_norm": spec_norm(),
        "out_proj": spec_dense("m", "d"),
    }


# =============================================================================
# GQA / MQA / MHA self-attention with an optional KV cache, and
# cross-attention
# =============================================================================

# queries above this many, in multiples of it, take the reference's blocked
# path (repro/models/layers.py::_sdpa), which the flash kernel replaces
_Q_CHUNK = 512


def _sdpa_direct(q, k, v, causal: bool, q_pos=None, kv_len=None):
    """q: (B,S,H,hd), k/v: (B,T,Hkv,hd) with GQA broadcast.

    ``kv_len``: (B,) valid cache length for decode; ``q_pos``: (B,S)
    absolute positions of the queries (for causal masking vs the cache).
    The scores are taken in q's dtype and then widened, as in the
    reference (bf16 scores round to bf16).
    """
    B, S, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, S, Hkv, g, hd)
    scores = einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / math.sqrt(hd)
    tpos = torch.arange(T, device=q.device)
    if causal and q_pos is not None:
        mask = tpos[None, None, :] <= q_pos[:, :, None]          # (B,S,T)
    elif causal:
        spos = torch.arange(S, device=q.device)
        mask = (tpos[None, :] <= spos[:, None])[None]            # (1,S,T)
    else:
        mask = torch.ones((1, 1, T), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask = mask & (tpos[None, None, :] < kv_len[:, None, None])
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, H * hd)


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """Attention of whole sequences through the flash kernel.  q:
    (B,S,H,hd), k/v: (B,T,Hkv,hd).  Causal (T >= S): query i sits at
    position T - S + i and sees the keys up to it (a whole prompt when
    T = S); otherwise every query sees all T keys (cross-attention and
    the encoder, any T).  The reference groups query heads as
    ``q.reshape(B, S, Hkv, g, hd)``, so query head h reads kv head
    h // g: ``repeat_interleave``, not ``repeat``."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh = k.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
    vh = v.repeat_interleave(g, dim=2).permute(0, 2, 1, 3).contiguous()
    out = kops.flash_attention(qh, kh, vh, causal=causal)    # (B,H,S,hd)
    return out.permute(0, 2, 1, 3).reshape(B, S, H * hd)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> torch.Tensor:
    """Attention without a cache: a whole sequence (S > 1) through the
    kernel, one token through ``_sdpa_direct`` (the reference's ``_sdpa``
    takes its direct path there too).  In ``COST_MODE`` every length off
    the card takes the direct path (the dry-run's CPU-typed tensors);
    a sequence on the card still goes through the kernel."""
    if q.shape[1] > 1 and not (COST_MODE[0] and q.device.type != "cuda"):
        return _flash(q, k, v, causal)
    return _sdpa_direct(q, k, v, causal)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.q = Dense(d, h * hd, cfg.qkv_bias, device=device,
                       generator=generator)
        self.k = Dense(d, kv * hd, cfg.qkv_bias, device=device,
                       generator=generator)
        self.v = Dense(d, kv * hd, cfg.qkv_bias, device=device,
                       generator=generator)
        self.o = Dense(h * hd, d, device=device, generator=generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Cache] = None,
                cross_ctx: Optional[torch.Tensor] = None,
                fresh: bool = False):
        """Causal self-attention, or cross-attention over ``cross_ctx``
        (B, T, d_model).  Returns (out, cache).  ``fresh``: the caller
        knows ``cache`` is empty (every ``len`` 0), which spares reading
        the lengths back from the device.

        With a context, k and v come from its T rows without rope and
        without a cache, and every query attends over all of them
        (non-causal; ``cache`` is ignored and None returned, as in the
        reference).  Without a cache (training, the encoder-free forward,
        and a ``cross_attn`` layer called without a context) the S new
        tokens attend causally to each other only.  Both go through
        ``_attend``.

        ``cache`` = {"k": (B,T,Hkv,hd), "v": ..., "len": (B,)}.  The S new
        tokens' k, v are written at row 0's ``len`` for every row (clamped
        into range, as the reference's ``dynamic_update_slice``) and ``len``
        rises by S.  A prefill into an empty cache (S > 1, every ``len`` 0,
        as the serving steps make it, at positions 0..S-1) attends causally
        over the S new keys through the kernel, which is what the
        reference's mask over the whole cache leaves.  Otherwise queries
        attend over each row's first ``len + S`` entries up to their
        positions, routed as the reference's ``_sdpa`` routes them: S
        above ``_Q_CHUNK`` and a multiple of it takes the flash kernel
        over the first ``len[0] + S`` rows (causal offset ``len[0]``) when
        every row's ``len`` and positions agree with that; everything
        else takes ``_sdpa_direct``.
        """
        cfg = self.cfg
        B, S, _ = x.shape
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = self.q(x).reshape(B, S, h, hd)
        if cross_ctx is not None:
            T = cross_ctx.shape[1]
            k = self.k(cross_ctx).reshape(B, T, kv, hd)
            v = self.v(cross_ctx).reshape(B, T, kv, hd)
            return self.o(_attend(q, k, v, causal=False)), None
        k = self.k(x).reshape(B, S, kv, hd)
        v = self.v(x).reshape(B, S, kv, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        if cache is None:
            return self.o(_attend(q, k, v, causal=True)), None
        if S > 1 and (fresh or not bool((cache["len"] != 0).any())):
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
            cache["len"] += S
            return self.o(_attend(q, k, v, causal=True)), cache
        T = cache["k"].shape[1]
        # the reference's dynamic_update_slice clamps the start into range
        start = cache["len"][0].clamp(0, T - S)
        rows = start + torch.arange(S, device=x.device)
        cache["k"].index_copy_(1, rows, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, rows, v.to(cache["v"].dtype))
        cache["len"] += S
        if S > _Q_CHUNK and S % _Q_CHUNK == 0 \
                and q.dtype == cache["k"].dtype:
            end = int(cache["len"][0])
            # the kernel's causal offset is end - S: an unclamped write,
            # and every row's queries at the rows written
            if int(start) == end - S and bool((cache["len"] == end).all()) \
                    and bool((positions == rows).all()):
                out = _flash(q, cache["k"][:, :end], cache["v"][:, :end],
                             causal=True)
                return self.o(out), cache
        out = _sdpa_direct(q, cache["k"], cache["v"], causal=True,
                           q_pos=positions, kv_len=cache["len"])
        return self.o(out), cache


# =============================================================================
# MLA: multi-head latent attention (DeepSeek-V2), low-rank KV cache
# =============================================================================

class MLA(nn.Module):
    """The reference's ``init_mla`` / ``mla_attention``.  The cache keeps
    only the latent ``c_kv`` (rank r) and the shared rope key (dr) of each
    token; ``ukv`` decompresses the whole cache into the per-head no-rope
    keys and the values on every call.  The products are einsums, as in
    the reference: no kernel (its qk head dim, dn + dr = 192, is not one
    of the flash kernel's)."""

    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.cfg = cfg
        self.q = Dense(d, h * (dn + dr), device=device, generator=generator)
        self.dkv = Dense(d, r, device=device, generator=generator)
        self.kr = Dense(d, dr, device=device, generator=generator)
        self.ukv = Dense(r, h * (dn + dv), device=device, generator=generator)
        self.o = Dense(h * dv, d, device=device, generator=generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Cache] = None, fresh: bool = False):
        """Returns (out, cache).  ``cache`` = {"ckv": (B,T,r), "kr":
        (B,T,dr), "len": (B,)}: the S new tokens are written at row 0's
        ``len`` for every row (clamped into range, as the reference's
        ``dynamic_update_slice``; at row 0 when the caller says the cache
        is ``fresh``), ``len`` rises by S, and the queries
        attend over the whole cache, masked to ``tpos <= position`` and
        ``tpos < len``.  Without a cache they attend over the S new
        tokens, masked to ``tpos <= position``.  The two score einsums
        each round to the activations' dtype before they are widened to
        float32 and added; hidden scores are -1e30."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = cfg.n_heads
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        q = self.q(x).reshape(B, S, h, dn + dr)
        qn, qr = q[..., :dn], rope(q[..., dn:], positions, cfg.rope_theta)
        ckv = self.dkv(x)                                          # (B,S,r)
        kr = rope(self.kr(x)[:, :, None, :], positions,
                  cfg.rope_theta)[:, :, 0]                         # (B,S,dr)
        kv_len = None
        if cache is not None:
            if fresh:
                cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
                cache["kr"][:, :S] = kr.to(cache["kr"].dtype)
            else:
                T = cache["ckv"].shape[1]
                start = cache["len"][0].clamp(0, T - S)
                rows = start + torch.arange(S, device=x.device)
                cache["ckv"].index_copy_(1, rows,
                                         ckv.to(cache["ckv"].dtype))
                cache["kr"].index_copy_(1, rows, kr.to(cache["kr"].dtype))
            cache["len"] += S
            ckv, kr, kv_len = cache["ckv"], cache["kr"], cache["len"]
        T = ckv.shape[1]
        kv = self.ukv(ckv).reshape(B, T, h, dn + dv)
        kn, v = kv[..., :dn], kv[..., dn:]
        sc = einsum("bshd,bthd->bhst", qn, kn).float()
        sc = sc + einsum("bshd,btd->bhst", qr, kr).float()
        sc = sc / math.sqrt(dn + dr)
        tpos = torch.arange(T, device=x.device)
        mask = tpos[None, None, :] <= positions[:, :, None]       # (B,S,T)
        if kv_len is not None:
            mask = mask & (tpos[None, None, :] < kv_len[:, None, None])
        sc = sc.masked_fill(~mask[:, None, :, :], -1e30)
        w = torch.softmax(sc, dim=-1).to(x.dtype)
        out = einsum("bhst,bthd->bshd", w, v).reshape(B, S, h * dv)
        return self.o(out), cache


# =============================================================================
# FFN: dense (gated silu / gelu) and MoE with capacity-based dispatch
# =============================================================================

class FFN(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None, *,
                 device, generator):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.act = cfg.act
        self.wi = Dense(d, f, device=device, generator=generator)
        if cfg.act == "silu":
            self.wg = Dense(d, f, device=device, generator=generator)
        self.wo = Dense(f, d, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.act == "silu":
            return self.wo(silu(self.wg(x)) * self.wi(x))
        return self.wo(gelu_tanh(self.wi(x)))


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        d, e = cfg.d_model, cfg.n_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.cfg = cfg
        self.router = Dense(d, e, device=device, generator=generator)
        self.wi = _normal((e, d, f), 1.0 / math.sqrt(d), device, generator)
        self.wg = _normal((e, d, f), 1.0 / math.sqrt(d), device, generator)
        self.wo = _normal((e, f, d), 1.0 / math.sqrt(f), device, generator)
        self.shared = FFN(cfg, f * cfg.n_shared_experts, device=device,
                          generator=generator) \
            if cfg.n_shared_experts else None

    def forward(self, x: torch.Tensor, capacity_factor: float = 1.25
                ) -> torch.Tensor:
        """Top-k routing with per-row expert capacity (one-hot dispatch
        einsums).  The expert axis of the dispatch tensors is pinned to the
        tensor-parallel axis (``logical_constraint``: a no-op on plain
        tensors and without an installed axis map)."""
        B, S, d = x.shape
        e, k = self.cfg.n_experts, self.cfg.top_k
        cap = max(int(S * k / e * capacity_factor), 4)
        disp_dtype = torch.bfloat16 if tuning.KNOBS.moe_dispatch_bf16 \
            else torch.float32
        logits = self.router(x).float()                           # (B,S,E)
        probs = torch.softmax(logits, dim=-1)
        # jax.lax.top_k puts ties in index order; a stable descending sort
        # does the same on every device (torch.topk promises no tie order)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[..., :k], idx[..., :k]                 # (B,S,k)
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        onehot = F.one_hot(idx, e).float()                        # (B,S,k,E)
        # position of each token in its expert's queue (cumsum over S, k)
        flat = onehot.reshape(B, S * k, e)
        pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, S, k, e)
        within = pos < cap
        # jax.nn.one_hot of a float position >= cap is an all-zero row
        slot = (pos[..., None] == torch.arange(cap, device=x.device,
                                               dtype=pos.dtype))
        dispatch = (onehot * within).to(disp_dtype)[..., None] \
            * slot.to(disp_dtype)                                 # (B,S,k,E,C)
        dispatch = dispatch.sum(2)                                # (B,S,E,C)
        dispatch = _shard.logical_constraint(dispatch, "b", None, "m", None)
        combine = (dispatch * gates.sum(-1)[..., None, None]).to(x.dtype)
        xe = einsum("bsec,bsd->becd", dispatch.to(x.dtype), x)
        xe = _shard.logical_constraint(xe, "b", "m", None, None)
        hid = silu(einsum("becd,edf->becf", xe, self.wg)) \
            * einsum("becd,edf->becf", xe, self.wi)
        hid = _shard.logical_constraint(hid, "b", "m", None, None)
        ye = einsum("becf,efd->becd", hid, self.wo)
        ye = _shard.logical_constraint(ye, "b", "m", None, None)
        y = einsum("bsec,becd->bsd", combine, ye)
        if self.shared is not None:
            y = y + self.shared(x)
        return y


# =============================================================================
# Mamba2 (SSD) mixer
# =============================================================================

def ssd_scan_ref(x, dt, a_log, b, c, chunk: int = 128):
    """Chunked state-space-duality scan (Mamba2, arXiv:2405.21060).

    x: (B,S,H,P) values; dt: (B,S,H) softplus'd step; a_log: (H,);
    b, c: (B,S,N).  Returns y: (B,S,H,P) in x's dtype.

    The plain version of the ``ssm_scan`` kernel, ported from the
    reference's function of the same name, einsum by einsum."""
    B, S, H, Pd = x.shape
    N = b.shape[-1]
    nc = S // chunk
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))                               # (H,)
    dta = dt.to(f32) * a                                        # (B,S,H)
    xr = x.reshape(B, nc, chunk, H, Pd).to(f32)
    dtr = dt.reshape(B, nc, chunk, H).to(f32)
    dar = dta.reshape(B, nc, chunk, H)
    br = b.reshape(B, nc, chunk, N).to(f32)
    cr = c.reshape(B, nc, chunk, N).to(f32)
    seg = torch.cumsum(dar, dim=2)                              # (B,nc,L,H)
    # intra-chunk: mask INSIDE the exp (the upper triangle holds
    # exp(+large))
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]     # (B,nc,Li,Lj,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=x.device).tril()
    decay = torch.exp(rel.masked_fill(~causal[None, None, :, :, None],
                                      -1e30))
    cb = einsum("bkin,bkjn->bkij", cr, br)                      # (B,nc,Li,Lj)
    wgt = cb[..., None] * decay * dtr[:, :, None, :, :]     # (B,nc,Li,Lj,H)
    y_intra = einsum("bkijh,bkjhp->bkihp", wgt, xr)
    # chunk-final states
    tail = seg[:, :, -1:, :] - seg                              # (B,nc,L,H)
    state_c = einsum("bkjh,bkjn,bkjhp->bkhpn",
                     torch.exp(tail) * dtr, br, xr)             # (B,nc,H,P,N)
    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(seg[:, :, -1, :])                   # (B,nc,H)
    s = torch.zeros((B, H, Pd, N), dtype=f32, device=x.device)
    states_in = []
    for i in range(nc):
        states_in.append(s)
        s = s * chunk_decay[:, i, :, None, None] + state_c[:, i]
    states_in = torch.stack(states_in, dim=1)                   # (B,nc,H,P,N)
    y_inter = einsum("bkin,bkih,bkhpn->bkihp",
                     cr, torch.exp(seg), states_in)
    y = (y_intra + y_inter).reshape(B, S, H, Pd)
    return y.to(x.dtype)


class Mamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        n, h = cfg.ssm_state, cfg.ssm_heads
        self.cfg = cfg
        f32 = torch.float32
        # projects to [x(di), B(n), C(n)] (conv'd together), z(di), dt(h)
        self.in_proj = Dense(d, 2 * di + 2 * n + h, device=device,
                             generator=generator)
        self.conv_w = _normal((cfg.ssm_conv_width, di + 2 * n), 0.2, device,
                              generator)
        self.a_log = _param(torch.log(torch.arange(1, h + 1, dtype=f32,
                                                   device=device)))
        self.dt_bias = _param(torch.zeros((h,), dtype=f32, device=device))
        self.d_skip = _param(torch.ones((h,), dtype=f32, device=device))
        self.out_norm = Norm(di, device=device)
        self.out_proj = Dense(di, d, device=device, generator=generator)

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                chunk: Optional[int] = None):
        """Mamba2 block.  A prompt goes through the chunked SSD scan (the
        ``ssm_scan`` kernel); decode (S == 1 with a cache) takes the O(1)
        recurrent step against the (conv, ssm) cache.  Returns (out,
        cache)."""
        if chunk is None:
            chunk = tuning.KNOBS.ssd_chunk
        cfg = self.cfg
        B, S, _ = x.shape
        di, n, h, pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
            cfg.ssm_head_dim
        w = cfg.ssm_conv_width
        proj = self.in_proj(x)
        xbc, z, dt_raw = torch.split(proj, [di + 2 * n, di, h], dim=-1)
        # jax.nn.softplus is logaddexp(x, 0) (F.softplus switches to the
        # identity above 20)
        dt_in = dt_raw.float() + self.dt_bias
        dt = torch.logaddexp(dt_in, torch.zeros_like(dt_in))
        if cache is not None and S == 1:
            conv_state = torch.cat([cache["conv"][:, 1:], xbc], dim=1)
            xbc_conv = einsum("bwc,wc->bc", conv_state,
                                    self.conv_w.to(x.dtype))[:, None]
            xbc_conv = silu(xbc_conv)
            xv, b, c = torch.split(xbc_conv, [di, n, n], dim=-1)
            a = -torch.exp(self.a_log)
            xh = xv.reshape(B, h, pd).float()
            dec = torch.exp(dt[:, 0] * a)                         # (B,H)
            s = cache["ssm"] * dec[..., None, None] \
                + einsum("bh,bhp,bn->bhpn", dt[:, 0], xh,
                         b[:, 0].float())
            y = einsum("bn,bhpn->bhp", c[:, 0].float(), s)
            y = y + self.d_skip[:, None] * xh
            y = y.reshape(B, 1, di).to(x.dtype)
            cache["conv"].copy_(conv_state)
            cache["ssm"].copy_(s)
        else:
            # causal depthwise conv over (x, B, C)
            pad = F.pad(xbc, (0, 0, w - 1, 0))
            xbc_conv = sum(pad[:, i:i + S] * self.conv_w[i].to(x.dtype)
                           for i in range(w))
            xbc_conv = silu(xbc_conv)
            xv, b, c = torch.split(xbc_conv, [di, n, n], dim=-1)
            xh = xv.reshape(B, S, h, pd)
            y = kops.ssm_scan(xh.contiguous(), dt.contiguous(), self.a_log,
                              b.contiguous(), c.contiguous(),
                              chunk=min(chunk, S))
            y = y + self.d_skip.to(x.dtype)[:, None] * xh
            y = y.reshape(B, S, di)
            if cache is not None:
                # as the reference: the conv tail and a zero SSM state
                cache["conv"].copy_(pad[:, -w:])
                cache["ssm"].zero_()
        out = norm(self.out_norm.scale, y * silu(z), "rmsnorm")
        return self.out_proj(out), cache
