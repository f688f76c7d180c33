"""Model assembly on PyTorch: a port of ``repro/models/model.py``.

The reference runs the ``first_k_dense`` prefix layers unrolled, then
scans over ``n_repeats`` periods of the config's layer pattern with
stacked params; the port unrolls both into one ``nn.ModuleList`` of
``n_layers`` blocks: the prefix first, then layer
``first_k_dense + r * len(pattern) + j`` holding the reference's
``params["blocks"][j][r]``.  An encoder-decoder's encoder is a second
list, ``encoder``, of ``encoder_layers`` blocks, then ``enc_final_norm``.
Caches are one dict per layer (None for a cross-attention layer).

Entry points:
  Model(cfg, device=..., generator=...)        -> the weights (bf16)
  param_specs(cfg)                             -> {parameter name: spec}
  encode(model, frames)                        -> the encoder's output
  forward(model, tokens, ctx=None)             -> logits (every position)
  loss_fn(model, batch, remat=True)            -> next-token cross-entropy
  init_cache(cfg, batch, max_len, device)      -> per-layer decode caches
  decode_step(model, tokens, pos, caches, ctx) -> (logits, caches)

``ctx`` is the context that cross-attention reads, (B, T, d_model): the
vision embeddings of a ``frontend == "vision"`` model's ``cross_attn``
layers, or the encoder's output for an encoder-decoder's decoder.

Sharding: ``param_specs`` gives each parameter the reference's logical
spec; ``set_activation_spec`` pins the residual stream of a sharded
(DTensor) model to given placements at every pattern period, as the
reference's ``_constrain`` does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.sharding import is_dtensor
from . import layers as L
from .config import ModelConfig

__all__ = ["Block", "EncoderBlock", "Model", "encode", "forward", "loss_fn",
           "init_cache", "decode_step", "param_specs",
           "set_activation_spec", "set_scan_unroll"]

LayerCache = Optional[L.Cache]

# Optional DTensor placements pinned onto the residual stream at every
# pattern period (sequence parallelism in the dry-run): keeps the
# activations between layers sharded.  Set by the launcher.
_ACT_SPEC: list = [None]


def set_activation_spec(placements) -> None:
    """Placements (one per mesh dimension) for the residual stream of a
    DTensor forward, or None for no constraint."""
    _ACT_SPEC[0] = placements


def set_scan_unroll(v: bool, blocks_unroll: int = 1) -> None:
    """The reference's cost-mode switch.  There it unrolls the scans (the
    blocks scan by ``blocks_unroll``) so that XLA's cost analysis counts
    every layer, and routes attention through the loop-free direct path.
    The port's model is eager and already unrolled, so the one effect
    that carries over is the attention route: with ``v`` a whole sequence
    of tensors off the card takes ``_sdpa_direct`` instead of the flash
    kernel (``L.COST_MODE``); tensors on the card keep the kernel.
    ``blocks_unroll`` is accepted and has nothing to unroll."""
    L.COST_MODE[0] = bool(v)


def _constrain(x: torch.Tensor) -> torch.Tensor:
    if _ACT_SPEC[0] is None or not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _ACT_SPEC[0])


class Block(nn.Module):
    """One layer: pre-norm mixer (attention, MLA when ``cfg.mla``,
    cross-attention or Mamba2); on an encoder-decoder's attention layers,
    pre-norm cross-attention ``xattn`` over the context when one is given;
    then pre-norm FFN (dense, MoE or none).  ``norm2`` exists even without
    an FFN, as in the reference's param tree."""

    def __init__(self, cfg: ModelConfig, mixer: str, ffn_kind: str, *,
                 device, generator):
        super().__init__()
        self.mixer, self.ffn_kind = mixer, ffn_kind
        self.norm1 = L.Norm(cfg.d_model, cfg.norm, device=device)
        self.norm2 = L.Norm(cfg.d_model, cfg.norm, device=device)
        if mixer == "mamba":
            self.mamba = L.Mamba2(cfg, device=device, generator=generator)
        elif cfg.mla and mixer == "attn":
            self.attn = L.MLA(cfg, device=device, generator=generator)
        else:
            self.attn = L.Attention(cfg, device=device, generator=generator)
        if ffn_kind == "moe":
            self.ffn = L.MoE(cfg, device=device, generator=generator)
        elif ffn_kind == "dense":
            self.ffn = L.FFN(cfg, device=device, generator=generator)
        self.xattn = None
        if cfg.encoder_layers and mixer == "attn":
            self.norm_x = L.Norm(cfg.d_model, cfg.norm, device=device)
            self.xattn = L.Attention(cfg, device=device, generator=generator)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: LayerCache, ctx: Optional[torch.Tensor] = None,
                fresh: bool = False):
        """A ``cross_attn`` mixer attends over ``ctx``; called without one
        it runs, as in the reference, causal self-attention with rope over
        the new tokens only, with no cache (in a decode step each token
        attends to itself).  ``fresh``: the caller knows ``cache`` is
        empty (a prefill step), so attention need not read its lengths."""
        h = self.norm1(x)
        if self.mixer == "mamba":
            y, cache = self.mamba(h, cache)
        elif self.mixer == "cross_attn":
            y, _ = self.attn(h, positions, None, cross_ctx=ctx)
        else:
            y, cache = self.attn(h, positions, cache, fresh=fresh)
        x = x + y
        if self.xattn is not None and ctx is not None:
            x = x + self.xattn(self.norm_x(x), positions, None,
                               cross_ctx=ctx)[0]
        if self.ffn_kind != "none":
            x = x + self.ffn(self.norm2(x))
        return x, cache


class EncoderBlock(nn.Module):
    """One encoder layer (the reference's ``encode`` body): pre-norm
    attention without rope and without a mask, then pre-norm dense FFN."""

    def __init__(self, cfg: ModelConfig, *, device, generator):
        super().__init__()
        self.norm1 = L.Norm(cfg.d_model, cfg.norm, device=device)
        self.attn = L.Attention(cfg, device=device, generator=generator)
        self.norm2 = L.Norm(cfg.d_model, cfg.norm, device=device)
        self.ffn = L.FFN(cfg, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        # non-causal attention of the sequence over itself, without rope:
        # cross-attention with the sequence as its own context
        x = x + self.attn(h, None, None, cross_ctx=h)[0]
        return x + self.ffn(self.norm2(x))


class Model(nn.Module):
    """The LM's weights.  ``generator`` draws them (same shapes, scales and
    dtypes as the reference's ``init_params``); ``None`` leaves them
    uninitialised for ``models.convert.params_from_jax``.  ``device=None``
    means the card (see ``repro_torch.device``)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = L._normal((cfg.vocab_padded, cfg.d_model),
                               1.0 / math.sqrt(cfg.d_model), dev, generator)
        self.final_norm = L.Norm(cfg.d_model, cfg.norm, device=dev)
        self.lm_head = None if cfg.tie_embeddings else L.Dense(
            cfg.d_model, cfg.vocab_padded, device=dev, generator=generator)
        self.layers = nn.ModuleList(
            Block(cfg, mk, fk, device=dev, generator=generator)
            for mk, fk in _layer_kinds(cfg))
        self.encoder = self.enc_final_norm = None
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(
                EncoderBlock(cfg, device=dev, generator=generator)
                for _ in range(cfg.encoder_layers))
            self.enc_final_norm = L.Norm(cfg.d_model, cfg.norm, device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head(self) -> torch.Tensor:
        return self.embed.T if self.lm_head is None else self.lm_head.w


def _layer_kinds(cfg: ModelConfig):
    """(mixer, ffn) of every layer in the port's order: the prefix, then
    ``n_repeats`` periods of the pattern."""
    return cfg.prefix_pattern() + cfg.pattern() * cfg.n_repeats


def _spec_layer(cfg: ModelConfig, mixer: str, ffn_kind: str) -> L.Specs:
    p: L.Specs = {"norm1": L.spec_norm(), "norm2": L.spec_norm()}
    if mixer == "mamba":
        p["mamba"] = L.spec_mamba2(cfg)
    elif cfg.mla and mixer == "attn":
        p["attn"] = L.spec_mla(cfg)
    else:
        p["attn"] = L.spec_attention(cfg)
    if ffn_kind == "moe":
        p["ffn"] = L.spec_moe(cfg)
    elif ffn_kind == "dense":
        p["ffn"] = L.spec_ffn(cfg)
    if cfg.encoder_layers and mixer == "attn":
        p["norm_x"] = L.spec_norm()
        p["xattn"] = L.spec_attention(cfg)
    return p


def _flat(tree: L.Specs, prefix: str, out: Dict[str, object]) -> None:
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            _flat(v, name, out)
        else:
            out[name] = v


def param_specs(cfg: ModelConfig) -> Dict[str, object]:
    """The logical ``PartitionSpec`` of every parameter of ``Model(cfg)``,
    keyed by its ``named_parameters()`` name: the reference's spec of the
    same leaf (``repro/models/model.py::param_specs``), without the
    leading ``None`` of its stacked layer axis (the port unrolls the
    layers)."""
    out: Dict[str, object] = {"embed": L.P("m", "d")}
    _flat({"final_norm": L.spec_norm()}, "", out)
    if not cfg.tie_embeddings:
        _flat({"lm_head": L.spec_dense("d", "m")}, "", out)
    for i, (mk, fk) in enumerate(_layer_kinds(cfg)):
        _flat(_spec_layer(cfg, mk, fk), f"layers.{i}", out)
    for i in range(cfg.encoder_layers):
        _flat({"norm1": L.spec_norm(), "attn": L.spec_attention(cfg),
               "norm2": L.spec_norm(), "ffn": L.spec_ffn(cfg)},
              f"encoder.{i}", out)
    if cfg.encoder_layers:
        _flat({"enc_final_norm": L.spec_norm()}, "", out)
    return out


def _remat_layer(layer: Block, x: torch.Tensor, positions: torch.Tensor,
                 ctx: Optional[torch.Tensor]) -> torch.Tensor:
    return layer(x, positions, None, ctx)[0]


def _run_blocks(model: Model, x: torch.Tensor, positions: torch.Tensor,
                ctx: Optional[torch.Tensor],
                caches: Optional[List[LayerCache]], remat: bool = False,
                fresh: bool = False):
    """``remat`` (training, no caches) rematerialises each block in the
    backward, as ``jax.checkpoint`` around each layer does in the
    reference: the block's forward, its kernels included, runs again.
    ``fresh``: ``caches`` are empty (``Block.forward``).  The residual
    stream is constrained (``set_activation_spec``) at the start of every
    pattern period and after the last, where the reference's scan body
    constrains it."""
    first, period = model.cfg.first_k_dense, len(model.cfg.pattern())
    new = []
    for i, layer in enumerate(model.layers):
        if i >= first and (i - first) % period == 0:
            x = _constrain(x)
        if remat and caches is None:
            x = checkpoint(_remat_layer, layer, x, positions, ctx,
                           use_reentrant=False)
            continue
        x, c = layer(x, positions, None if caches is None else caches[i],
                     ctx, fresh)
        new.append(c)
    x = _constrain(x)
    return x, (new if caches is not None else None)


def _mask_pad_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return logits.masked_fill(col >= cfg.vocab, -1e30)


def _embed(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows, in its dtype (bf16; float32 for a model made
    float32 with ``.float()``, which then runs in float32 throughout)."""
    return model.embed[tokens.long()]


def _context(model: Model, ctx: Optional[torch.Tensor]
             ) -> Optional[torch.Tensor]:
    """The context in the model's dtype (the reference casts it to its
    activation dtype, bf16)."""
    return None if ctx is None else ctx.to(model.embed.dtype)


def _backbone(model: Model, tokens: torch.Tensor,
              ctx: Optional[torch.Tensor] = None, remat: bool = False
              ) -> torch.Tensor:
    B, S = tokens.shape
    x = _embed(model, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    x, _ = _run_blocks(model, x, positions, _context(model, ctx), None,
                       remat=remat)
    return L.norm(model.final_norm.scale, x, model.cfg.norm)


def encode(model: Model, frames: torch.Tensor) -> torch.Tensor:
    """The encoder stack over precomputed frontend embeddings (B, S,
    d_model), in their dtype, then ``enc_final_norm``: non-causal
    attention without rope, through the flash kernel on whole
    sequences."""
    x = frames
    for layer in model.encoder:
        x = layer(x)
    return L.norm(model.enc_final_norm.scale, x, model.cfg.norm)


def forward(model: Model, tokens: torch.Tensor,
            ctx: Optional[torch.Tensor] = None, remat: bool = False
            ) -> torch.Tensor:
    """Training / prefill forward over every position.  tokens (B, S) ->
    logits (B, S, vocab_padded), pad columns at -1e30.  ``ctx``: the
    vision context or the encoder's output (B, T, d_model); without it
    an encoder-decoder's ``xattn`` is skipped, as in the reference."""
    x = _backbone(model, tokens, ctx, remat)
    return _mask_pad_logits(model.cfg,
                            L.einsum("bsd,dv->bsv", x, model.head()))


_CE_CHUNK = 4096  # token rows per chunked-CE step


def _ce_block(cfg: ModelConfig, xi: torch.Tensor, head: torch.Tensor,
              li: torch.Tensor) -> torch.Tensor:
    logits = _mask_pad_logits(cfg, L.einsum("nd,dv->nv", xi, head).float())
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, li[:, None].long())[:, 0]
    return torch.sum(logz - gold)


def _chunked_ce(cfg: ModelConfig, x: torch.Tensor, head: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy without materialising (B, S, V) logits: the token rows
    go in chunks of 4,096, each rematerialised in the backward (the
    reference's ``jax.checkpoint`` on its scan body), so the live logits
    are (chunk, V) float32.  The logits are the bf16 product widened to
    float32, pad vocab columns at -1e30.  Returns the mean over rows."""
    B, S, D = x.shape
    return _ce_sum(cfg, x, head, labels) / (B * S)


def _ce_sum(cfg: ModelConfig, x: torch.Tensor, head: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The summed cross-entropy of x's rows, chunk by chunk."""
    B, S, D = x.shape
    rows = B * S
    xf = x.reshape(rows, D)
    lf = labels.reshape(rows)
    chunk = min(_CE_CHUNK, rows)
    if rows % chunk:
        chunk = rows  # fall back for tiny odd shapes
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, rows, chunk):
        acc = acc + checkpoint(_ce_block, cfg, xf[s:s + chunk], head,
                               lf[s:s + chunk], use_reentrant=False)
    return acc


def loss_fn(model: Model, batch: Dict[str, torch.Tensor], remat: bool = True
            ) -> torch.Tensor:
    """Next-token cross-entropy (float32 scalar).  batch: tokens (B, S),
    labels (B, S); an encoder-decoder's ``frames`` (B, S_frames, d_model),
    which the encoder turns into the context (not rematerialised, as in
    the reference), or a vision model's ``vision_embeds`` (B, T,
    d_model), the context itself; each cast to the model's dtype."""
    cfg = model.cfg
    ctx = None
    if cfg.encoder_layers:
        ctx = encode(model, _context(model, batch["frames"]))
    elif cfg.frontend == "vision":
        ctx = batch["vision_embeds"]
    x = _backbone(model, batch["tokens"], ctx, remat=remat)
    return _chunked_ce(cfg, x, model.head(), batch["labels"])


def _init_layer_cache(cfg: ModelConfig, mixer: str, B: int, T: int,
                      device) -> LayerCache:
    if mixer == "mamba":
        return {"conv": torch.zeros((B, cfg.ssm_conv_width,
                                     cfg.d_inner + 2 * cfg.ssm_state),
                                    dtype=L.DTYPE, device=device),
                "ssm": torch.zeros((B, cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state), dtype=torch.float32,
                                   device=device)}
    if mixer == "cross_attn":
        return None
    if cfg.mla:
        return {"ckv": torch.zeros((B, T, cfg.kv_lora_rank), dtype=L.DTYPE,
                                   device=device),
                "kr": torch.zeros((B, T, cfg.qk_rope_dim), dtype=L.DTYPE,
                                  device=device),
                "len": torch.zeros((B,), dtype=torch.int32, device=device)}
    hd = cfg.head_dim
    return {"k": torch.zeros((B, T, cfg.n_kv_heads, hd), dtype=L.DTYPE,
                             device=device),
            "v": torch.zeros((B, T, cfg.n_kv_heads, hd), dtype=L.DTYPE,
                             device=device),
            "len": torch.zeros((B,), dtype=torch.int32, device=device)}


def init_cache(cfg: ModelConfig, B: int, max_len: int, device=None
               ) -> List[LayerCache]:
    """One cache per layer, in layer order: MLA's latent cache, the KV
    cache of attention, Mamba2's (conv, ssm) state, and None for a
    cross-attention layer."""
    dev = resolve_device(device)
    return [_init_layer_cache(cfg, mk, B, max_len, dev)
            for mk, _ in _layer_kinds(cfg)]


def decode_step(model: Model, tokens: torch.Tensor, pos: torch.Tensor,
                caches: List[LayerCache],
                ctx: Optional[torch.Tensor] = None):
    """One-token decode against the caches, which it updates in place.
    tokens: (B, 1); pos: (B,) absolute positions; ``ctx`` as in
    ``forward``.  Returns (logits (B, 1, vocab_padded), caches)."""
    if tokens.dim() != 2 or tokens.shape[1] != 1:
        raise ValueError(f"decode_step takes (B, 1) tokens, got "
                         f"{tuple(tokens.shape)}")
    x = _embed(model, tokens)
    x, caches = _run_blocks(model, x, pos[:, None], _context(model, ctx),
                            caches)
    x = L.norm(model.final_norm.scale, x, model.cfg.norm)
    logits = L.einsum("bsd,dv->bsv", x, model.head())
    return _mask_pad_logits(model.cfg, logits), caches
