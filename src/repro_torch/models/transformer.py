"""Decoder LM stack: the ``dense`` family (GQA attention and the gated
MLP), the ``moe`` family (attention and a top-k mixture of experts), the
``ssm`` family (Mamba-2) and the ``hybrid`` family (hymba: attention and
a Mamba-2 head side by side in every layer).

The port of ``repro.models.transformer`` on one device: parameter
definitions, embedding (with a frontend's ``embeds`` prepended), the
full-sequence ``forward`` and its ``loss_fn``, ``prefill`` (which also
builds the decode caches) and ``decode_step``.  Layers run as an
unrolled Python loop over the stacked parameters (no scan or mesh);
under autograd with ``cfg.remat`` each layer is a non-reentrant
``torch.utils.checkpoint`` that keeps only its input and recomputes the
rest in the backward, as the reference's per-layer ``nothing_saveable``
remat does.

A hybrid layer normalises both branches and averages them,
``0.5 * (rms_norm(attn) + rms_norm(ssm))``, attention first.  An expert
layer runs ``moe.moe_dense`` (the reference's single-device form) and
``forward`` returns the mean over the expert layers of each of its aux
losses (``lb_loss``, ``z_loss``; 0 without experts), as both of the
reference's modes do; ``prefill`` and ``decode_step`` drop them.

Decode caches, one dict per layer: an attention layer keeps ``k``, ``v``
(B, S, K, D) and ``pos`` (B, S) int32, a ring of ``min(window, max_len)``
slots for a local layer (slot ``p % S`` holds position ``p``; an empty
slot's position is -1) and ``max_len`` for a global one; with
``kv_cache_dtype="int8"`` ``k`` and ``v`` are int8 with bf16
``k_scale`` / ``v_scale`` (B, S, K, 1).  ``decode_step`` writes the new
token into the caches it is given, in place, and returns them.  An SSM
layer keeps ``{"ssm": {"conv": {x, b, c}, "state"}}``; a hybrid layer
keeps both in one dict.

Parameters are a nested dict of float32 master tensors with the
reference's leaf paths (``embed``, ``layers.ln1``, ``layers.attn.wq``,
``layers.mlp.wi_gate``, ``layers.moe.we_gate``, ``layers.ssm.z_proj``,
``ln_f``, ``unembed``), each cast to the activation dtype where it is
used.  ``params["layers"]`` is either the stacked dict or, from
``unstack_layers``, a list of per-layer dicts of views, which a trainer
differentiates leaf by leaf.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import f32, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import module as M
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import rms_norm
from repro_torch.models.module import ParamDef, stack_layer_defs


def _layer_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    norm = lambda: ParamDef((d,), ("embed",), init="zeros")
    defs = {"ln1": norm()}
    if cfg.family == "ssm":
        defs["ssm"] = SSM.ssm_defs(cfg)
        return defs
    defs["attn"] = L.attention_defs(cfg)
    if cfg.family == "hybrid":
        defs["ssm"] = SSM.ssm_defs(cfg)
        defs["attn_out_norm"] = norm()
        defs["ssm_out_norm"] = norm()
    defs["ln2"] = norm()
    if cfg.n_experts:
        defs["moe"] = MOE.moe_defs(cfg)
    elif cfg.d_ff:
        defs["mlp"] = L.mlp_defs(cfg)
    return defs


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Each layer's attention window (None = global)."""
    return [None if k in ("global", "hybrid_global") else cfg.window
            for k in cfg.layer_kinds()]


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab padded to a multiple of 256 (the reference's sharding pad)."""
    return -(-cfg.vocab // 256) * 256


def param_defs(cfg: ModelConfig) -> dict:
    v = padded_vocab(cfg)
    defs = {
        "embed": ParamDef((v, cfg.d_model), ("vocab", "embed"),
                          init="embed", scale=0.02),
        "layers": stack_layer_defs(_layer_defs(cfg), cfg.n_layers),
        "ln_f": ParamDef((cfg.d_model,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, v), ("embed", "vocab"))
    return defs


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s parameters: its entry of an unstacked
    ``params["layers"]``, or its slice (views) of the stacked one."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers[i]

    def take(tree):
        return {k: take(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return take(layers)


def unstack_layers(params) -> dict:
    """``params`` with ``"layers"`` as a list of per-layer dicts, each
    leaf a view of its slice of the stacked tensor (no copy)."""
    n = next(iter(M.flatten(params["layers"]).values())).shape[0]
    return {**params, "layers": [layer_params(params, i) for i in range(n)]}


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows of the embedding in the activation dtype (``F.embedding``,
    whose backward sums duplicate tokens in a fixed order), with a
    frontend's ``embeds`` (B, F, D) prepended when the config has a
    frontend (without one, ``embeds`` is ignored, as in the
    reference)."""
    x = F.embedding(tokens.long(), params["embed"]).to(cfg.activation_dtype)
    if cfg.frontend != "none" and embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in float32 from x in its dtype: the weight is cast to x's
    dtype, then both are contracted in float32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig, aux_sink=None
         ) -> torch.Tensor:
    """x plus the layer's feed-forward of ``rms_norm(x)``: the gated MLP,
    or the expert mixture, whose aux losses go to ``aux_sink`` when one
    is given; an SSM layer has none."""
    if cfg.family == "ssm":
        return x
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        y, aux = MOE.moe_dense(lp["moe"], h, cfg)
        if aux_sink is not None:
            aux_sink.append(aux)
    else:
        y = L.mlp_block(lp["mlp"], h)
    return x + y


def _fuse(lp, branches: List[torch.Tensor], cfg: ModelConfig
          ) -> torch.Tensor:
    """The token mixer's output from its branches (attention, SSM): the
    one branch, or hymba's ``0.5 * (rms_norm(attn) + rms_norm(ssm))``."""
    if cfg.family != "hybrid":
        return branches[0]
    attn, ssm_y = branches
    return 0.5 * (rms_norm(attn, lp["attn_out_norm"], cfg.norm_eps)
                  + rms_norm(ssm_y, lp["ssm_out_norm"], cfg.norm_eps))


def _mix(lp, h: torch.Tensor, cfg: ModelConfig, window: Optional[int],
         positions: torch.Tensor, cache_len: Optional[int] = None):
    """The token mixer of a layer on its normed input ``h``: causal
    attention over ``window`` keys back (None: all), then the SSM, fused.
    Returns (the mixer's output, the layer's decode cache: the K/V ring
    of ``cache_len`` slots when one is asked for, the SSM's conv rings
    and state)."""
    branches, cache = [], {}
    if cfg.family != "ssm":
        ap = lp["attn"]
        q, k, v = L.attention_qkv(ap, h, cfg, positions)
        out = L.blockwise_attention(q, k, v, causal=True, window=window,
                                    softcap=cfg.attn_logit_softcap)
        branches.append(L.attention_out(out, ap["wo"]))
        if cache_len is not None:
            cache.update(_fill_ring(k, v, h.shape[1], cache_len))
    if cfg.family in ("ssm", "hybrid"):
        y, (conv, state) = SSM.ssm_block(lp["ssm"], h, cfg)
        branches.append(y)
        cache["ssm"] = {"conv": conv, "state": state}
    return _fuse(lp, branches, cfg), cache


def _layer(lp, x: torch.Tensor, cfg: ModelConfig, window: Optional[int],
           positions: torch.Tensor):
    """One layer of ``forward``: (its output, the aux losses of its
    expert mixture or None)."""
    sink: List[dict] = []
    y, _ = _mix(lp, rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, window,
                positions)
    x = _ffn(lp, x + y, cfg, sink)
    return x, (sink[0] if sink else None)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            embeds: Optional[torch.Tensor] = None, mesh=None,
            unroll: bool = False,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (logits (B, F + S, V) float32, aux losses dict: each the
    mean over the expert layers, 0 without them), F the frontend
    positions of ``embeds``.  ``unroll`` is accepted and changes nothing
    (the layers are a Python loop already)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: repro_torch runs the LM stack on one device (model "
            "sharding is ROADMAP.md, queue 1)")
    x = embed_tokens(params, tokens, cfg, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params, i)
        if remat:
            x, aux = checkpoint(_layer, lp, x, cfg, window, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _layer(lp, x, cfg, window, positions)
        if aux is not None:
            auxes.append(aux)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if auxes:
        aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    else:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"lb_loss": zero, "z_loss": zero}
    return unembed(params, x, cfg), aux


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, embeds=None, mesh=None,
            lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Mean next-token NLL from a float32 ``log_softmax`` of the token
    positions' logits (a frontend's positions predict nothing), plus
    ``lb_coef * lb_loss + z_coef * z_loss``.  Returns ``(total, {"loss",
    "lb_loss", "z_loss"})``."""
    logits, aux = forward(params, tokens, cfg, embeds=embeds, mesh=mesh)
    tok_logits = logits[:, -tokens.shape[1]:, :]
    lp = torch.log_softmax(tok_logits.to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    loss = nll.mean()
    dev = loss.device
    total = (loss + f32(lb_coef, dev) * aux["lb_loss"]
             + f32(z_coef, dev) * aux["z_loss"])
    return total, {"loss": loss, "lb_loss": aux["lb_loss"],
                   "z_loss": aux["z_loss"]}


# ------------------------------------------------------------- serving

def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization per (token, head) of K or V: the codes
    ``round(x / scale)`` (half to even) clipped to [-127, 127], and the
    scale ``max(max|x| / 127, 1e-8)`` in bf16."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(-1, keepdim=True) / f32(127.0, x.device)
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def _cache_len(window: Optional[int], max_len: int) -> int:
    return max_len if window is None else min(window, max_len)


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=None, device=None) -> List[dict]:
    """Per-layer empty cache dicts (see the module docstring) on
    ``device`` (default: the CUDA device; raises when there is none)."""
    device = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    caches = []
    for window in layer_windows(cfg):
        c = {}
        if cfg.family in ("ssm", "hybrid"):
            c["ssm"] = SSM.init_ssm_cache(cfg, batch, dtype, device)
        if cfg.family == "ssm":
            caches.append(c)
            continue
        s = _cache_len(window, max_len)
        kh, hd = cfg.n_kv_heads, cfg.head_dim
        z = lambda dt, last=hd: torch.zeros((batch, s, kh, last), dtype=dt,
                                            device=device)
        if cfg.kv_cache_dtype == "int8":
            c.update(k=z(torch.int8), v=z(torch.int8),
                     k_scale=z(torch.bfloat16, 1),
                     v_scale=z(torch.bfloat16, 1))
        else:
            c.update(k=z(dtype), v=z(dtype))
        c["pos"] = torch.full((batch, s), -1, dtype=torch.int32,
                              device=device)
        caches.append(c)
    return caches


def _decode_attn(ap, h: torch.Tensor, c: dict, position: int,
                 positions: torch.Tensor, cfg: ModelConfig,
                 window: Optional[int]) -> torch.Tensor:
    """The attention branch of one decode step: the token's K and V go
    into slot ``position % S`` of the layer's cache ``c`` (in place), then
    the query attends over the cache.  ``positions`` is ``position`` as a
    (1,) tensor on the data's device."""
    q, k, v = L.attention_qkv(ap, h, cfg, positions)
    slot = position % c["k"].shape[1]
    if cfg.kv_cache_dtype == "int8":
        if c["k"].dtype != torch.int8:
            raise TypeError(
                f"an int8 kv cache decodes from init_decode_caches' int8 "
                f"layout; this cache holds {c['k'].dtype} K/V (prefill "
                f"builds unquantized caches, as the reference's does)")
        (c["k"][:, slot], c["k_scale"][:, slot]) = kv_quantize(k[:, 0])
        (c["v"][:, slot], c["v_scale"][:, slot]) = kv_quantize(v[:, 0])
        k_full = kv_dequantize(c["k"], c["k_scale"], h.dtype)
        v_full = kv_dequantize(c["v"], c["v_scale"], h.dtype)
    else:
        c["k"][:, slot] = k[:, 0]
        c["v"][:, slot] = v[:, 0]
        k_full, v_full = c["k"], c["v"]
    c["pos"][:, slot] = position
    out = L.decode_attention(q, k_full, v_full, c["pos"], position,
                             window=window, softcap=cfg.attn_logit_softcap)
    return L.attention_out(out, ap["wo"])


def decode_step(params, tokens: torch.Tensor, caches: List[dict], position,
                cfg: ModelConfig):
    """One token for the whole batch.  ``tokens`` (B, 1); ``position``
    (an int) is the absolute position of this token.  Attention caches are
    updated in place; an SSM's conv rings and state are new tensors in
    the returned caches.  Returns (logits (B, 1, V), caches)."""
    position = int(position)
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(position, position + 1, device=x.device)
    new_caches = []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params, i)
        c = dict(caches[i])
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        branches = []
        if cfg.family != "ssm":
            branches.append(_decode_attn(lp["attn"], h, c, position,
                                         positions, cfg, window))
        if cfg.family in ("ssm", "hybrid"):
            y, (conv, state) = SSM.ssm_decode_step(
                lp["ssm"], h, cfg, c["ssm"]["conv"], c["ssm"]["state"])
            branches.append(y)
            c["ssm"] = {"conv": conv, "state": state}
        x = _ffn(lp, x + _fuse(lp, branches, cfg), cfg)
        new_caches.append(c)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, x, cfg), new_caches


def _fill_ring(k: torch.Tensor, v: torch.Tensor, s_total: int,
               s_cache: int) -> dict:
    """The prefilled K/V (B, S, K, D) as a cache of ``s_cache`` slots whose
    slot ``p % s_cache`` holds position ``p``: the whole prompt padded
    with empty slots (position -1), or its last ``s_cache`` positions
    rolled into place."""
    b = k.shape[0]
    pos = torch.arange(s_total, dtype=torch.int32, device=k.device)
    if s_total <= s_cache:
        pad = s_cache - s_total
        kk = F.pad(k, (0, 0, 0, 0, 0, pad))
        vv = F.pad(v, (0, 0, 0, 0, 0, pad))
        pp = F.pad(pos, (0, pad), value=-1)
    else:
        tail = s_total - s_cache
        shift = tail % s_cache
        kk = torch.roll(k[:, tail:], shift, dims=1)
        vv = torch.roll(v[:, tail:], shift, dims=1)
        pp = torch.roll(pos[tail:], shift)
    return {"k": kk, "v": vv, "pos": pp[None].expand(b, s_cache).clone()}


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            embeds: Optional[torch.Tensor] = None,
            last_logits_only: bool = False):
    """Forward pass that also builds the decode caches: each attention
    layer's K/V as a ring (``_fill_ring``; unquantized whatever
    ``kv_cache_dtype`` says, as in the reference), each SSM layer's conv
    ring and state.  Positions count ``embeds``' frontend positions first.
    ``last_logits_only`` unembeds just the final position.  Returns
    (logits, caches, next_position)."""
    x = embed_tokens(params, tokens, cfg, embeds)
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)
    caches: List[dict] = []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params, i)
        y, cache = _mix(lp, rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                        window, positions, _cache_len(window, max_len))
        x = _ffn(lp, x + y, cfg)
        caches.append(cache)
    if last_logits_only:
        x = x[:, -1:]
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, x, cfg), caches, s_total
