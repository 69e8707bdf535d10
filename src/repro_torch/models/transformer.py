"""Decoder LM stack, the ``ssm`` family (Mamba-2).

The port of ``repro.models.transformer`` as far as the Mamba-2 serving
and training paths need it: parameter definitions, embedding, the
full-sequence ``forward`` and its ``loss_fn``, ``prefill`` (which also
builds the decode caches) and the O(1) ``decode_step``.  Layers run as an
unrolled Python loop over the stacked parameters (no scan or mesh); under
autograd with ``cfg.remat`` each layer is a non-reentrant
``torch.utils.checkpoint`` that keeps only its input and recomputes the
rest in the backward, as the reference's per-layer ``nothing_saveable``
remat does.  Any other family raises ``NotImplementedError`` (attention,
MoE and hybrid stacks are ROADMAP work).

Parameters are a nested dict of float32 master tensors with the
reference's leaf paths (``embed``, ``layers.ln1``, ``layers.ssm.z_proj``,
``ln_f``, ``unembed``), each cast to the activation dtype where it is
used.  ``params["layers"]`` is either the stacked dict or, from
``unstack_layers``, a list of per-layer dicts of views, which a trainer
differentiates leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import f32, resolve_device
from repro_torch.models import module as M
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import rms_norm
from repro_torch.models.module import ParamDef, stack_layer_defs


def _require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"repro_torch serves the 'ssm' family only; {cfg.name!r} is "
            f"{cfg.family!r} (see ROADMAP.md, queue 1)")


def _layer_defs(cfg: ModelConfig) -> dict:
    _require_ssm(cfg)
    d = cfg.d_model
    return {"ln1": ParamDef((d,), ("embed",), init="zeros"),
            "ssm": SSM.ssm_defs(cfg)}


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


def embed_tokens(params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Rows of the embedding in the activation dtype (``F.embedding``,
    whose backward sums duplicate tokens in a fixed order)."""
    return F.embedding(tokens.long(), params["embed"]).to(
        cfg.activation_dtype)


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in float32 from x in its dtype: the weight is cast to x's
    dtype, then both are contracted in float32."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _layer(lp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    y, _ = SSM.ssm_block(lp["ssm"], rms_norm(x, lp["ln1"], cfg.norm_eps),
                         cfg)
    return x + y


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            embeds: Optional[torch.Tensor] = None, mesh=None,
            unroll: bool = False,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (logits (B, S, V) float32, aux losses dict).  ``unroll`` is
    accepted and changes nothing (the layers are a Python loop already)."""
    _require_ssm(cfg)
    if embeds is not None:
        raise NotImplementedError(
            "embeds: repro_torch ports no modality frontend for the LM "
            "stack (see ROADMAP.md, queue 1)")
    if mesh is not None:
        raise NotImplementedError(
            "mesh: repro_torch runs the LM stack on one device (model "
            "sharding is ROADMAP.md, queue 1)")
    x = embed_tokens(params, tokens, cfg)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if remat:
            x = checkpoint(_layer, lp, x, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _layer(lp, x, cfg)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, x, cfg), {"lb_loss": zero, "z_loss": zero}


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, embeds=None, mesh=None,
            lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Mean next-token NLL from a float32 ``log_softmax`` of the token
    positions' logits, plus ``lb_coef * lb_loss + z_coef * z_loss``.
    Returns ``(total, {"loss", "lb_loss", "z_loss"})``."""
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


def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       dtype=None, device=None) -> List[dict]:
    """Per-layer cache dicts ``{"ssm": {"conv": {x, b, c}, "state"}}`` on
    ``device`` (default: the CUDA device).  ``max_len`` sizes attention
    caches, which the ssm family has none of."""
    _require_ssm(cfg)
    device = resolve_device(device)
    dtype = dtype or cfg.activation_dtype
    return [{"ssm": SSM.init_ssm_cache(cfg, batch, dtype, device)}
            for _ in range(cfg.n_layers)]


def decode_step(params, tokens: torch.Tensor, caches: List[dict], position,
                cfg: ModelConfig):
    """One token for the whole batch.  ``tokens`` (B, 1); ``position``,
    the absolute position of this token, is unused by the ssm family.
    Returns (logits (B, 1, V), caches)."""
    _require_ssm(cfg)
    x = embed_tokens(params, tokens, cfg)
    new_caches = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        c = caches[i]["ssm"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, (conv, state) = SSM.ssm_decode_step(lp["ssm"], h, cfg, c["conv"],
                                               c["state"])
        x = x + y
        new_caches.append({"ssm": {"conv": conv, "state": state}})
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, x, cfg), new_caches


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int,
            last_logits_only: bool = False):
    """Forward pass that also builds the decode caches (each layer's conv
    ring and SSM state).  ``last_logits_only`` unembeds just the final
    position.  Returns (logits, caches, next_position)."""
    _require_ssm(cfg)
    x = embed_tokens(params, tokens, cfg)
    s_total = x.shape[1]
    caches: List[Dict[str, Any]] = []
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, (conv, state) = SSM.ssm_block(lp["ssm"], h, cfg)
        x = x + y
        caches.append({"ssm": {"conv": conv, "state": state}})
    if last_logits_only:
        x = x[:, -1:]
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, x, cfg), caches, s_total
