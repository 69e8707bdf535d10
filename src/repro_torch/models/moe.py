"""Mixture-of-Experts feed-forward layers: top-k routing with the
switch-style load-balance and router z aux losses, and the exact dense
form of the expert mixture.

The port of ``repro.models.moe`` on one device.  ``moe_dense`` is what
the reference runs without a mesh: every expert runs over every token,
and a float32 accumulator adds the experts' weighted outputs in
ascending expert order, then the shared expert's (kimi-k2) in float32,
before one cast to the activation dtype.  Each expert's float32 master
weights are cast to the activation dtype inside the loop, one expert at
a time.  The reference's capacity-packed, sharded path
(``_pack_compute_all``, ``moe_strategy``, ``expert_weight_specs``,
``moe_sharded``) runs only under a mesh and is not ported (ROADMAP.md,
queue 1).

Routing ties: ``jax.lax.top_k`` keeps the lower expert index first among
equal probabilities (an all-zero input ties every expert);
``torch.topk`` promises no order, so ``route`` takes a stable descending
sort instead.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.module import ParamDef

F32 = torch.float32


def moe_defs(cfg: ModelConfig) -> dict:
    d, e, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    defs = {
        "router": ParamDef((d, e), ("embed", "experts_router")),
        "we_gate": ParamDef((e, d, fe), ("experts", "embed", "expert_mlp")),
        "we_up": ParamDef((e, d, fe), ("experts", "embed", "expert_mlp")),
        "we_down": ParamDef((e, fe, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        defs["shared"] = L.mlp_defs(cfg, cfg.n_shared_experts * fe)
    return defs


def route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k routing of (T, d) tokens.  Returns (top_idx (T, k) int64,
    top_w (T, k) float32 renormalised to sum 1, {"lb_loss", "z_loss"}):
    the router logits in float32, their softmax, the k most probable
    experts (ties to the lower index), ``lb_loss = E * sum_e f_e * p_e``
    (f_e the share of the T * k choices that went to e, p_e the mean
    probability of e) and ``z_loss = mean(logsumexp(logits) ** 2)``."""
    logits = x_flat.to(F32) @ router_w.to(F32)
    # jax.nn.softmax's formula: a division by the sum (torch.softmax on
    # the CPU multiplies by its reciprocal)
    ex = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = ex / ex.sum(-1, keepdim=True)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_idx = srt[:, :cfg.top_k], idx[:, :cfg.top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    e = cfg.n_experts
    counts = torch.zeros(e, dtype=F32, device=logits.device).index_add_(
        0, top_idx.reshape(-1),
        torch.ones(top_idx.numel(), dtype=F32, device=logits.device))
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    lb_loss = e * torch.sum(frac * probs.mean(dim=0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_idx, top_w, {"lb_loss": lb_loss, "z_loss": z_loss}


def capacity(n_tokens: int, cfg: ModelConfig, n_parts: int) -> int:
    """Static per-expert capacity of the reference's packed path,
    clamped to the local token count."""
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return int(min(n_tokens, max(8, c)))


def moe_dense(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The exact mixture of (B, S, d) tokens, no capacity drops.  Returns
    (y in x's dtype, aux losses)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    top_idx, top_w, aux = route(params["router"], xf, cfg)
    y = torch.zeros(xf.shape, dtype=F32, device=x.device)
    for e in range(cfg.n_experts):
        w_e = torch.where(top_idx == e, top_w, 0.0).sum(-1)
        # the gated MLP with the tanh GELU in float32, cast back before
        # it gates the up-projection; the weights cast at their use
        ye = L.mlp_block({"wi_gate": params["we_gate"][e],
                          "wi_up": params["we_up"][e],
                          "wo": params["we_down"][e]}, xf)
        y = y + ye.to(F32) * w_e[:, None]
    if cfg.n_shared_experts:
        y = y + L.mlp_block(params["shared"], x).reshape(-1, d).to(F32)
    return y.reshape(b, s, d).to(x.dtype), aux
