"""Mixture-of-Experts feed-forward layers: top-k routing with the
switch-style load-balance and router z aux losses, the exact dense form
of the expert mixture, and its capacity-packed form over a mesh.

The port of ``repro.models.moe``.  ``moe_dense`` is what the reference
runs without a mesh: every expert runs over every token, and a float32
accumulator adds the experts' weighted outputs in ascending expert
order, then the shared expert's (kimi-k2) in float32, before one cast to
the activation dtype.  Each expert's float32 master weights are cast to
the activation dtype inside the loop, one expert at a time.

``moe_sharded`` is what the reference runs whenever there is a mesh,
even one of a single rank.  Each rank routes its own rows (the batch is
split over the data axes and replicated over ``"model"``), packs for
each of its experts the first ``capacity`` tokens routed there, in
token order (a token past it is dropped), and adds their weighted
outputs back with one ``index_add_``.  ``"ep"`` (E divisible by the
model axis): each model rank holds E/m whole experts; ``"tp"``: every
rank holds every expert's FFN split over ``d_ff_expert``.  One sum over
``"model"`` joins the partial outputs.  Capacity drops make it differ
from ``moe_dense``.  The aux losses are the mean over the data ranks of
each rank's own (the reference's ``pmean``); their gradient is each
rank's own, since the loss is then averaged over the data ranks.

Routing ties: ``jax.lax.top_k`` keeps the lower expert index first among
equal probabilities (an all-zero input ties every expert);
``torch.topk`` promises no order, so ``route`` takes a stable descending
sort instead.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
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


# ----------------------------------------------------------- over a mesh

def moe_strategy(cfg: ModelConfig, model_size: int) -> str:
    if cfg.n_experts % model_size == 0:
        return "ep"
    if model_size % cfg.n_experts == 0 and cfg.d_ff_expert % model_size == 0:
        return "tp"
    raise ValueError(
        f"experts={cfg.n_experts} not compatible with model axis {model_size}")


def expert_weight_specs(cfg: ModelConfig, model_size: int, fsdp_axis=None):
    """Specs of (we_gate / we_up (E, d, f), we_down (E, f, d))."""
    if moe_strategy(cfg, model_size) == "ep":
        return ("model", fsdp_axis, None), ("model", None, fsdp_axis)
    return (None, fsdp_axis, "model"), (None, "model", fsdp_axis)


def _pack_compute_all(x_flat, top_idx, top_w, expert_ids, wg, wu, wd,
                      cap: int) -> torch.Tensor:
    """Capacity-packed compute for a set of experts at once.

    x_flat (T, d); expert_ids (E_loc,) global ids; wg / wu (E_loc, d, f);
    wd (E_loc, f, d).  Each expert takes its selected tokens first, in
    token order (a stable sort, as ``jnp.argsort(~sel, stable=True)``),
    up to ``cap`` of them.  Returns the weighted combine (T, d) float32,
    added with ``index_add_``."""
    t, d = x_flat.shape
    e_loc = expert_ids.shape[0]
    # per-token gate weight of each local expert: (T, E_loc)
    gate = torch.where(top_idx[:, None, :] == expert_ids[None, :, None],
                       top_w[:, None, :], 0.0).sum(-1)
    order = torch.sort((gate <= 0).to(torch.uint8), dim=0,
                       stable=True).indices       # selected tokens first
    idx = order[:cap].T                           # (E_loc, cap)
    gsel = torch.gather(gate, 0, idx.T).T         # (E_loc, cap)
    dt = x_flat.dtype
    xe = x_flat[idx.reshape(-1)].reshape(e_loc, cap, d)
    h = (F.gelu(torch.bmm(xe, wg.to(dt)).to(F32), approximate="tanh")
         .to(dt) * torch.bmm(xe, wu.to(dt)))
    y = torch.bmm(h, wd.to(dt)).to(F32)
    contrib = (y * gsel[..., None]).reshape(e_loc * cap, d)
    out = torch.zeros((t, d), dtype=F32, device=x_flat.device)
    return out.index_add(0, idx.reshape(-1), contrib)


def check_rows(cfg: ModelConfig, rows: int, n_data: int, batch: int
               ) -> None:
    """Refuse a microbatch of ``rows`` rows (of a batch of ``batch``) that
    ``n_data`` data ranks do not divide: ``moe_sharded`` routes and counts
    each rank's rows, so it takes no pad rows, and the reference's
    ``shard_map`` refuses such a microbatch."""
    if rows % n_data:
        raise ValueError(
            f"{cfg.name}: the expert layers (moe_sharded) split each "
            f"microbatch's rows evenly over the data ranks; batch {batch} "
            f"gives microbatches of {rows} rows, which {n_data} data ranks "
            f"do not divide")


def moe_sharded(params, x: torch.Tensor, cfg: ModelConfig, mesh,
                data_axes: Tuple[str, ...] = ("data",)
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The expert mixture of this rank's rows ``x`` (B_loc, S, d) over
    ``mesh``.  ``params`` hold this rank's blocks of the expert weights
    over ``"model"`` (``expert_weight_specs`` without an FSDP axis: the
    caller gathers FSDP blocks first, as ``transformer.forward`` does
    for each layer) and the whole router.  Returns (y in x's dtype, aux
    losses)."""
    m_size = mesh.shape["model"]
    strat = moe_strategy(cfg, m_size)
    e_loc = cfg.n_experts // m_size if strat == "ep" else cfg.n_experts
    b, s, d = x.shape
    cap = capacity(b * s, cfg, m_size)
    wg, wu, wd = params["we_gate"], params["we_up"], params["we_down"]
    xf = x.reshape(-1, d)
    top_idx, top_w, aux = route(params["router"], xf, cfg)
    if strat == "ep":
        mi = mesh.coords["model"] if m_size > 1 else 0
        expert_ids = mi * e_loc + torch.arange(e_loc, device=x.device)
    else:  # "tp": every expert present, f-split; the sum joins partials
        expert_ids = torch.arange(cfg.n_experts, device=x.device)
    y = _pack_compute_all(SH.enter(xf, mesh), top_idx,
                          SH.enter(top_w, mesh), expert_ids, wg, wu, wd,
                          cap)
    y = SH.leave(y, mesh).reshape(x.shape).to(x.dtype)
    n_data = mesh.count(data_axes)
    if n_data > 1:
        # the data ranks' mean as the value; each rank's own gradient
        vals = torch.stack([aux["lb_loss"], aux["z_loss"]]).detach()
        mean = SH.all_reduce_(vals.clone(), mesh, data_axes) / n_data
        aux = {k: v + (mv - v.detach())
               for (k, v), mv in zip(aux.items(), mean)}
    if cfg.n_shared_experts:
        y = y + shared_mlp(params["shared"], x, cfg, mesh)
    return y, aux


def shared_mlp(params, x: torch.Tensor, cfg: ModelConfig, mesh=None
               ) -> torch.Tensor:
    """The gated MLP, split over ``"model"`` where the rules split its
    ``mlp`` dim (column- then row-parallel, one sum)."""
    if mesh is None or SH.logical_rules(cfg, mesh)["mlp"] is None:
        return L.mlp_block(params, x)
    return SH.leave(L.mlp_block(params, SH.enter(x, mesh)), mesh)
