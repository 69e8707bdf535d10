"""Decoder LM stack: the ``dense`` family (GQA attention and the gated
MLP), the ``moe`` family (attention and a top-k mixture of experts), the
``ssm`` family (Mamba-2) and the ``hybrid`` family (hymba: attention and
a Mamba-2 head side by side in every layer).

The port of ``repro.models.transformer``: parameter definitions,
embedding (with a frontend's ``embeds`` prepended), the full-sequence
``forward`` and its ``loss_fn``, ``prefill`` (which also builds the
decode caches) and ``decode_step``, each on one device or over a mesh,
and the dry run's stacked forms (``prefill_scan``, ``decode_step_scan``
on ``stack_caches``, ``abstract_decode_caches``).  Layers run as an
unrolled Python loop over the stacked parameters; under autograd with
``cfg.remat`` each layer is a non-reentrant ``torch.utils.checkpoint``
that keeps only its input and recomputes the rest in the backward, as
the reference's per-layer ``nothing_saveable`` remat does.

Over a mesh (``distributed.mesh.ProcessMesh``) every rank runs ``forward``
on its own rows of the batch with its blocks of the parameters
(``distributed.sharding.param_shardings``).  Each layer gathers its
leaves' FSDP blocks over the data axes inside its checkpoint, so the
recompute gathers again, and their gradients reduce-scatter back.  The
``"model"`` axis is Megatron tensor parallelism where the rules split
it: column-parallel Q/K/V and ``wi_gate`` / ``wi_up``, row-parallel
``wo`` / ``wi_down`` with one sum over ``"model"``; the embedding is
vocab-parallel (a masked lookup and a sum), and so are the unembedding
and ``loss_fn``'s ``log_softmax`` (a max and a sum over the vocab
shards).  A replicated tensor entering a split region sums its
gradient over ``"model"`` (Megatron's f), so every rank ends a step
with the whole gradient of each replicated leaf.  Where the rules
split a dim that does not divide, they replicate it (glm4's 2 KV
heads: each rank picks the KV heads of its query heads).  The SSD
block has no split of its own: it gathers its ``ssm_inner`` /
``ssm_heads`` leaves over ``"model"`` at use and runs whole on every
rank (its gated RMSNorm reduces over the inner dim).  An expert layer
runs ``moe.moe_sharded`` whenever there is a mesh, as the reference's
does.  At a mesh of one rank every collective is the identity and the
arithmetic is the one-device path's.

Serving over a mesh keeps each rank's rows of the batch and its block of
every cache (``sharding.cache_placements``: the batch over the data
axes that divide it, the K/V rings' sequence over ``cache_seq_axes``,
the flash-decoding layout).  ``prefill`` gathers each layer's KV heads
over a split ``"model"`` axis and keeps the rank's slots of the ring;
``decode_step`` gathers the token's q and K/V over the heads, lets the
rank that owns slot ``position % S`` write it, attends with every head
over the rank's slots and merges the partial softmax sums over the axes
that split the sequence (``layers.merge_partials``), then keeps the
rank's heads for the row-parallel ``wo``.  Where no axis splits a
cache's sequence it runs ``decode_attention`` unchanged, so a mesh of one
rank stays bitwise the one-device path.

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
keeps both in one dict.  For an all-SSM model on one device,
``DecodeGraphs`` holds two such sets at fixed addresses: ``prefill``
fills one in place, each ``decode_step`` writes the other, and on a card
replays a CUDA graph of the whole step.

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
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import ProcessMesh, check_mesh
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
    return _index(layers, i)


def _index(tree, i: int) -> dict:
    """Entry ``i`` of every leaf of a nested dict (views)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def unstack_layers(params) -> dict:
    """``params`` with ``"layers"`` as a list of per-layer dicts, each
    leaf a view of its slice of the stacked tensor (no copy)."""
    n = next(iter(M.flatten(params["layers"]).values())).shape[0]
    return {**params, "layers": [layer_params(params, i) for i in range(n)]}


class _Plan:
    """How ``forward`` runs over a mesh: the leaves' placements, which
    regions the ``"model"`` axis splits, and this rank's model index."""

    def __init__(self, cfg: ModelConfig, mesh: ProcessMesh, data_axes):
        check_mesh(mesh)
        self.mesh, self.data_axes = mesh, tuple(data_axes)
        self.pl = M.flatten(SH.placements(cfg, mesh))
        self.layer_pl = {k[len("layers."):]: SH.Placement(
            p.shape[1:], p.spec[1:], mesh)
            for k, p in self.pl.items() if k.startswith("layers.")}
        rules = SH.logical_rules(cfg, mesh)
        self.m = mesh.shape["model"]
        split = lambda name: self.m > 1 and rules[name] == "model"
        self.heads, self.kv, self.mlp = (split("heads"), split("kv_heads"),
                                         split("mlp"))
        self.mi = mesh.coords["model"]

    def gather(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """A top-level leaf's FSDP blocks gathered over the data axes."""
        return SH.gather_leaf(x, self.pl[path], self.data_axes)

    def gather_layer(self, lp: dict) -> dict:
        """A layer's leaves gathered over the data axes, and the SSD
        block's over ``"model"`` too."""
        out = {}
        for k, x in M.flatten(lp).items():
            axes = self.data_axes + (("model",) if k.startswith("ssm.")
                                     else ())
            out[k] = SH.gather_leaf(x, self.layer_pl[k], axes)
        return M.unflatten(out)


def _plan(cfg: ModelConfig, mesh, data_axes) -> Optional[_Plan]:
    return None if mesh is None else _Plan(cfg, mesh, data_axes)


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 embeds: Optional[torch.Tensor] = None, plan=None
                 ) -> torch.Tensor:
    """Rows of the embedding in the activation dtype (``F.embedding``,
    whose backward sums duplicate tokens in a fixed order), with a
    frontend's ``embeds`` (B, F, D) prepended when the config has a
    frontend (without one, ``embeds`` is ignored, as in the
    reference).  Vocab-parallel over a split ``"model"`` axis."""
    w = params["embed"]
    if plan is not None:
        w = plan.gather(w, "embed")
    if plan is not None and plan.m > 1:
        t = tokens.long() - plan.mi * w.shape[0]
        inside = (t >= 0) & (t < w.shape[0])
        rows = F.embedding(torch.where(inside, t, 0), w)
        x = SH.leave(torch.where(inside[..., None], rows, 0.0), plan.mesh)
    else:
        x = F.embedding(tokens.long(), w)
    x = x.to(cfg.activation_dtype)
    if cfg.frontend != "none" and embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def unembed(params, x: torch.Tensor, cfg: ModelConfig, plan=None
            ) -> torch.Tensor:
    """Logits in float32 from x in its dtype: the weight is cast to x's
    dtype, then both are contracted in float32.  Over a split
    ``"model"`` axis, this rank's vocab shard of them."""
    if plan is None:
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    elif cfg.tie_embeddings:
        w = plan.gather(params["embed"], "embed").T
    else:
        w = plan.gather(params["unembed"], "unembed")
    if plan is not None and plan.m > 1:
        x = SH.enter(x, plan.mesh)
    logits = x.to(torch.float32) @ w.to(x.dtype).to(torch.float32)
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _ffn(lp, x: torch.Tensor, cfg: ModelConfig, aux_sink=None, plan=None
         ) -> torch.Tensor:
    """x plus the layer's feed-forward of ``rms_norm(x)``: the gated MLP,
    or the expert mixture, whose aux losses go to ``aux_sink`` when one
    is given; an SSM layer has none."""
    if cfg.family == "ssm":
        return x
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.n_experts:
        if plan is None:
            y, aux = MOE.moe_dense(lp["moe"], h, cfg)
        else:
            y, aux = MOE.moe_sharded(lp["moe"], h, cfg, plan.mesh,
                                     data_axes=plan.data_axes)
        if aux_sink is not None:
            aux_sink.append(aux)
    elif plan is not None and plan.mlp:
        y = SH.leave(L.mlp_block(lp["mlp"], SH.enter(h, plan.mesh)),
                     plan.mesh)
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


def _local_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
              plan: _Plan):
    """The K/V heads of this rank's query heads, where the query heads
    split over ``"model"`` and the KV heads do not."""
    hl = cfg.n_heads // plan.m
    g = cfg.n_heads // cfg.n_kv_heads
    lo = plan.mi * hl
    if hl % g == 0:
        sl = slice(lo // g, (lo + hl) // g)
        return k[:, :, sl], v[:, :, sl]
    idx = (lo + torch.arange(hl, device=k.device)) // g
    return k[:, :, idx], v[:, :, idx]


def _attention(ap, h: torch.Tensor, cfg: ModelConfig, window, positions,
               plan=None, cache_kv: bool = False):
    """The attention branch: (output, k, v); over a split ``"model"``
    axis, this rank's heads (column-parallel) and one sum after ``wo``
    (row-parallel).  With ``cache_kv`` the k and v returned hold every
    KV head (gathered over ``"model"`` where it splits them), as a
    decode cache keeps them."""
    split = plan is not None and plan.heads
    if split:
        h = SH.enter(h, plan.mesh)
        # the replicated leaves serve only this rank's heads
        own = {"wq", "wo"} | ({"wk", "wv"} if plan.kv else set())
        ap = {n: w if n in own else SH.enter(w, plan.mesh)
              for n, w in ap.items()}
    q, k, v = L.attention_qkv(ap, h, cfg, positions)
    kc, vc = k, v
    if split and not plan.kv:
        k, v = _local_kv(k, v, cfg, plan)
    elif split and cache_kv:
        kc, vc = (SH.all_gather_dim(t, plan.mesh, "model", 2) for t in (k, v))
    out = L.blockwise_attention(q, k, v, causal=True, window=window,
                                softcap=cfg.attn_logit_softcap)
    out = L.attention_out(out, ap["wo"])
    return (SH.leave(out, plan.mesh) if split else out), kc, vc


def _mix(lp, h: torch.Tensor, cfg: ModelConfig, window: Optional[int],
         positions: torch.Tensor, cache_len: Optional[int] = None,
         plan=None, fill: Optional[dict] = None):
    """The token mixer of a layer on its normed input ``h``: causal
    attention over ``window`` keys back (None: all), then the SSM, fused.
    Returns (the mixer's output, the layer's decode cache: the K/V ring
    of ``cache_len`` slots when one is asked for, the SSM's conv rings
    and state, written into ``fill``'s where that cache is given)."""
    branches, cache = [], {}
    if cfg.family != "ssm":
        out, k, v = _attention(lp["attn"], h, cfg, window, positions, plan,
                               cache_kv=cache_len is not None)
        branches.append(out)
        if cache_len is not None:
            cache.update(_fill_ring(k, v, h.shape[1], cache_len))
    if cfg.family in ("ssm", "hybrid"):
        y, (conv, state) = SSM.ssm_block(lp["ssm"], h, cfg,
                                         out=_ssm_out(fill))
        branches.append(y)
        cache["ssm"] = {"conv": conv, "state": state}
    return _fuse(lp, branches, cfg), cache


def _layer(lp, x: torch.Tensor, cfg: ModelConfig, window: Optional[int],
           positions: torch.Tensor, plan=None):
    """One layer of ``forward``: (its output, the aux losses of its
    expert mixture or None).  Over a mesh it gathers its leaves first."""
    if plan is not None:
        lp = plan.gather_layer(lp)
    sink: List[dict] = []
    y, _ = _mix(lp, rms_norm(x, lp["ln1"], cfg.norm_eps), cfg, window,
                positions, plan=plan)
    x = _ffn(lp, x + y, cfg, sink, plan)
    return x, (sink[0] if sink else None)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            embeds: Optional[torch.Tensor] = None, mesh=None,
            data_axes: Tuple[str, ...] = ("data",), unroll: bool = False,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (logits (B, F + S, V) float32, aux losses dict: each the
    mean over the expert layers, 0 without them), F the frontend
    positions of ``embeds``.  Over ``mesh`` (a ``ProcessMesh``; any
    other object raises ``TypeError``) ``tokens`` are this rank's rows
    and ``params`` its blocks, and the logits are its vocab shard.
    ``unroll`` is accepted and changes nothing (the layers are a Python
    loop already)."""
    plan = _plan(cfg, mesh, data_axes)
    x = embed_tokens(params, tokens, cfg, embeds, plan)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    auxes = []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params, i)
        if remat:
            x, aux = checkpoint(_layer, lp, x, cfg, window, positions, plan,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _layer(lp, x, cfg, window, positions, plan)
        if aux is not None:
            auxes.append(aux)
    ln_f = params["ln_f"] if plan is None else plan.gather(params["ln_f"],
                                                           "ln_f")
    x = rms_norm(x, ln_f, cfg.norm_eps)
    if auxes:
        aux = {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}
    else:
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"lb_loss": zero, "z_loss": zero}
    return unembed(params, x, cfg, plan), aux


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                        plan: _Plan) -> torch.Tensor:
    """``-log_softmax(logits)[label]`` with the vocab split over
    ``"model"``: the max and the sum of exponentials reduced over the
    shards, the label's logit from the shard that holds it."""
    lf = logits.to(torch.float32)
    mx = SH.all_reduce_(lf.detach().amax(-1, keepdim=True), plan.mesh,
                        "model", op=SH.dist.ReduceOp.MAX)
    se = SH.leave(torch.exp(lf - mx).sum(-1, keepdim=True), plan.mesh)
    t = labels.long() - plan.mi * lf.shape[-1]
    inside = (t >= 0) & (t < lf.shape[-1])
    picked = torch.gather(lf, -1, torch.where(inside, t, 0)[..., None])
    picked = SH.leave(torch.where(inside[..., None], picked, 0.0),
                      plan.mesh)
    return -((picked - mx) - torch.log(se))[..., 0]


def loss_fn(params, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, embeds=None, mesh=None,
            data_axes: Tuple[str, ...] = ("data",), unroll: bool = False,
            lb_coef: float = 0.01, z_coef: float = 1e-3,
            row_weights: Optional[torch.Tensor] = None,
            n_rows: Optional[int] = None):
    """Mean next-token NLL from a float32 ``log_softmax`` of the token
    positions' logits (a frontend's positions predict nothing), plus
    ``lb_coef * lb_loss + z_coef * z_loss``.  Returns ``(total, {"loss",
    "lb_loss", "z_loss"})``.  Over a mesh each rank passes its rows, and
    every value is the mean over the data ranks of theirs (the global
    batch's, as each rank holds as many rows).  Where the data ranks do
    not divide the batch's ``n_rows`` rows, each rank's rows are padded
    and ``row_weights`` (1 on a real row, 0 on a pad row) picks the real
    ones: the NLL is then the data ranks' sum of the weighted NLL over
    the batch's ``n_rows`` x S tokens, and the aux losses stay the data
    ranks' mean."""
    plan = _plan(cfg, mesh, data_axes)
    logits, aux = forward(params, tokens, cfg, embeds=embeds, mesh=mesh,
                          data_axes=data_axes)
    tok_logits = logits[:, -tokens.shape[1]:, :]
    if plan is not None and plan.m > 1:
        nll = _vocab_parallel_nll(tok_logits, labels, plan)
    else:
        lp = torch.log_softmax(tok_logits.to(torch.float32), dim=-1)
        nll = -torch.gather(lp, -1, labels.long()[..., None])[..., 0]
    dev = nll.device
    n_data = 1 if plan is None else plan.mesh.count(data_axes)
    if row_weights is not None:
        # each rank's share of the batch's NLL, summed over the ranks
        loss = ((nll * row_weights[:, None]).sum()
                / f32(n_rows * tokens.shape[1], dev))
        lb, z = (aux[k] / f32(n_data, dev) for k in ("lb_loss", "z_loss"))
        out = [loss + f32(lb_coef, dev) * lb + f32(z_coef, dev) * z,
               loss, lb, z]
        out = list(SH.leave(torch.stack(out), plan.mesh, data_axes))
        return out[0], dict(zip(("loss", "lb_loss", "z_loss"), out[1:]))
    loss = nll.mean()
    total = (loss + f32(lb_coef, dev) * aux["lb_loss"]
             + f32(z_coef, dev) * aux["z_loss"])
    out = [total, loss, aux["lb_loss"], aux["z_loss"]]
    if n_data > 1:
        # the data ranks' mean; its gradient reaches each rank's own
        out = list(SH.leave(torch.stack(out), plan.mesh, data_axes)
                   / f32(n_data, dev))
    return out[0], dict(zip(("loss", "lb_loss", "z_loss"), out[1:]))


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


def abstract_decode_caches(cfg: ModelConfig, batch: int, max_len: int
                           ) -> List[dict]:
    """``init_decode_caches``' leaves on the ``meta`` device: their
    shapes and dtypes, nothing allocated (the dry run's stand-ins)."""
    return init_decode_caches(cfg, batch, max_len, device="meta")


def uniform_layers(cfg: ModelConfig) -> bool:
    """True when every layer has the same kind (so the same cache)."""
    return len(set(cfg.layer_kinds())) == 1


def stack_caches(caches: List[dict]) -> dict:
    """Per-layer caches as one tree whose every leaf stacks the layers'
    on a new leading dim (uniform layers: ``decode_step_scan``'s
    caches)."""
    flats = [M.flatten(c) for c in caches]
    return M.unflatten({k: torch.stack([f[k] for f in flats])
                        for k in flats[0]})


def _layout(plan, cfg: ModelConfig, cache_shards, rows: int,
            lens: List[Optional[int]], what: str) -> Optional[list]:
    """Over a mesh, ``cache_shards`` (required: the layout of the whole
    batch's caches, ``sharding.cache_placements``) as a list of per-layer
    trees, checked to hold ``rows`` rows on this rank and, where ``lens``
    names one, a K/V ring of that many slots; None without a mesh."""
    if plan is None:
        return None
    if cache_shards is None:
        raise ValueError(
            f"over a mesh {what} needs the caches' layout: pass "
            f"cache_shards=sharding.cache_placements(cfg, mesh, batch, "
            f"max_len) for the whole batch")
    if len(cache_shards) != len(lens):
        raise ValueError(f"cache_shards holds {len(cache_shards)} layers; "
                         f"{cfg.name} has {len(lens)}")
    for i, (tree, n) in enumerate(zip(cache_shards, lens)):
        flat = M.flatten(tree)
        have = next(iter(flat.values())).local_shape[0]
        if have != rows:
            raise ValueError(
                f"the layout puts {have} rows of a batch of "
                f"{next(iter(flat.values())).shape[0]} on this rank of "
                f"{plan.mesh.shape}; {what} was given {rows}")
        if n is not None and "k" in flat and flat["k"].shape[1] != n:
            raise ValueError(f"layer {i}: the layout holds a ring of "
                             f"{flat['k'].shape[1]} slots; this one has {n}")
    return list(cache_shards)


def _keep_block(cache: dict, pls: dict) -> dict:
    """A layer's cache on this rank's rows, cut to this rank's block
    of the dims past the batch (the K/V rings' sequence)."""
    flat = M.flatten(pls)
    return M.unflatten_like(cache, {
        k: SH.local_block(x, flat[k]) if flat[k].axes(range(1, x.dim()))
        else x for k, x in M.flatten(cache).items()})


def _seq_reduce(plan: _Plan, axes):
    """``merge_partials``' reduction over the mesh axes ``axes``."""
    ops = {"max": SH.dist.ReduceOp.MAX, "sum": SH.dist.ReduceOp.SUM}
    return lambda x, op: SH.all_reduce_(x, plan.mesh, axes, op=ops[op])


def _decode_attn(ap, h: torch.Tensor, c: dict, position: int,
                 positions: torch.Tensor, cfg: ModelConfig,
                 window: Optional[int], plan=None, pl=None) -> torch.Tensor:
    """The attention branch of one decode step: the token's K and V go
    into slot ``position % S`` of the layer's cache ``c`` (in place), then
    the query attends over the cache.  ``positions`` is ``position`` as a
    (1,) tensor on the data's device.

    Over a mesh, ``pl`` places the layer's ``k``: ``c`` holds this rank's
    block of its sequence, and only the rank that owns the slot writes
    it.  The token's q (and K/V) are gathered over the heads a split
    ``"model"`` axis holds, every rank attends with every head over its
    own slots, the partials merge over the axes that split the sequence
    (``decode_attention`` unchanged where none does), and each rank keeps
    its heads for the row-parallel ``wo``."""
    split = plan is not None and plan.heads
    q, k, v = L.attention_qkv(ap, h, cfg, positions)
    if split:
        q = SH.all_gather_dim(q, plan.mesh, "model", 2)
        if plan.kv:
            k, v = (SH.all_gather_dim(t, plan.mesh, "model", 2)
                    for t in (k, v))
    s_loc = c["k"].shape[1]
    s_all, lo, seq = ((s_loc, 0, ()) if pl is None else
                      (pl.shape[1], pl.block()[1].start, pl.axes([1])))
    slot = position % s_all - lo
    mine = 0 <= slot < s_loc
    if cfg.kv_cache_dtype == "int8":
        if c["k"].dtype != torch.int8:
            raise TypeError(
                f"an int8 kv cache decodes from init_decode_caches' int8 "
                f"layout; this cache holds {c['k'].dtype} K/V (prefill "
                f"builds unquantized caches, as the reference's does)")
        if mine:
            (c["k"][:, slot], c["k_scale"][:, slot]) = kv_quantize(k[:, 0])
            (c["v"][:, slot], c["v_scale"][:, slot]) = kv_quantize(v[:, 0])
        k_full = kv_dequantize(c["k"], c["k_scale"], h.dtype)
        v_full = kv_dequantize(c["v"], c["v_scale"], h.dtype)
    else:
        if mine:
            c["k"][:, slot] = k[:, 0]
            c["v"][:, slot] = v[:, 0]
        k_full, v_full = c["k"], c["v"]
    if mine:
        c["pos"][:, slot] = position
    if seq:
        m, l, o = L.decode_attention_partial(
            q, k_full, v_full, c["pos"], position, window=window,
            softcap=cfg.attn_logit_softcap)
        out = L.merge_partials(m, l, o, _seq_reduce(plan, seq))
        out = out.reshape(q.shape).to(q.dtype)
    else:
        out = L.decode_attention(q, k_full, v_full, c["pos"], position,
                                 window=window,
                                 softcap=cfg.attn_logit_softcap)
    if not split:
        return L.attention_out(out, ap["wo"])
    hl = cfg.n_heads // plan.m
    out = out[:, :, plan.mi * hl:(plan.mi + 1) * hl]
    return SH.leave(L.attention_out(out, ap["wo"]), plan.mesh)


def _ssm_out(cache: Optional[dict]):
    """A layer's SSM cache as ``ssm_block``'s and ``ssm_decode_step``'s
    ``out``: (conv rings, state), or None."""
    return None if cache is None else (cache["ssm"]["conv"],
                                       cache["ssm"]["state"])


def _decode_layer(lp, x: torch.Tensor, c: dict, position: int,
                  positions: torch.Tensor, cfg: ModelConfig,
                  window: Optional[int], plan=None, pl=None,
                  out: Optional[dict] = None) -> torch.Tensor:
    """One layer of a decode step on its (gathered) parameters ``lp``:
    the token mixer against the layer's cache ``c`` (K/V written in
    place, the SSM's conv rings and state replaced: by new tensors, or
    by ``out``'s, written, where that cache is given), then the FFN."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    branches = []
    if cfg.family != "ssm":
        branches.append(_decode_attn(lp["attn"], h, c, position, positions,
                                     cfg, window, plan, pl))
    if cfg.family in ("ssm", "hybrid"):
        y, (conv, state) = SSM.ssm_decode_step(
            lp["ssm"], h, cfg, c["ssm"]["conv"], c["ssm"]["state"],
            out=_ssm_out(out))
        branches.append(y)
        c["ssm"] = {"conv": conv, "state": state}
    return _ffn(lp, x + _fuse(lp, branches, cfg), cfg, plan=plan)


def _final(params, x: torch.Tensor, cfg: ModelConfig, plan=None
           ) -> torch.Tensor:
    """The last norm and the unembedding (this rank's vocab shard over
    a split ``"model"`` axis)."""
    ln_f = params["ln_f"] if plan is None else plan.gather(params["ln_f"],
                                                           "ln_f")
    return unembed(params, rms_norm(x, ln_f, cfg.norm_eps), cfg, plan)


def _layer_k_shards(plan, cfg: ModelConfig, cache_shards, caches,
                    rows: int) -> list:
    """Each layer's placement of ``k`` (None without a mesh, or for a
    layer with no K/V), checked against this rank's blocks ``caches``."""
    if plan is None:
        return [None] * len(caches)
    shards = _layout(plan, cfg, cache_shards, rows, [None] * len(caches),
                     "decode")
    pls = [M.flatten(s).get("k") for s in shards]
    for i, (c, pl) in enumerate(zip(caches, pls)):
        if pl is not None and tuple(c["k"].shape[:2]) != pl.local_shape[:2]:
            raise ValueError(
                f"layer {i}: this rank's K block holds (rows, slots) "
                f"{tuple(c['k'].shape[:2])}; the layout gives it "
                f"{pl.local_shape[:2]}")
    return pls


class DecodeGraphs:
    """Two sets of decode caches of an all-SSM model at fixed addresses,
    and CUDA graphs of ``decode_step`` between them: what its owner
    (``ServeEngine``, one a batch size) passes as ``decode_step``'s
    ``graphs``.  Nothing here refers back to the owner.

    ``prefill(caches=sets[0])`` fills set A.  A step from A writes B and
    returns it, a step from B writes A: a step leaves the caches it is
    given as they are.  On a CUDA device the first step in each
    direction runs eagerly (the warm-up); the second captures the whole
    step (embedding, layers, last norm, unembedding) into one graph over
    a static token input, both graphs in one memory pool, and replays
    it; every later step copies its tokens in and replays.  The logits
    returned are a copy of the graph's output, new at each call.  An SSM
    layer's step never reads ``position``, so one graph serves every
    position.  ``last`` says how the newest step ran: ``"eager"``,
    ``"capture"`` (captured, then replayed) or ``"replay"``."""

    def __init__(self, cfg: ModelConfig, batch: int, device):
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: DecodeGraphs needs every layer "
                             f"SSM, not {cfg.family!r}")
        self.batch = batch
        # an SSM cache has no length: max_len plays no part
        self.sets = [init_decode_caches(cfg, batch, 0, device=device)
                     for _ in range(2)]
        self.graphs: List[Optional[torch.cuda.CUDAGraph]] = [None, None]
        self.warm = [False, False]
        self.tokens: List[Optional[torch.Tensor]] = [None, None]
        self.logits: List[Optional[torch.Tensor]] = [None, None]
        self.pool = None
        self.last: Optional[str] = None

    def direction(self, caches) -> Optional[int]:
        """0 for set A, 1 for set B, None for caches that are neither."""
        return next((d for d, s in enumerate(self.sets) if caches is s),
                    None)

    def step(self, d: int, run, tokens: torch.Tensor):
        """The step from set ``d`` into the other: ``run(tokens, out)`` is
        the eager step that writes the caches ``out`` and returns the
        logits.  Returns (logits, the other set)."""
        dst = self.sets[1 - d]
        g = self.graphs[d]
        if tokens.device.type != "cuda" or (g is None and not self.warm[d]):
            self.warm[d] = True
            self.last = "eager"
            return run(tokens, dst), dst
        if g is None:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            self.tokens[d] = tokens.clone()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=self.pool):
                self.logits[d] = run(self.tokens[d], dst)
            self.graphs[d] = g
            self.last = "capture"
        else:
            self.tokens[d].copy_(tokens)
            self.last = "replay"
        g.replay()
        return self.logits[d].clone(), dst


def decode_step(params, tokens: torch.Tensor, caches: List[dict], position,
                cfg: ModelConfig, mesh=None,
                data_axes: Tuple[str, ...] = ("data",), cache_shards=None,
                graphs: Optional[DecodeGraphs] = None):
    """One token for the whole batch.  ``tokens`` (B, 1); ``position``
    (an int) is the absolute position of this token.  Attention caches are
    updated in place; an SSM's conv rings and state are new tensors in
    the returned caches.  Returns (logits (B, 1, V), caches).

    With ``graphs`` and no mesh, a step on one of its cache sets writes
    the other set and returns it, replaying a CUDA graph on a card
    (``DecodeGraphs``); any other caches take the path above.

    Over ``mesh`` (a ``ProcessMesh``), ``params`` are this rank's blocks,
    ``tokens`` its rows, ``caches`` its blocks as ``cache_shards``
    (``sharding.cache_placements``) places them, and the logits its
    vocab shard; each layer gathers its FSDP blocks first, as
    ``forward`` does."""
    d = None if graphs is None or mesh is not None else graphs.direction(
        caches)
    if d is None:
        return _decode(params, tokens, caches, position, cfg, mesh,
                       data_axes, cache_shards)
    return graphs.step(d, lambda t, out: _decode(
        params, t, caches, position, cfg, out=out)[0], tokens)


def _decode(params, tokens: torch.Tensor, caches: List[dict], position,
            cfg: ModelConfig, mesh=None,
            data_axes: Tuple[str, ...] = ("data",), cache_shards=None,
            out: Optional[List[dict]] = None):
    """``decode_step`` run eagerly, each SSM layer's new conv rings and
    state written into ``out``'s caches where they are given."""
    position = int(position)
    plan = _plan(cfg, mesh, data_axes)
    pls = _layer_k_shards(plan, cfg, cache_shards, caches, tokens.shape[0])
    x = embed_tokens(params, tokens, cfg, plan=plan)
    positions = torch.arange(position, position + 1, device=x.device)
    new_caches = []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params, i)
        if plan is not None:
            lp = plan.gather_layer(lp)
        c = dict(caches[i])
        x = _decode_layer(lp, x, c, position, positions, cfg, window, plan,
                          pls[i], None if out is None else out[i])
        new_caches.append(c)
    return _final(params, x, cfg, plan), new_caches


def decode_step_scan(params, tokens: torch.Tensor, caches: dict, position,
                     cfg: ModelConfig, mesh=None,
                     data_axes: Tuple[str, ...] = ("data",),
                     cache_shards=None):
    """``decode_step`` on stacked caches (``stack_caches``: K/V (L, B, S,
    K, D), ``pos`` (L, B, S), the SSM's leaves likewise), for configs
    whose layers are uniform.  Every leaf is updated in place; returns
    (logits, caches).  Over a mesh ``cache_shards`` is
    ``sharding.cache_placements(..., stacked=True)``."""
    if not uniform_layers(cfg):
        raise ValueError(f"{cfg.name}: decode_step_scan needs uniform "
                         "layers (one cache shape); use decode_step")
    position = int(position)
    plan = _plan(cfg, mesh, data_axes)
    pl = None
    if plan is not None and cfg.family != "ssm":
        if cache_shards is None:
            raise ValueError("over a mesh decode_step_scan needs "
                             "cache_shards=sharding.cache_placements(cfg, "
                             "mesh, batch, max_len, stacked=True)")
        k = M.flatten(cache_shards)["k"]
        pl = SH.Placement(k.shape[1:], k.spec[1:], plan.mesh)
        _layer_k_shards(plan, cfg, [{"k": pl}],
                        [_index(caches, 0)], tokens.shape[0])
    window = layer_windows(cfg)[0]
    x = embed_tokens(params, tokens, cfg, plan=plan)
    positions = torch.arange(position, position + 1, device=x.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if plan is not None:
            lp = plan.gather_layer(lp)
        c = _index(caches, i)
        x = _decode_layer(lp, x, c, position, positions, cfg, window, plan,
                          pl)
        if "ssm" in c:
            for k, new in M.flatten(c["ssm"]).items():
                M.flatten(caches["ssm"])[k][i].copy_(new)
    return _final(params, x, cfg, plan), caches


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
            embeds: Optional[torch.Tensor] = None, mesh=None,
            data_axes: Tuple[str, ...] = ("data",),
            last_logits_only: bool = False, cache_shards=None,
            caches: Optional[List[dict]] = None):
    """Forward pass that also builds the decode caches: each attention
    layer's K/V as a ring (``_fill_ring``; unquantized whatever
    ``kv_cache_dtype`` says, as in the reference), each SSM layer's conv
    ring and state.  Positions count ``embeds``' frontend positions first.
    ``last_logits_only`` unembeds just the final position.  Returns
    (logits, caches, next_position).

    ``caches`` (an all-SSM model on one device: ``init_decode_caches``'
    layout) are filled in place and returned: every layer writes its conv
    rings and state into them, with the values it would return, and keeps
    no view of its own temporaries.

    Over ``mesh``, ``tokens`` are this rank's rows and ``cache_shards``
    (required) lays out the whole batch's caches,
    ``sharding.cache_placements(cfg, mesh, batch, max_len)``, as
    ``decode_step`` takes it: each cache comes out as this rank's block,
    every KV head (gathered over a split ``"model"`` axis), the ring's
    sequence cut to this rank's slots."""
    if caches is not None and (mesh is not None or cfg.family != "ssm"):
        raise ValueError("prefill fills given caches only for an all-SSM "
                         "model on one device")
    if caches is not None and (caches[0]["ssm"]["state"].shape[0]
                               != tokens.shape[0]):
        raise ValueError(f"caches of {caches[0]['ssm']['state'].shape[0]} "
                         f"rows for a batch of {tokens.shape[0]}")
    plan = _plan(cfg, mesh, data_axes)
    shards = _layout(plan, cfg, cache_shards, tokens.shape[0],
                     [None if cfg.family == "ssm" else _cache_len(w, max_len)
                      for w in layer_windows(cfg)], "prefill")
    x = embed_tokens(params, tokens, cfg, embeds, plan)
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)
    built: List[dict] = []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params, i)
        if plan is not None:
            lp = plan.gather_layer(lp)
        y, cache = _mix(lp, rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                        window, positions, _cache_len(window, max_len), plan,
                        None if caches is None else caches[i])
        if shards is not None:
            cache = _keep_block(cache, shards[i])
        x = _ffn(lp, x + y, cfg, plan=plan)
        built.append(cache)
    if last_logits_only:
        x = x[:, -1:]
    return (_final(params, x, cfg, plan),
            built if caches is None else caches, s_total)


def prefill_scan(params, tokens: torch.Tensor, cfg: ModelConfig,
                 embeds: Optional[torch.Tensor] = None, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",),
                 kv_constraint=None, cache_shards=None):
    """The dry run's prefill: the last position's logits and the stacked
    caches of the whole prompt, K/V (L, B, S, K, D) (no ring, no
    ``pos``) and an SSM's conv rings and state.  ``kv_constraint`` maps
    each layer's K and V (B, S, K, D).  Over a mesh, without one,
    ``cache_shards`` (required where the layers hold K/V) is the stacked
    layout of these caches, ``sharding.cache_placements(cfg, mesh,
    batch, S, stacked=True)`` for the whole batch and the S positions
    of the prompt, as ``decode_step_scan`` takes it, and each layer's K/V
    comes out as this rank's block."""
    plan = _plan(cfg, mesh, data_axes)
    x = embed_tokens(params, tokens, cfg, embeds, plan)
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)
    if kv_constraint is None and plan is not None and cfg.family != "ssm":
        if cache_shards is None:
            raise ValueError("over a mesh prefill_scan needs "
                             "cache_shards=sharding.cache_placements(cfg, "
                             "mesh, batch, S, stacked=True) or a "
                             "kv_constraint")
        k = M.flatten(cache_shards)["k"]
        pl = SH.Placement(k.shape[1:], k.spec[1:], plan.mesh)
        _layout(plan, cfg, [{"k": pl}], tokens.shape[0], [s_total],
                "prefill_scan")
        kv_constraint = lambda a: SH.local_block(a, pl)
    outs = []
    for i, window in enumerate(layer_windows(cfg)):
        lp = layer_params(params, i)
        if plan is not None:
            lp = plan.gather_layer(lp)
        y, cache = _mix(lp, rms_norm(x, lp["ln1"], cfg.norm_eps), cfg,
                        window, positions,
                        None if cfg.family == "ssm" else s_total, plan)
        if "k" in cache:
            cache.pop("pos")
            if kv_constraint is not None:
                cache["k"], cache["v"] = (kv_constraint(cache["k"]),
                                          kv_constraint(cache["v"]))
        x = _ffn(lp, x + y, cfg, plan=plan)
        outs.append(cache)
    return _final(params, x[:, -1:], cfg, plan), stack_caches(outs)
