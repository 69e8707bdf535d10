"""Transformer building blocks: RMSNorm, RoPE, GQA attention, gated MLP.

The port of ``repro.models.layers``.  Attention is blockwise (a running
softmax over KV tiles of ``bc`` keys for each tile of ``bq`` queries), so
a long prefill never holds an (S, S) score matrix.  The tiles are walked
as the reference's ``unroll=True`` mode walks them: a tile that the
causal mask or the window hides entirely is skipped where the loop is
built, which leaves the running state as the reference's masked merge of
that tile leaves it, and the KV tiles of a query tile merge in ascending
order.  Under autograd each query tile is checkpointed, as the
reference's scan mode remats its ``q_chunk``: the backward keeps one
tile's scores at a time, not the (S, S) matrix.  Supports GQA grouping, causal and sliding-window masks,
gemma-style logit softcaps, qwen3-style qk-norm and partial RoPE.

Precision follows the reference op for op, as ``models/ssm.py`` does:
the projections are bf16 in, bf16 out, each float32 master weight cast
at its use; a contraction that the reference takes with
``preferred_element_type=float32`` casts its operands to the working
dtype and contracts them in float32 (TF32 must be off on the card), and
the softmax weights are rounded to V's dtype before the PV product.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamDef

F32 = torch.float32

#: the finite mask value of the reference: a masked score is this, never
#: -inf, and a row whose every key is masked keeps m == NEG_INF
NEG_INF = -1e30


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x*x) + eps) * (1 + gamma)``, rounded as the
    reference rounds it: the variance accumulates in float32, the ``rsqrt``
    and ``1 + gamma`` (summed in gamma's float32) are cast to x's dtype,
    and the two products are taken in x's dtype."""
    xf = x.to(F32)
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + gamma).to(x.dtype)


# ----------------------------------------------------------------- RoPE

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    """(rot_dim / 2,) float32 inverse frequencies of the rotated dims."""
    rot_dim = int(head_dim * fraction) // 2 * 2
    return theta ** (-torch.arange(0, rot_dim, 2, dtype=F32, device=device)
                     / rot_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, fraction: float,
               theta: float) -> torch.Tensor:
    """Rotate interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` of the
    first ``int(D * fraction) // 2 * 2`` dims by ``position * freq``; the
    rest pass through.  x: (B, S, N, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    freqs = rope_frequencies(d, fraction, theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(F32) * freqs            # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2].to(F32), xr[..., 1::2].to(F32)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(F32)], dim=-1).to(x.dtype)


# ------------------------------------------------- blockwise attention

def _soft_cap(s: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def _block_attend(qi, kj, vj, mask, softcap, scale, v_dtype):
    """One (query tile, KV tile) pair.  qi: (B, K, bq, G, D); kj, vj:
    (B, K, bc, D); all float32 holding values of the working dtype.
    mask: (bq, bc) bool (True = attend) or None.  Returns the tile's
    partials (m, l) (B, K, bq, G) and pv (B, K, bq, G, D)."""
    b, kh, bq, g, d = qi.shape
    s = (qi.reshape(b, kh, bq * g, d) @ kj.transpose(-1, -2)) * scale
    s = _soft_cap(s, softcap).view(b, kh, bq, g, -1)
    if mask is not None:
        s = torch.where(mask[None, None, :, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    # zero the rows whose every key is masked (m == NEG_INF)
    p = torch.where((m > NEG_INF * 0.5)[..., None], p, 0.0)
    l = p.sum(-1)
    pv = p.to(v_dtype).to(F32).view(b, kh, bq * g, -1) @ vj
    return m, l, pv.view(b, kh, bq, g, d)


def _merge(m1, l1, o1, m2, l2, o2):
    m = torch.maximum(m1, m2)
    a1 = torch.where(m1 > NEG_INF * 0.5, torch.exp(m1 - m), 0.0)
    a2 = torch.where(m2 > NEG_INF * 0.5, torch.exp(m2 - m), 0.0)
    return m, l1 * a1 + l2 * a2, o1 * a1[..., None] + o2 * a2[..., None]


def blockwise_attention(
    q: torch.Tensor,                 # (B, S, H, D)
    k: torch.Tensor,                 # (B, Sk, K, D)
    v: torch.Tensor,                 # (B, Sk, K, D)
    causal: bool = True,
    window: Optional[int] = None,    # keys visible: q - k < window
    softcap: Optional[float] = None,
    q_offset: int = 0,               # absolute position of q[:, 0]
    bq: int = 512,
    bc: int = 512,
) -> torch.Tensor:
    """Attention of q over k, v in (bq, bc) tiles with a running softmax;
    S and Sk are padded to whole tiles (the pad keys masked by
    ``k_pos < Sk``).  Returns (B, S, H, D) in q's dtype."""
    b, s, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    bq, bc = min(bq, s), min(bc, sk)
    pq, pc = (-s) % bq, (-sk) % bc
    nq, nc = (s + pq) // bq, (sk + pc) // bc
    dev = q.device
    # (B, K, S, G, D) and (B, K, Sk, D) in float32, padded with zeros
    qg = F.pad(q.to(F32).reshape(b, s, kh, g, d).permute(0, 2, 1, 3, 4),
               (0, 0, 0, 0, 0, pq))
    kp = F.pad(k.to(F32).permute(0, 2, 1, 3), (0, 0, 0, pc))
    vp = F.pad(v.to(F32).permute(0, 2, 1, 3), (0, 0, 0, pc))
    q_pos = q_offset + torch.arange(s + pq, device=dev)
    k_pos = torch.arange(sk + pc, device=dev)

    def tile_mask(i, j):
        qp = q_pos[i * bq:(i + 1) * bq, None]
        kpos = k_pos[None, j * bc:(j + 1) * bc]
        m = kpos < sk
        if causal:
            m = m & (qp >= kpos)
        if window is not None:
            m = m & ((qp - kpos) < window)
        return m

    def q_tile(i, qi, kp, vp):
        mi = torch.full((b, kh, bq, g), NEG_INF, dtype=F32, device=dev)
        li = torch.zeros((b, kh, bq, g), dtype=F32, device=dev)
        oi = torch.zeros((b, kh, bq, g, d), dtype=F32, device=dev)
        q_lo, q_hi = q_offset + i * bq, q_offset + (i + 1) * bq - 1
        for j in range(nc):
            k_lo, k_hi = j * bc, (j + 1) * bc - 1
            if causal and k_lo > q_hi:
                continue          # every key of the tile is in the future
            if window is not None and k_hi < q_lo - window + 1:
                continue          # every key of the tile is out of the window
            need_mask = ((causal and k_hi > q_lo)
                         or (window is not None and k_lo < q_hi - window + 1)
                         or (j == nc - 1 and pc > 0))
            m2, l2, o2 = _block_attend(
                qi, kp[:, :, j * bc:(j + 1) * bc],
                vp[:, :, j * bc:(j + 1) * bc],
                tile_mask(i, j) if need_mask else None, softcap, scale,
                v.dtype)
            mi, li, oi = _merge(mi, li, oi, m2, l2, o2)
        return oi / torch.clamp_min(li[..., None], 1e-37)

    remat = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    outs = []
    for i in range(nq):
        qi = qg[:, :, i * bq:(i + 1) * bq]
        if remat:
            outs.append(checkpoint(q_tile, i, qi, kp, vp, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(q_tile(i, qi, kp, vp))
    out = torch.cat(outs, dim=2)[:, :, :s]
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, h, d).to(q.dtype)


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, D)
    k_cache: torch.Tensor,        # (B, S, K, D)
    v_cache: torch.Tensor,        # (B, S, K, D)
    kv_positions: torch.Tensor,   # (B, S) int32 position of each slot, -1 empty
    q_position,                   # int, or (B,) tensor: the query's position
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """One query token against a (possibly ring) KV cache: a slot is
    visible when its position is in [0, q] and, with a window, within
    ``window`` of q.  Returns (B, 1, H, D) in q's dtype."""
    b, s, kh, d = k_cache.shape
    h = q.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, g, d).to(F32)
    logits = (qg @ k_cache.to(F32).permute(0, 2, 3, 1)) * scale  # (B,K,G,S)
    logits = _soft_cap(logits, softcap)
    qpos = (q_position[:, None] if isinstance(q_position, torch.Tensor)
            else q_position)
    valid = (kv_positions >= 0) & (kv_positions <= qpos)
    if window is not None:
        valid = valid & ((qpos - kv_positions) < window)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    out = p.to(v_cache.dtype).to(F32) @ v_cache.to(F32).permute(0, 2, 1, 3)
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------- attention block

def attention_defs(cfg: ModelConfig) -> dict:
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), init="zeros")
        defs["k_norm"] = ParamDef((hd,), (None,), init="zeros")
    return defs


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe")`` in x's dtype, w cast from its master."""
    d, n, e = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * e)).unflatten(-1, (n, e))


def attention_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd")`` in out's dtype, wo cast from its
    master."""
    h, e, d = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * e, d)


def attention_qkv(params, x: torch.Tensor, cfg: ModelConfig, positions):
    """q (B, S, H, D), k and v (B, S, K, D): projected, qk-normed over
    ``head_dim`` where the config says so, then RoPE'd at ``positions``."""
    q, k, v = (_heads(x, params[w]) for w in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q, k, v


# ----------------------------------------------------------- gated MLP

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    return {
        "wi_gate": ParamDef((d, f), ("embed", "mlp")),
        "wi_up": ParamDef((d, f), ("embed", "mlp")),
        "wo": ParamDef((f, d), ("mlp", "embed")),
    }


def mlp_block(params, x: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ wi_gate) * (x @ wi_up) @ wo``: the tanh GELU
    (``jax.nn.gelu``'s default, not PyTorch's erf form), taken in float32
    and cast back."""
    dt = x.dtype
    gate = x @ params["wi_gate"].to(dt)
    up = x @ params["wi_up"].to(dt)
    h = F.gelu(gate.to(F32), approximate="tanh").to(dt) * up
    return h @ params["wo"].to(dt)
