"""Mamba-2 SSD blocks (state-space duality, arXiv:2405.21060) in PyTorch.

The port of ``repro.models.ssm``.  The SSD recurrence
h_t = a_t h_{t-1} + dt_t * (B_t (x) x_t),  y_t = C_t . h_t + D x_t  is
evaluated with the chunked matmul algorithm: intra-chunk attention-like
contractions plus an inter-chunk elementwise decay recurrence, which runs
through ``kernels.ops.decay_scan`` -- the hand-written CUDA kernel on a
card tensor, its plain version on a CPU one (the reference's
``use_pallas`` switch is not carried over: the data's device decides).

Precision follows the reference op for op.  Its contractions with
``preferred_element_type=float32`` take bf16 operands to a float32
result; here the operands are cast to their working dtype first (so a
float32 factor rounds to bf16 as it does there) and then contracted in
float32, as explicit pairwise products (TF32 must be off on the card).
The projections are bf16 in, bf16 out.  Float32 master weights are cast
at each use; ``a_log``, ``dt_bias`` and ``d_skip`` are used in float32.

Decode keeps a per-layer (B, H, P, N) float32 state plus (B, K-1, *) conv
rings -- O(1) per token, and no kernel.  Given ``out``, ``ssm_block`` and
``ssm_decode_step`` write the new rings and state into caches the caller
holds at fixed addresses (a CUDA graph's), with the same values.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import rms_norm
from repro_torch.models.module import ParamDef

F32 = torch.float32


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, headdim, state)."""
    if cfg.family == "hybrid":
        d_inner = cfg.d_model            # hymba: parallel heads, no expansion
    else:
        d_inner = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_headdim
    h = cfg.ssm_heads or d_inner // p
    n = cfg.ssm_state
    if h * p != d_inner:
        raise ValueError(f"ssm heads {h} x headdim {p} != d_inner {d_inner}")
    return d_inner, h, p, n


def ssm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di, h, p, n = ssm_dims(cfg)
    k = cfg.conv_kernel
    return {
        "z_proj": ParamDef((d, di), ("embed", "ssm_inner")),
        "x_proj": ParamDef((d, di), ("embed", "ssm_inner")),
        "b_proj": ParamDef((d, n), ("embed", None)),
        "c_proj": ParamDef((d, n), ("embed", None)),
        "dt_proj": ParamDef((d, h), ("embed", "ssm_heads")),
        "conv_x_w": ParamDef((k, di), (None, "ssm_inner"), scale=0.5),
        "conv_x_b": ParamDef((di,), ("ssm_inner",), init="zeros"),
        "conv_b_w": ParamDef((k, n), (None, None), scale=0.5),
        "conv_b_b": ParamDef((n,), (None,), init="zeros"),
        "conv_c_w": ParamDef((k, n), (None, None), scale=0.5),
        "conv_c_b": ParamDef((n,), (None,), init="zeros"),
        "a_log": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamDef((di,), ("ssm_inner",), init="zeros"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (= logaddexp(x, 0)); torch's ``F.softplus``
    returns x itself above its threshold of 20."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def _conv1d(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            state: Optional[torch.Tensor] = None,
            out: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x: (B, T, C); w: (K, C).

    Sums in x's dtype, adds the bias, applies silu in float32 and casts
    back.  With ``state`` (B, K-1, C) the conv continues a stream; returns
    (y, new_state).  Without ``out`` the new state is a view of the conv's
    whole (B, K-1+T, C) input, which it keeps alive; with ``out`` (B, K-1,
    C) it is copied there and nothing of the input is kept."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xc = torch.cat([state, x], dim=1)
    t = x.shape[1]
    y = sum(xc[:, i:i + t, :] * w[i][None, None, :] for i in range(k))
    y = silu((y + bias[None, None, :]).to(F32)).to(x.dtype)
    ring = xc[:, -(k - 1):, :] if k > 1 else state
    return y, ring if out is None else out.copy_(ring)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., q) -> (..., q, q) lower-triangular segment sums (log space)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    d = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, float("-inf"))


def _as(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` (the contraction's operand type), then
    widened to float32 for the contraction."""
    return x.to(dtype).to(F32)


def ssd_chunked(
    x: torch.Tensor,        # (B, T, H, P)
    a_log: torch.Tensor,    # (B, T, H)   per-step log decay (<= 0)
    b_in: torch.Tensor,     # (B, T, N)
    c_in: torch.Tensor,     # (B, T, N)
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B,T,H,P) in x's dtype,
    final_state (B,H,P,N) float32)."""
    bsz, t, h, p = x.shape
    n = b_in.shape[-1]
    dt_ = x.dtype
    pad = (-t) % chunk
    if pad:
        # a_log = 0 in the padding: the padded steps decay by 1, so the
        # final state is unchanged
        pad_t = lambda v: torch.nn.functional.pad(
            v, (0, 0) * (v.dim() - 2) + (0, pad))
        x, a_log, b_in, c_in = (pad_t(v) for v in (x, a_log, b_in, c_in))
    nc = x.shape[1] // chunk
    xc = _as(x, dt_).reshape(bsz, nc, chunk, h, p)
    ac = a_log.reshape(bsz, nc, chunk, h).to(F32)
    bc_ = _as(b_in, dt_).reshape(bsz, nc, chunk, n)
    cc = _as(c_in, dt_).reshape(bsz, nc, chunk, n)

    a_hc = ac.permute(0, 3, 1, 2)                   # (B, H, nc, q)
    a_cum = torch.cumsum(a_hc, dim=-1)              # (B, H, nc, q)
    xc_h = xc.permute(0, 1, 3, 2, 4)                # (B, nc, H, q, P)

    # 1) intra-chunk (diagonal blocks):
    #    "bcln,bcsn,bhcls,bcshp->bclhp" as (C.B^T) * L, then @ x
    l_mat = _as(torch.exp(_segsum(a_hc)), dt_)      # (B, H, nc, q, q)
    g = cc @ bc_.transpose(-1, -2)                  # (B, nc, q, q)
    m = g[:, :, None] * l_mat.permute(0, 2, 1, 3, 4)   # (B, nc, H, q, q)
    del l_mat
    y_diag = (m @ xc_h).permute(0, 1, 3, 2, 4)      # (B, nc, q, H, P)
    del m

    # 2) chunk -> final-state contributions:
    #    "bcln,bhcl,bclhp->bchpn" as (decay * x)^T @ B
    decay_states = _as(torch.exp(a_cum[..., -1:] - a_cum), dt_)  # (B,H,nc,q)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]     # (B,nc,q,H,P)
    states = (xd.reshape(bsz, nc, chunk, h * p).transpose(-1, -2)
              @ bc_)                                          # (B,nc,HP,N)
    del xd

    # 3) inter-chunk recurrence -- the paper's decay primitive
    chunk_decay = torch.exp(a_cum[..., -1])         # (B, H, nc)
    a_seq = chunk_decay.permute(0, 2, 1).reshape(bsz, nc, h, 1, 1)
    a_seq = a_seq.expand(bsz, nc, h, p, n).reshape(bsz, nc, -1)
    x_seq = states.reshape(bsz, nc, -1)
    s0 = (None if initial_state is None
          else initial_state.reshape(bsz, -1).to(F32))
    all_states, final = ops.decay_scan(a_seq, x_seq, s0)
    # states *entering* each chunk: shift right by one
    first = (torch.zeros_like(all_states[:, :1]) if s0 is None
             else s0[:, None])
    prev = torch.cat([first, all_states[:, :-1]], dim=1)
    prev = _as(prev, dt_).reshape(bsz, nc, h * p, n)

    # 4) inter-chunk (off-diagonal) output:
    #    "bcln,bchpn,bhcl->bclhp" as (C @ prev^T) * decay
    out_decay = _as(torch.exp(a_cum), dt_)          # (B, H, nc, q)
    y_off = (cc @ prev.transpose(-1, -2)).reshape(bsz, nc, chunk, h, p)
    y_off = y_off * out_decay.permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :t]
    return y.to(dt_), final.reshape(bsz, h, p, n)


def _project(params, x: torch.Tensor, cfg: ModelConfig,
             conv_state: Optional[Dict[str, torch.Tensor]] = None,
             out: Optional[Dict[str, torch.Tensor]] = None):
    """Shared z/x/B/C/dt projections + causal convs.  Returns
    (z, xs, b_in, c_in, dt_raw, new_conv_state), the new conv rings
    written into ``out``'s when it is given."""
    dt_ = x.dtype
    pj = lambda w: x @ params[w].to(dt_)
    z, xs, b_in, c_in, dt_raw = (pj(w) for w in
                                 ("z_proj", "x_proj", "b_proj", "c_proj",
                                  "dt_proj"))
    cs, dst = conv_state or {}, out or {}
    xs, cx = _conv1d(xs, params["conv_x_w"].to(dt_),
                     params["conv_x_b"].to(dt_), cs.get("x"), dst.get("x"))
    b_in, cb = _conv1d(b_in, params["conv_b_w"].to(dt_),
                       params["conv_b_b"].to(dt_), cs.get("b"), dst.get("b"))
    c_in, ccv = _conv1d(c_in, params["conv_c_w"].to(dt_),
                        params["conv_c_b"].to(dt_), cs.get("c"), dst.get("c"))
    return z, xs, b_in, c_in, dt_raw, {"x": cx, "b": cb, "c": ccv}


def _gate_out(params, y, z, cfg: ModelConfig, dt_):
    y = rms_norm(y.to(dt_) * silu(z.to(F32)).to(dt_), params["norm"],
                 cfg.norm_eps)
    return (y @ params["out_proj"].to(dt_)).to(dt_)


def ssm_block(
    params, x: torch.Tensor, cfg: ModelConfig,
    conv_state: Optional[Dict[str, torch.Tensor]] = None,
    ssm_state: Optional[torch.Tensor] = None,
    out: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = None,
):
    """Full-sequence mamba2 block.  Returns (y, (conv_state, ssm_state)),
    written into ``out``'s (conv rings, state) when it is given (a decode
    cache, ``init_ssm_cache``): then the block keeps no view of its own
    temporaries."""
    di, h, p, n = ssm_dims(cfg)
    dt_ = x.dtype
    z, xs, b_in, c_in, dt_raw, new_conv = _project(
        params, x, cfg, conv_state, None if out is None else out[0])
    dt = softplus(dt_raw.to(F32) + params["dt_bias"])                # (B,S,H)
    a = -torch.exp(params["a_log"].to(F32))                          # (H,)
    a_log_step = dt * a[None, None, :]
    xh = xs.reshape(*xs.shape[:2], h, p) * dt[..., None].to(dt_)
    y, final = ssd_chunked(xh, a_log_step, b_in, c_in, cfg.ssm_chunk,
                           ssm_state)
    y = y + params["d_skip"].to(F32)[None, None, :, None] * xh
    y = y.reshape(*xs.shape[:2], di)
    if out is not None:
        final = out[1].copy_(final)
    return _gate_out(params, y, z, cfg, dt_), (new_conv, final)


def ssm_decode_step(
    params, x: torch.Tensor, cfg: ModelConfig,
    conv_state: Dict[str, torch.Tensor], ssm_state: torch.Tensor,
    out: Optional[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = None,
):
    """O(1) single-token update.  x: (B, 1, D).  Returns (y, (conv_state,
    ssm_state)): new tensors, or ``out``'s (conv rings, state) written
    with the same values (the inputs are left as they are either way)."""
    di, h, p, n = ssm_dims(cfg)
    dt_ = x.dtype
    z, xs, b_in, c_in, dt_raw, new_conv = _project(
        params, x, cfg, conv_state, None if out is None else out[0])
    dt = softplus(dt_raw.to(F32) + params["dt_bias"])                # (B,1,H)
    a = torch.exp(dt * (-torch.exp(params["a_log"].to(F32)))[None, None, :])
    xh = (xs.reshape(x.shape[0], 1, h, p) * dt[..., None].to(dt_))[:, 0]
    # h_new = a*h + B (outer) x
    upd = xh.to(F32)[..., None] * b_in[:, 0].to(F32)[:, None, None, :]
    if out is None:
        new_state = a[:, 0, :, None, None] * ssm_state + upd
    else:   # the same product and sum, rounded as above, into out's state
        new_state = torch.mul(a[:, 0, :, None, None], ssm_state,
                              out=out[1]).add_(upd)
    y = (new_state @ c_in[:, 0].to(F32)[:, None, :, None])[..., 0]  # (B,H,P)
    y = y + params["d_skip"][None, :, None] * xh.to(F32)
    y = y.reshape(x.shape[0], 1, di)
    return _gate_out(params, y, z, cfg, dt_), (new_conv, new_state)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    di, h, p, n = ssm_dims(cfg)
    k = cfg.conv_kernel
    z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
    return {
        "conv": {
            "x": z((batch, k - 1, di), dtype),
            "b": z((batch, k - 1, n), dtype),
            "c": z((batch, k - 1, n), dtype),
        },
        "state": z((batch, h, p, n), F32),
    }
