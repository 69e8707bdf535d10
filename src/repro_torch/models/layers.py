"""Transformer building blocks.  The port has ``rms_norm`` only; RoPE,
attention and the gated MLP come with the attention families (ROADMAP.md,
queue 1)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x*x) + eps) * (1 + gamma)``, rounded as the
    reference rounds it: the variance accumulates in float32, the ``rsqrt``
    and ``1 + gamma`` (summed in gamma's float32) are cast to x's dtype,
    and the two products are taken in x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    scale = torch.rsqrt(var + eps).to(x.dtype)
    return x * scale * (1.0 + gamma).to(x.dtype)
