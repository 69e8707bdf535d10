"""Gradient compression with error feedback.

The port of ``repro.train.compression``.  Each compressor wraps an
``Optimizer``; the error-feedback residual lives in optimizer state
(``{"inner": ..., "residual": ...}``), so the compression's bias vanishes
over steps (Karimireddy et al. 2019):

  * ``int8`` -- per-tensor scale, symmetric int8 quantization (4x)
  * ``topk`` -- keep the largest k-fraction entries by magnitude

The payload is compressed and decompressed around the update, which keeps
the numerics of a compressed exchange; ``wire_bytes`` gives the bytes one
would move.  ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import f32
from repro_torch.models import module as M
from repro_torch.train.optimizer import Optimizer, _leafwise, _map


def int8_compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 scale) with ``g ~= q * scale``."""
    dev = g.device
    scale = torch.maximum(torch.max(torch.abs(g)), f32(1e-12, dev)) / f32(
        127.0, dev)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def topk_mask(g: torch.Tensor, frac: float) -> torch.Tensor:
    """True where ``|g|`` is at least the k-th largest ``|g|``, k =
    ``max(1, int(size * frac))``; all True for 16 entries or fewer."""
    if g.numel() <= 16:
        return torch.ones_like(g, dtype=torch.bool)
    k = max(1, int(g.numel() * frac))
    thresh = torch.topk(torch.abs(g.reshape(-1)), k).values[-1]
    return torch.abs(g) >= thresh


def _compress(kind: str, g: torch.Tensor, topk_frac: float) -> torch.Tensor:
    if kind == "int8":
        return int8_decompress(*int8_compress(g))
    if kind == "topk":
        return torch.where(topk_mask(g, topk_frac), g, torch.zeros_like(g))
    raise ValueError(kind)


def compressed(opt: Optimizer, kind: str = "int8",
               topk_frac: float = 0.05) -> Optimizer:
    """Wrap an optimizer with error-feedback gradient compression."""
    if kind not in ("int8", "topk"):
        raise ValueError(kind)

    def init(params):
        return {"inner": opt.init(params),
                "residual": _map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    @torch.no_grad()
    def update_(grads, state, params, step):
        for g, r in _leafwise(grads, state["residual"]):
            g.add_(r)
            gc = _compress(kind, g, topk_frac)
            torch.sub(g, gc, out=r)
            g.copy_(gc)
            del gc
        opt.update_(grads, state["inner"], params, step)

    return Optimizer(init, update_)


def wire_bytes(params, kind: str = "int8", topk_frac: float = 0.05) -> dict:
    """Bytes one step's gradient exchange moves: dense float32 against
    compressed (int8: a byte a value and a float32 scale a tensor; topk:
    value and index, 8 bytes, per kept entry)."""
    leaves = list(M.flatten(params).values())
    n = sum(x.numel() for x in leaves)
    dense = 4 * n
    if kind == "int8":
        comp = n + 4 * len(leaves)
    else:
        comp = int(n * topk_frac) * 8
    return {"dense_bytes": dense, "compressed_bytes": comp,
            "ratio": dense / max(comp, 1)}
