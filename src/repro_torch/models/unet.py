"""Small UNet for event-to-intensity reconstruction (paper Sec. IV-E).

The port of ``repro.models.unet``: TS frames in, grayscale intensity out,
and the mean local SSIM the reconstruction protocol reports.  Functional
on the reference's parameter tree (HWIO conv weights), like
``models.cnn``, whose conv, "SAME" padding and float32 rule it reuses:

  * ``_down`` is XLA's 2x2 / 2 ``reduce_window`` max with "SAME" padding
    of -inf, which on an odd side pads one cell *after* the input
    (``_pad_same``), never ``ceil_mode`` or symmetric padding;
  * ``_up`` is ``jax.image.resize(..., "bilinear")``, here always an
    upsample, computed as the reference computes it: a (n_in, n_out)
    weight matrix per axis (half-pixel sampling, triangle kernel, edge
    weights renormalised; ``compute_weight_mat``) contracted with the
    input.  Its backward is two matrix products, deterministic on the
    card, where ``F.interpolate``'s backward adds with atomics in a
    varying order.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import f32
from repro_torch.models.cnn import _conv, _conv_defs, _pad_same, float32_math


def _block_defs(cin: int, cout: int) -> dict:
    return {"c1": _conv_defs(cin, cout, 3), "c2": _conv_defs(cout, cout, 3)}


def _block(p, x: torch.Tensor) -> torch.Tensor:
    return _conv(p["c2"], _conv(p["c1"], x))


def unet_defs(in_channels: int, width: int = 16) -> dict:
    w = width
    return {
        "enc1": _block_defs(in_channels, w),
        "enc2": _block_defs(w, 2 * w),
        "enc3": _block_defs(2 * w, 4 * w),
        "dec2": _block_defs(4 * w + 2 * w, 2 * w),
        "dec1": _block_defs(2 * w + w, w),
        "out": _conv_defs(w, 1, 1),
    }


def _down(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(_pad_same(x, 2, 2, float("-inf")), 2, 2)


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``jax.image.resize``'s linear weights from ``n_in`` to ``n_out``
    samples (an upsample), (n_in, n_out) float32, in its float32 order;
    one tensor per shape and device, never written."""
    c = lambda v: f32(v, device)
    pos = lambda n: torch.arange(n, dtype=torch.float32, device=device)
    sample = (pos(n_out) + c(0.5)) * c(1.0 / (n_out / n_in)) - c(0.5)
    w = torch.clamp(c(1.0) - (sample[None, :] - pos(n_in)[:, None]).abs(),
                    min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > c(1000.0 * torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, c(1.0)), c(0.0))
    inside = (sample >= c(-0.5)) & (sample <= c(n_in - 0.5))
    return torch.where(inside[None, :], w, c(0.0))


def _up(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    (h, w), dev = x.shape[-2:], x.device
    return torch.einsum("nchw,hH,wW->ncHW", x,
                        _resize_weights(h, target_hw[0], dev),
                        _resize_weights(w, target_hw[1], dev))


def unet_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> intensity (B, H, W) in [0, 1]."""
    with float32_math():
        x = x.movedim(-1, 1)
        e1 = _block(params["enc1"], x)
        e2 = _block(params["enc2"], _down(e1))
        e3 = _block(params["enc3"], _down(e2))
        d2 = _block(params["dec2"],
                    torch.cat([_up(e3, e2.shape[2:]), e2], dim=1))
        d1 = _block(params["dec1"],
                    torch.cat([_up(d2, e1.shape[2:]), e1], dim=1))
        y = F.conv2d(d1, params["out"]["w"].permute(3, 2, 0, 1))
        return torch.sigmoid(y[:, 0] + params["out"]["b"][0])


def ssim(a: torch.Tensor, b: torch.Tensor, window: int = 7, c1=0.01**2,
         c2=0.03**2) -> torch.Tensor:
    """Mean local SSIM between (..., H, W) images in [0, 1]: the means are
    a zero-padded "SAME" ``window`` x ``window`` box (the pads count), the
    result the mean over every pixel of every image."""
    def local_mean(x):
        k = torch.ones((1, 1, window, window), dtype=x.dtype,
                       device=x.device) / f32(window**2, x.device)
        return F.conv2d(_pad_same(x[:, None], window, 1, 0.0), k)[:, 0]

    with float32_math():
        flat_a = a.reshape((-1,) + tuple(a.shape[-2:]))
        flat_b = b.reshape((-1,) + tuple(b.shape[-2:]))
        mu_a, mu_b = local_mean(flat_a), local_mean(flat_b)
        var_a = local_mean(flat_a * flat_a) - mu_a**2
        var_b = local_mean(flat_b * flat_b) - mu_b**2
        cov = local_mean(flat_a * flat_b) - mu_a * mu_b
        c1, c2 = f32(c1, a.device), f32(c2, a.device)
        s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
            (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2))
        return s.mean()
