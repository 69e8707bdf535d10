"""Inception-style CNN classifier (GoogLeNet-lite) for TS classification.

The port of ``repro.models.cnn``: a stem conv, a max-pool, two inception
blocks around a second pool, global average pooling and a linear head.
The parameter tree keeps the reference's layout -- HWIO conv weights
(``k, k, cin, cout``), ``head.w`` as (4*width, n_classes) -- so one
checkpoint directory serves both packages; convolutions permute to OIHW
at use.

Padding is XLA's ``"SAME"``, which is asymmetric where the window does
not tile the input (``total = max((ceil(n/s)-1)*s + k - n, 0)``, the
smaller half before): it is applied with ``F.pad`` (zeros before a conv,
-inf before a max-pool), never by the symmetric padding of ``F.conv2d``
/ ``F.max_pool2d``.  Convolutions and the head's matmul run in full
float32 (TF32 off for the call, whatever the global flags say).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.models.module import ParamDef


def _conv_defs(cin: int, cout: int, k: int) -> dict:
    return {
        "w": ParamDef((k, k, cin, cout), (None, None, None, None), scale=1.0),
        "b": ParamDef((cout,), (None,), init="zeros"),
    }


def _inception_defs(cin: int, c1: int, c3: int, c5: int, cp: int) -> dict:
    return {
        "b1": _conv_defs(cin, c1, 1),
        "b3a": _conv_defs(cin, c3 // 2, 1),
        "b3b": _conv_defs(c3 // 2, c3, 3),
        "b5a": _conv_defs(cin, c5 // 2, 1),
        "b5b": _conv_defs(c5 // 2, c5, 5),
        "bp": _conv_defs(cin, cp, 1),
    }


def cnn_defs(in_channels: int, n_classes: int, width: int = 32) -> dict:
    w = width
    return {
        "stem": _conv_defs(in_channels, w, 5),
        "inc1": _inception_defs(w, w // 2, w, w // 4, w // 4),
        "inc2": _inception_defs(2 * w, w, 2 * w, w // 2, w // 2),
        "head": {
            "w": ParamDef((4 * w, n_classes), (None, None)),
            "b": ParamDef((n_classes,), (None,), init="zeros"),
        },
    }


def _same(n: int, k: int, s: int):
    """XLA's "SAME" padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float) -> torch.Tensor:
    (top, bottom), (left, right) = (_same(n, k, s) for n in x.shape[-2:])
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """ReLU(conv + b) of an NCHW tensor, HWIO weight, "SAME" padding."""
    k = p["w"].shape[0]
    y = F.conv2d(_pad_same(x, k, stride, 0.0), p["w"].permute(3, 2, 0, 1),
                 stride=stride)
    return torch.relu(y + p["b"][:, None, None])


def _max_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """3x3 max-pool of an NCHW tensor, "SAME" padding with -inf."""
    return F.max_pool2d(_pad_same(x, 3, stride, float("-inf")), 3, stride)


def _inception(p, x: torch.Tensor) -> torch.Tensor:
    b1 = _conv(p["b1"], x)
    b3 = _conv(p["b3b"], _conv(p["b3a"], x))
    b5 = _conv(p["b5b"], _conv(p["b5a"], x))
    bp = _conv(p["bp"], _max_pool(x, 1))
    return torch.cat([b1, b3, b5, bp], dim=1)


@contextlib.contextmanager
def float32_math():
    """Full float32 convolutions and matmuls for the block: TF32 off in
    cuDNN and cuBLAS, and bf16 products summed in float32 (no reduced-
    precision split-K), the global flags restored after."""
    mm_flags = torch.backends.cuda.matmul
    conv = torch.backends.cudnn.allow_tf32
    mm = mm_flags.allow_tf32
    bf16 = mm_flags.allow_bf16_reduced_precision_reduction
    torch.backends.cudnn.allow_tf32 = False
    mm_flags.allow_tf32 = False
    mm_flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        mm_flags.allow_tf32 = mm
        mm_flags.allow_bf16_reduced_precision_reduction = bf16


def cnn_apply(params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, n_classes)."""
    with float32_math():
        x = x.movedim(-1, 1)
        x = _max_pool(_conv(params["stem"], x, stride=2), 2)
        x = _max_pool(_inception(params["inc1"], x), 2)
        x = _inception(params["inc2"], x)
        x = x.mean(dim=(2, 3))
        return torch.matmul(x, params["head"]["w"]) + params["head"]["b"]
