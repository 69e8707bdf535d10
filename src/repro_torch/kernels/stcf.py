"""CUDA wrapper of the ``stcf_support`` kernel (``csrc/stcf.cu``).

Per-pixel STCF patch-support counts over a (..., H, W) stack of planes:
of a bool mask, or fused, of an SAE decayed and compared on load.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib

_MAX_PLANES = 65535   # the kernel's grid z-extent


def _max_radius() -> int:
    return _lib.library()[0].stcf_max_radius()


def stcf_support_cuda(x: torch.Tensor, radius: int, include_self: bool,
                      fused: Optional[tuple] = None) -> torch.Tensor:
    """Support count, int32 shaped like ``x``.

    ``fused=None``: ``x`` is a bool mask.  ``fused=(params, v_tw, t_now)``:
    ``x`` is a float32 SAE with uniform decay parameters.
    """
    dev = x.device
    if x.dim() < 2:
        raise ValueError(f"expected (..., H, W), got shape {tuple(x.shape)}")
    _lib.check(x, "sae" if fused else "mask",
               torch.float32 if fused else torch.bool, dev)
    if not 0 <= radius <= _max_radius():
        raise ValueError(f"radius {radius} outside [0, {_max_radius()}]")
    h, w = x.shape[-2:]
    planes = x.numel() // (h * w) if h * w else 0
    if planes > _MAX_PLANES:
        raise ValueError(f"{planes} planes exceed the kernel's {_MAX_PLANES}")
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    if not x.numel():
        return out
    if fused is None:
        _lib.launch("stcf_support", "stcf_support_mask", dev, x.data_ptr(),
                    out.data_ptr(), planes, h, w, radius, int(include_self))
    else:
        params, v_tw, t_now = fused
        if params.varied:
            raise ValueError("the fused support read takes uniform params")
        _lib.launch("stcf_support", "stcf_support_fused", dev, x.data_ptr(),
                    out.data_ptr(), planes, h, w, radius, int(include_self),
                    float(t_now), *(float(p) for p in params), float(v_tw))
    return out
