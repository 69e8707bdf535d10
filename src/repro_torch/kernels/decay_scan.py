"""CUDA wrapper of the ``decay_scan`` kernel (``csrc/decay_scan.cu``).

``s_t = a_t * s_{t-1} + x_t`` over (B, T, C), elementwise in C, from an
optional initial state ``s0`` (B, C) (zeros when None).  ``a`` and ``x``
are cast to float32 first, as the reference's ``decay_scan_pallas`` does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib

_MAX_BLOCKS = 2**31 - 1   # the kernel's 1-D grid of 256-thread blocks


def decay_scan_cuda(a: torch.Tensor, x: torch.Tensor,
                    s0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the recurrence on ``a``'s device.  Returns (states (B, T, C),
    final (B, C)), both float32."""
    dev = a.device
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"a and x must be (B, T, C) of one shape; got "
                         f"{tuple(a.shape)} and {tuple(x.shape)}")
    b, t, c = a.shape
    a = a.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    _lib.check(a, "a", torch.float32, dev)
    _lib.check(x, "x", torch.float32, dev)
    if s0 is not None:
        if s0.shape != (b, c):
            raise ValueError(f"s0: shape {tuple(s0.shape)} != {(b, c)}")
        s0 = s0.to(torch.float32).contiguous()
        _lib.check(s0, "s0", torch.float32, dev)
    if -(-b * c // 256) > _MAX_BLOCKS:
        raise ValueError(f"B*C = {b * c} exceeds the kernel's grid")
    out = torch.empty((b, t, c), dtype=torch.float32, device=dev)
    final = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b * c:
        _lib.launch("decay_scan", "decay_scan", dev, a.data_ptr(),
                    x.data_ptr(), _lib.ptr(s0), out.data_ptr(),
                    final.data_ptr(), b, t, c)
    return out, final
