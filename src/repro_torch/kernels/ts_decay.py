"""CUDA wrapper of the ``ts_decay`` kernel (``csrc/ts_decay.cu``).

The time-surface decay read of every cell of an SAE tensor of any shape
(an (S, P, H, W) pool, or a (K, bh, bw) stack of dirty tiles), with the
comparator mask ``v > v_tw`` optionally written in the same pass.
Uniform parameters go to the kernel by value; per-cell (H, W) planes by
pointer, broadcast over the leading dims.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib


def ts_decay_cuda(sae: torch.Tensor, t_now, params,
                  v_tw: Optional[float] = None):
    """Launch the decay read on ``sae``'s device.  Returns ``v``, or
    ``(v, mask)`` when ``v_tw`` is given."""
    dev = sae.device
    _lib.check(sae, "sae", torch.float32, dev)
    out = torch.empty_like(sae)
    mask = None if v_tw is None else torch.empty(sae.shape, dtype=torch.bool,
                                                 device=dev)
    n = sae.numel()
    thr = 0.0 if v_tw is None else float(v_tw)
    if n:
        if params.varied:
            plane = params.tau1.shape
            if sae.shape[-len(plane):] != plane:
                raise ValueError(
                    f"parameter planes {tuple(plane)} do not match the SAE's "
                    f"trailing dims {tuple(sae.shape)}")
            for name, x in zip(params._fields, params):
                _lib.check(x, name, torch.float32, dev)
                if x.shape != plane:
                    raise ValueError(f"{name}: shape {tuple(x.shape)} != "
                                     f"{tuple(plane)}")
            _lib.launch("ts_decay", "ts_decay_planes", dev, sae.data_ptr(),
                        out.data_ptr(), _lib.ptr(mask), n, params.tau1.numel(),
                        float(t_now), *(x.data_ptr() for x in params), thr)
        else:
            _lib.launch("ts_decay", "ts_decay_uniform", dev, sae.data_ptr(),
                        out.data_ptr(), _lib.ptr(mask), n, float(t_now),
                        *(float(x) for x in params), thr)
    return out if mask is None else (out, mask)
