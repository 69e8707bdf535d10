"""CUDA wrapper of the ``chunk_scatter`` kernel (``csrc/ts_fused.cu``).

Max-combines B padded event chunks into their slots of an (S, P, H, W)
SAE pool **in place**, and updates in the same pass whichever of the
dirty-tile marks, the counter plane, ``t_last`` and ``n_events`` the
caller hands in (each updated in place too; the port mutates pool state
rather than copying a whole pool per push).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import time_surface as ts
from repro_torch.kernels import _lib

_MAX_ROWS = 65535   # the kernel's grid y-extent
_MAX_TILES = 1 << 16   # dirty tiles of one slot: the kernel's shared bitmap
#: event slots of one chunk row that one block sorts and merges
SEGMENT = 2048


def chunk_scatter_cuda(
    sae: torch.Tensor,
    slot_ids: torch.Tensor,
    ev: ts.EventBatch,
    dirty: Optional[torch.Tensor] = None,
    block: Tuple[int, int] = (8, 128),
    counts: Optional[torch.Tensor] = None,
    t_last: Optional[torch.Tensor] = None,
    n_events: Optional[torch.Tensor] = None,
) -> None:
    dev = sae.device
    _lib.check(sae, "sae", torch.float32, dev)
    if sae.dim() != 4:
        raise ValueError(f"sae must be (S, P, H, W), got {tuple(sae.shape)}")
    s, p, h, w = sae.shape
    _lib.check(slot_ids, "slot_ids", torch.int32, dev)
    if ev.x.dim() != 2 or slot_ids.shape != ev.x.shape[:1]:
        raise ValueError(f"events must be (B, N) with slot_ids (B,); got "
                         f"{tuple(ev.x.shape)} and {tuple(slot_ids.shape)}")
    b, n = ev.x.shape
    if b > _MAX_ROWS:
        raise ValueError(f"{b} chunks exceed the kernel's {_MAX_ROWS}")
    if (h * w) << (p - 1).bit_length() >= 1 << 31:
        raise ValueError(f"an (H, W) = {(h, w)} plane with {p} polarities "
                         "does not fit the kernel's 31-bit sort key")
    for name, dtype in (("x", torch.int32), ("y", torch.int32),
                        ("t", torch.float32), ("p", torch.int32),
                        ("valid", torch.bool)):
        f = getattr(ev, name)
        _lib.check(f, name, dtype, dev)
        if f.shape != (b, n):
            raise ValueError(f"{name}: shape {tuple(f.shape)} != {(b, n)}")
    bh, bw = block
    if dirty is not None:
        _lib.check(dirty, "dirty", torch.bool, dev)
        tp = p * -(-h // bh) * -(-w // bw)
        if dirty.shape != (s, tp):
            raise ValueError(f"dirty: shape {tuple(dirty.shape)} != {(s, tp)}")
        if tp > _MAX_TILES:
            raise ValueError(f"{tp} dirty tiles per slot exceed the "
                             f"kernel's {_MAX_TILES}")
    if counts is not None:
        _lib.check(counts, "counts", torch.int32, dev)
        if counts.shape != (s, h, w):
            raise ValueError(f"counts: shape {tuple(counts.shape)} != "
                             f"{(s, h, w)}")
    for name, x, dtype in (("t_last", t_last, torch.float32),
                           ("n_events", n_events, torch.int32)):
        if x is not None:
            _lib.check(x, name, dtype, dev)
            if x.shape != (s,):
                raise ValueError(f"{name}: shape {tuple(x.shape)} != {(s,)}")
    if not (b and n and sae.numel()):
        return
    _lib.launch("chunk_scatter", "chunk_scatter", dev, sae.data_ptr(), s, p,
                h, w, slot_ids.data_ptr(), ev.x.data_ptr(), ev.y.data_ptr(),
                ev.p.data_ptr(), ev.t.data_ptr(), ev.valid.data_ptr(), b, n,
                _lib.ptr(dirty), bh, bw, _lib.ptr(counts), _lib.ptr(t_last),
                _lib.ptr(n_events))
