"""AER (Address-Event Representation) packing utilities.

Real DVS links ship events as packed words (x, y, polarity, timestamp
delta).  We provide a bit-exact 64-bit packing (16b x, 16b y, 1b p, 31b
t in microseconds) used by the serialization tests and the checkpointable
event-replay buffers.
"""
from __future__ import annotations

import numpy as np

from repro_torch.events import synthetic as syn

T_TICK_S = 1e-6  # microsecond ticks, DVS convention
_T_MASK = (1 << 31) - 1


def pack(s: syn.EventStream) -> np.ndarray:
    t_us = np.round(s.t / T_TICK_S).astype(np.uint64) & _T_MASK
    w = (
        (s.x.astype(np.uint64) << 48)
        | (s.y.astype(np.uint64) << 32)
        | (s.p.astype(np.uint64) << 31)
        | t_us
    )
    return w


def unpack(w: np.ndarray, h: int, wdt: int) -> syn.EventStream:
    x = ((w >> 48) & 0xFFFF).astype(np.int32)
    y = ((w >> 32) & 0xFFFF).astype(np.int32)
    p = ((w >> 31) & 0x1).astype(np.int32)
    t = (w & _T_MASK).astype(np.float64) * T_TICK_S
    return syn.EventStream(
        x=x, y=y, t=t.astype(np.float32), p=p,
        is_signal=np.ones(len(x), bool), h=h, w=wdt,
    )
