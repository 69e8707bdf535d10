"""2D event representations (paper Sec. II-B) -- the comparison baselines.

The port of ``repro.core.representations``.  Each returns a (P, H, W) or
(H, W) image given an ``EventBatch``:

  * ``event_count``       count image, n_C-bit saturating counter [32,33]
  * ``ebbi``              event-based binary image [34,35]
  * ``sae``               raw last-timestamp surface (unbounded) [21,36]
  * ``ts_exponential``    ideal digital TS (Eq. 3/5) [22]
  * ``ts_sram_quantized`` TS from n_T-bit millisecond timestamps **with
                          counter wrap-around**, the overflow failure mode
                          the paper attributes to SRAM TPI storage [26]
  * ``local_memory_ts``   HATS-style accumulated decaying memory [37]

Images land on the device of the batch's tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import edram
from repro_torch.core import time_surface as ts
from repro_torch.device import f32


def _in_range(ev: ts.EventBatch, h: int, w: int) -> torch.Tensor:
    """Valid events with in-bounds coordinates."""
    return ev.valid & (ev.x >= 0) & (ev.x < w) & (ev.y >= 0) & (ev.y < h)


def event_count(ev: ts.EventBatch, h: int, w: int,
                n_bits: int = 4) -> torch.Tensor:
    """Saturating per-pixel event counter ((H, W) float32 in [0, 2^n-1])."""
    ok = _in_range(ev, h, w)
    cell = ev.y.long()[ok] * w + ev.x.long()[ok]
    cnt = torch.bincount(cell, minlength=h * w).to(torch.int32).reshape(h, w)
    from repro_torch.kernels import ops  # deferred: kernels sit above core

    return ops.event_count_read(cnt, n_bits=n_bits)


def ebbi(ev: ts.EventBatch, h: int, w: int) -> torch.Tensor:
    """Event-based binary image ((H, W) float32 in {0, 1})."""
    ok = _in_range(ev, h, w)
    img = torch.zeros((h, w), dtype=torch.float32, device=ev.x.device)
    img[ev.y.long()[ok], ev.x.long()[ok]] = 1.0
    return img


def sae(ev: ts.EventBatch, h: int, w: int,
        polarities: int = 1) -> torch.Tensor:
    """Raw surface of active events ((P, H, W) seconds; -inf = never)."""
    return ts.sae_update(ts.empty_sae(h, w, polarities, ev.x.device), ev)


def ts_exponential(ev: ts.EventBatch, h: int, w: int, t_read, tau: float,
                   polarities: int = 1) -> torch.Tensor:
    return ts.ts_ideal(sae(ev, h, w, polarities), t_read, tau)


def ts_sram_quantized(ev: ts.EventBatch, h: int, w: int, t_read, tau: float,
                      n_bits: int = 16, tick: float = 1e-3,
                      polarities: int = 1) -> torch.Tensor:
    """TS built from n_T-bit, ``tick``-second timestamps that WRAP on
    overflow: after 2^n ticks the stored stamps alias, so old events can
    masquerade as recent ones ([26], Sec. II-C).

    Each event's stamp is wrapped at write time (stamps are >= 0, as
    ``time_surface.rebase_times`` leaves them) by the quantizer of
    ``ops.ts_quantize_sae``, then the SAE of wrapped stamps is read
    through ``kernels.ops.ts_wrapped_read``, the entry the serving
    engine's ``TsQuantized`` product uses: offline and served reads of
    equal stored stamps are bitwise equal.
    """
    from repro_torch.kernels import ops, ref  # deferred: kernels sit above

    wrapped = ev._replace(t=ref.quantize_stamps(ev.t, n_bits, tick))
    s = ts.sae_update(ts.empty_sae(h, w, polarities, ev.x.device), wrapped)
    return ops.ts_wrapped_read(s, t_read, edram_ideal_params(tau),
                               n_bits=n_bits, tick=tick)


def edram_ideal_params(tau: float) -> edram.DecayParams:
    """The ideal exponential TS as a degenerate double-exp transient
    (``a1=1, a2=0, b=0``): both decay modes run through one kernel."""
    f32 = np.float32
    return edram.DecayParams(a1=f32(1.0), tau1=f32(tau), a2=f32(0.0),
                             tau2=f32(1.0), b=f32(0.0))


def local_memory_ts(ev: ts.EventBatch, h: int, w: int, t_read, tau: float,
                    polarities: int = 1, chunk: int = 256) -> torch.Tensor:
    """[37]-style local-memory TS: a sum of decaying exponentials per pixel.

    A per-pixel accumulator obeys ``A <- A*exp(-dt/tau) + events`` chunk by
    chunk (a Python loop of tensor ops over ``chunk``-event slices; each
    chunk's events enter decayed to the chunk's newest stamp), then decays
    to ``t_read``.  An index in [-dim, 0) wraps and any other out-of-range
    one drops, as the reference's ``.at[].add(mode="drop")``.
    """
    dev = ev.x.device
    tau_t = f32(tau, dev)
    acc = torch.zeros((polarities, h, w), dtype=torch.float32, device=dev)
    t_prev = f32(0.0, dev)
    n = ev.x.shape[0]
    for lo in range(0, n + (-n) % chunk, chunk):
        x, y, t, p, valid = (f[lo:lo + chunk] for f in ev)
        t_max = torch.where(valid, t, torch.full_like(t, ts.NEVER)).max()
        t_chunk = torch.where(valid.any(), t_max, t_prev)
        acc = acc * torch.exp(-(t_chunk - t_prev) / tau_t)
        p = p if polarities > 1 else torch.zeros_like(p)
        w_ev = torch.where(valid, torch.exp(-(t_chunk - t) / tau_t),
                           torch.zeros_like(t))
        p, y, x = (torch.where(i < 0, i + d, i).long()
                   for i, d in ((p, polarities), (y, h), (x, w)))
        ok = ((x >= 0) & (x < w) & (y >= 0) & (y < h) & (p >= 0)
              & (p < polarities))
        acc.view(-1).index_add_(0, ((p * h + y) * w + x)[ok], w_ev[ok])
        t_prev = t_chunk
    return acc * torch.exp(-(f32(t_read, dev) - t_prev) / tau_t)
