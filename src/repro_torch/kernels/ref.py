"""Plain PyTorch versions of every kernel (the correctness contracts).

The CPU path of ``kernels.ops`` runs these, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.  Each is written one
elementwise op per step, in the order of the kernel's arithmetic, so the
CUDA kernel (IEEE, no FMA contraction) can match it bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import time_surface as ts
from repro_torch.device import f32
from repro_torch.models.cnn import cnn_apply


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-element distance between two float32 tensors in ULP steps
    (the bits mapped onto one monotone integer line, on which +0 and -0
    coincide), as int64."""
    def key(x):
        i = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -0x80000000 - i, i)

    return (key(a) - key(b)).abs()


def ts_decay_ref(sae: torch.Tensor, t_now, params,
                 v_tw: Optional[float] = None):
    """Double-exp readout of an SAE (+ the comparator mask ``v > v_tw``).

    ``params`` holds float32 scalars, or (H, W) planes broadcast over the
    leading dims (time constants clamped at 1e-9 s, as the TPU kernel's
    driver clamps them).
    """
    dev = sae.device
    a1, tau1, a2, tau2, b = (f32(x, dev) for x in params)
    if params.varied:
        tau1, tau2 = tau1.clamp_min(1e-9), tau2.clamp_min(1e-9)
    dt = f32(t_now, dev) - sae
    v = a1 * torch.exp(-dt / tau1) + a2 * torch.exp(-dt / tau2) + b
    v = torch.where(torch.isfinite(sae), v, torch.zeros_like(v))
    if v_tw is None:
        return v
    return v, v > f32(v_tw, dev)


def ts_fused_ref(sae: torch.Tensor, x, y, p, t, t_now, params,
                 v_tw: Optional[float] = None):
    """Max-combine scatter, then the decay read: the plain version of the
    ``chunk_scatter`` -> ``ts_decay`` pair.

    ``sae``: (P, H, W); ``x``/``y``/``p``: (N,) int32 coordinates
    (polarity merged by the caller); ``t``: (N,) float32 with invalid
    events masked to -inf by the caller (they never win the max).
    Out-of-range coordinates are dropped before the scatter, so a
    negative index never wraps.  Returns ``(new_sae, surface)`` or
    ``(new_sae, surface, mask)``; ``sae`` is left as it was.
    """
    pp, h, w = sae.shape
    ok = (x >= 0) & (x < w) & (y >= 0) & (y < h) & (p >= 0) & (p < pp)
    idx = (p[ok].long() * h + y[ok].long()) * w + x[ok].long()
    new = sae.clone()
    ts.scatter_max_(new.view(-1), idx, t[ok])
    out = ts_decay_ref(new, t_now, params, v_tw=v_tw)
    if v_tw is None:
        return new, out
    return (new,) + out


def stcf_support_ref(mask: torch.Tensor, radius: int,
                     include_self: bool = False) -> torch.Tensor:
    """(2r+1)^2 patch count of a (..., H, W) bool mask, zero outside."""
    r = radius
    h, w = mask.shape[-2:]
    x = torch.nn.functional.pad(mask.to(torch.int32), (r, r, r, r))
    acc = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            if include_self or (dy, dx) != (r, r):
                acc += x[..., dy:dy + h, dx:dx + w]
    return acc


def stcf_support_fused_ref(sae, radius, params, v_tw, t_now,
                           include_self=False) -> torch.Tensor:
    """SAE -> decay -> comparator -> support, composed from the above."""
    _, m = ts_decay_ref(sae, t_now, params, v_tw=v_tw)
    return stcf_support_ref(m, radius, include_self)


def _mod(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``jnp.mod`` of float32 tensors: the exact ``fmod``, plus the divisor
    where the remainder is nonzero and its sign differs from the
    divisor's."""
    r = torch.fmod(x, m)
    fix = (r != 0) & ((r < 0) != (m < 0))
    return torch.where(fix, r + m, r)


def quantize_stamps(t: torch.Tensor, n_bits: int, tick: float) -> torch.Tensor:
    """Stamps ``t`` (seconds, >= 0) as n-bit ``tick``-second storage holds
    them: ``floor(t * (1/tick)) mod 2^n`` ticks, back in float32 seconds.
    The reference's compiled op multiplies by the float32 reciprocal of
    ``tick`` (XLA rewrites a division by a constant so) rather than
    dividing; the two can floor to different ticks where ``t / tick`` lies
    within a rounding error of an integer, and this is the one the
    reference stores."""
    dev = t.device
    tick_t = f32(tick, dev)
    ticks = torch.floor(t * (f32(1.0, dev) / tick_t)).to(torch.int64)
    return (ticks % (2 ** n_bits)).to(torch.float32) * tick_t


def wrapped_age(stored: torch.Tensor, t_read, n_bits: int, tick: float
                ) -> torch.Tensor:
    """Modular age of wrapped n-bit stamps at ``t_read``: the read time
    wrapped to ``floor(t_read / tick) mod 2^n`` ticks, then ``(t_read_w -
    stored) mod 2^n*tick``, in float32 (``tick`` and the period rounded to
    float32, as the reference's weakly typed Python floats are; the read
    time divided, as the reference's plain oracle divides it)."""
    dev = stored.device
    tick_t = f32(tick, dev)
    q = torch.floor(f32(t_read, dev) / tick_t)
    t_read_w = _mod(q, f32(2 ** n_bits, dev)) * tick_t
    return _mod(t_read_w - stored, f32((2 ** n_bits) * tick, dev))


def ts_wrapped_read_ref(stored: torch.Tensor, t_read, tau: float,
                        n_bits: int = 16, tick: float = 1e-3) -> torch.Tensor:
    """Plain version of ``ops.ts_wrapped_read`` with the ideal decay: the
    direct [26] formula ``exp(-dt/tau)`` on the modular age, written
    without the virtual-SAE folding the op uses."""
    dt = wrapped_age(stored, t_read, n_bits, tick)
    dt = torch.where(torch.isfinite(stored), dt,
                     torch.full_like(dt, float("inf")))
    v = torch.exp(-dt / f32(tau, stored.device))
    return torch.where(torch.isfinite(dt), v, torch.zeros_like(v))


def ts_analog_read_ref(sae: torch.Tensor, t_read, params, eps=None,
                       row_hits=None, col_hits=None, alpha: float = 0.05,
                       coupling: float = 0.002) -> torch.Tensor:
    """Plain version of ``ops.ts_analog_read``: the direct Sec. IV-C cell
    physics, written per cell without the virtual-SAE folding the op
    uses.  The rate spread ``eps`` dilates each cell's elapsed time
    through the double-exp transient, then the 2D half-select droop
    multiplies ``(1 - alpha)^row_hits`` per row and ``(1 -
    coupling)^col_hits`` per column."""
    dev = sae.device
    a1, tau1, a2, tau2, b = (f32(x, dev) for x in params)
    dt = f32(t_read, dev) - sae
    if eps is not None:
        dt = dt * eps
    v = a1 * torch.exp(-dt / tau1) + a2 * torch.exp(-dt / tau2) + b
    v = torch.where(torch.isfinite(sae), v, torch.zeros_like(v))
    if row_hits is not None:
        rowf = torch.pow(f32(1.0 - alpha, dev), row_hits.to(torch.float32))
        colf = torch.pow(f32(1.0 - coupling, dev), col_hits.to(torch.float32))
        v = v * rowf[..., :, None] * colf[..., None, :]
    return v


def classify_ref(params, surfaces) -> torch.Tensor:
    """Plain version of the ``Classify`` head: K pool reads, each
    (S, P, H, W), stacked on the channel axis (the k-th input's
    polarities at channels [k*P, (k+1)*P), restated here rather than
    imported from the frontend) and fed to ``models.cnn.cnn_apply``."""
    x = torch.cat([torch.as_tensor(s) for s in surfaces], dim=1)
    return cnn_apply(params, x.movedim(1, -1))


def denoise_ref(support: torch.Tensor, threshold: int) -> torch.Tensor:
    """Plain version of the ``Denoise`` head: the per-pixel label map of an
    STCF support read (True = signal)."""
    return support >= threshold


def chunk_scatter_ref(
    sae: torch.Tensor,                       # (S, P, H, W), updated in place
    slot_ids: torch.Tensor,                  # (B,) int32
    ev: ts.EventBatch,                       # (B, N) fields
    dirty: Optional[torch.Tensor] = None,    # (S, TP) bool
    block: Tuple[int, int] = (8, 128),       # dirty-tile (bh, bw)
    counts: Optional[torch.Tensor] = None,   # (S, H, W) int32
    t_last: Optional[torch.Tensor] = None,   # (S,) float32
    n_events: Optional[torch.Tensor] = None, # (S,) int32
) -> None:
    """Max-combine B event chunks into their slots, in place, and update
    the dirty-tile marks, the polarity-merged counter plane and each
    slot's ``t_last``/``n_events`` (the reference engine's
    ``_scatter_chunks``).

    One plane (P == 1) merges polarity.  Invalid events, events outside
    the plane or the polarity range, and rows aimed outside [0, S) touch
    nothing.
    """
    s, p, h, w = sae.shape
    sid = slot_ids.long()[:, None].expand(ev.x.shape)
    pol = torch.zeros_like(ev.p) if p == 1 else ev.p
    ok = (ev.valid & (ev.x >= 0) & (ev.x < w) & (ev.y >= 0) & (ev.y < h)
          & (pol >= 0) & (pol < p) & (sid >= 0) & (sid < s))
    sid, pol = sid[ok], pol[ok].long()
    x, y, t = ev.x[ok].long(), ev.y[ok].long(), ev.t[ok]
    ts.scatter_max_(sae.view(-1), ((sid * p + pol) * h + y) * w + x, t)
    if dirty is not None:
        bh, bw = block
        th, tw = -(-h // bh), -(-w // bw)
        tid = (pol * th + y // bh) * tw + x // bw
        dirty.view(-1)[sid * dirty.shape[1] + tid] = True
    if counts is not None:
        cells, n = torch.unique(sid * (h * w) + y * w + x, return_counts=True)
        counts.view(-1)[cells] += n.to(torch.int32)
    if t_last is not None:
        ts.scatter_max_(t_last, sid, t)
    if n_events is not None:
        slots, n = torch.unique(sid, return_counts=True)
        n_events[slots] += n.to(torch.int32)


def decay_scan_ref(a: torch.Tensor, x: torch.Tensor,
                   s0: Optional[torch.Tensor] = None):
    """``s_t = a_t * s_{t-1} + x_t`` over (B, T, C) in float32, a Python
    loop over T with the product and the sum as two separate ops (each
    rounded once, as the kernel's ``__fadd_rn(__fmul_rn(..))``).  ``s0``
    (B, C) defaults to zeros.  Returns (states (B, T, C), final (B, C))."""
    a, x = a.to(torch.float32), x.to(torch.float32)
    b, t, c = a.shape
    s = (torch.zeros((b, c), dtype=torch.float32, device=a.device)
         if s0 is None else s0.to(torch.float32, copy=True))
    out = torch.empty((b, t, c), dtype=torch.float32, device=a.device)
    for i in range(t):
        s = a[:, i] * s + x[:, i]
        out[:, i] = s
    return out, s


def decay_scan_bwd_ref(a: torch.Tensor, states: torch.Tensor,
                       s0: Optional[torch.Tensor], g: torch.Tensor,
                       g_final: Optional[torch.Tensor] = None):
    """The backward of ``decay_scan_ref``: from the gradients ``g`` of the
    states (B, T, C) and ``g_final`` of the final state (B, C; None for
    none), walk ``lam_t = g_t + a_{t+1} * lam_{t+1}`` from t = T-1 down
    (``lam_{T-1} = g_{T-1} + g_final``) and return ``(da, dx, ds0)``:
    ``dx_t = lam_t``, ``da_t = lam_t * s_{t-1}`` (``s_{-1}`` = ``s0``, or
    0) and ``ds0 = a_0 * lam_0`` (None when ``s0`` is None).  Every
    product and two-term sum is one op, rounded once, as in the kernel's
    ``decay_scan_bwd``, so the two agree bitwise."""
    a, states, g = (v.to(torch.float32) for v in (a, states, g))
    b, t, c = a.shape
    da = torch.empty_like(states)
    dx = torch.empty_like(states)
    if t == 0:
        ds0 = None if s0 is None else (
            torch.zeros((b, c), dtype=torch.float32, device=a.device)
            if g_final is None else g_final.to(torch.float32, copy=True))
        return da, dx, ds0
    lam = g[:, t - 1] if g_final is None else g[:, t - 1] + g_final
    for i in range(t - 1, -1, -1):
        if i < t - 1:
            lam = g[:, i] + a[:, i + 1] * lam
        prev = (states[:, i - 1] if i else
                torch.zeros_like(lam) if s0 is None else s0.to(torch.float32))
        dx[:, i] = lam
        da[:, i] = lam * prev
    return da, dx, None if s0 is None else a[:, 0] * lam
