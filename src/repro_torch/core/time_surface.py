"""Time-surface construction (paper Sec. II-B / III).

The port of ``repro.core.time_surface``.  The SAE (surface of active
events) stores the last write time per cell; "never written" is -inf, so
``t_now - sae`` is +inf and every decay read maps it to 0.  Readout is
lazy: nothing is computed between events.

Event batches are fixed-capacity tensors (padded, ``valid`` masked), the
layout the engine's scatter kernel takes.

The reference's ``lax.scan``s (``events_to_frames``, ``streaming_ts``)
are loops over frames or chunks here, with the same semantics.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import edram
from repro_torch.device import f32, resolve_device

NEVER = float("-inf")


def rebase_times(t, epoch) -> np.ndarray:
    """Rebase absolute timestamps against ``epoch`` (host-side, exact
    float64 subtraction) and cast the *small* result to float32.

    float32 carries ~24 mantissa bits: at t = 3600 s one ulp is ~0.4 ms,
    coarser than event-camera microsecond stamps.  Every surface quantity
    depends only on time differences, so a stream rebased to its first
    event reads out bit-identically to the same stream offered at t = 0.
    """
    t64 = np.asarray(t, np.float64)
    return (t64 - np.float64(epoch)).astype(np.float32)


class EventBatch(NamedTuple):
    """A fixed-capacity batch of AER events (padded with valid=False)."""

    x: torch.Tensor      # (..., N) int32 column
    y: torch.Tensor      # (..., N) int32 row
    t: torch.Tensor      # (..., N) float32 seconds
    p: torch.Tensor      # (..., N) int32 polarity in {0, 1}
    valid: torch.Tensor  # (..., N) bool

    def to(self, device) -> "EventBatch":
        return EventBatch(*(f.to(device) for f in self))


def empty_sae(h: int, w: int, polarities: int = 1, device=None) -> torch.Tensor:
    """(P, H, W) float32 SAE initialized to 'never written', on ``device``
    (default: the CUDA device; raises when there is none)."""
    return torch.full((polarities, h, w), NEVER, dtype=torch.float32,
                      device=resolve_device(device))


class SurfaceState(NamedTuple):
    """One sensor's surface, or a pool of them along a leading slot axis."""

    sae: torch.Tensor       # (..., P, H, W) float32 last-write times
    t_last: torch.Tensor    # (...,) float32 latest valid event time
    n_events: torch.Tensor  # (...,) int32 running count of valid events


def surface_init(h: int, w: int, polarities: int = 1,
                 device=None) -> SurfaceState:
    """Fresh per-sensor surface state ('never written' everywhere), on
    ``device`` (default: the CUDA device; raises when there is none)."""
    device = resolve_device(device)
    return SurfaceState(
        sae=empty_sae(h, w, polarities, device),
        t_last=torch.zeros((), dtype=torch.float32, device=device),
        n_events=torch.zeros((), dtype=torch.int32, device=device),
    )


def surface_update(state: SurfaceState, ev: EventBatch,
                   merge_polarity: bool = False) -> SurfaceState:
    """Scatter one (N,) event batch into one sensor's state, returning the
    new state (``t_last`` is the latest valid stamp seen, ``n_events``
    counts the valid events)."""
    sae = sae_update(state.sae, ev, merge_polarity=merge_polarity)
    t_valid = torch.where(ev.valid, ev.t, torch.full_like(ev.t, NEVER))
    t_max = t_valid.max() if t_valid.numel() else t_valid.new_tensor(NEVER)
    return SurfaceState(
        sae=sae,
        t_last=torch.maximum(state.t_last, t_max),
        n_events=state.n_events + ev.valid.sum().to(torch.int32),
    )


def surface_read(state: SurfaceState, t_now, tau: Optional[float] = None,
                 params=None) -> torch.Tensor:
    """Read the TS off a SurfaceState: ideal (``tau``) or eDRAM
    (``params``), in plain tensor ops.  The kernel-backed form the serving
    engine shares is ``surface_read_kernel``."""
    if params is not None:
        return ts_edram(state.sae, t_now, params)
    if tau is None:
        raise ValueError("pass tau (ideal) or params (edram)")
    return ts_ideal(state.sae, t_now, tau)


def ts_ideal(sae: torch.Tensor, t_now, tau: float) -> torch.Tensor:
    """Paper Eq. (5): TS = exp(-(t_now - SAE)/tau), in [0, 1]."""
    return edram.ideal_exp(f32(t_now, sae.device) - sae, tau)


def ts_edram(sae: torch.Tensor, t_now, params: edram.DecayParams
             ) -> torch.Tensor:
    """Hardware TS: the eDRAM voltage map f(t_now - SAE) in volts
    (``params`` may hold per-cell planes)."""
    return edram.v_mem(f32(t_now, sae.device) - sae, params)


def window_mask_ideal(sae: torch.Tensor, t_now, tau_tw: float) -> torch.Tensor:
    """Ideal digital comparison: event within the time window tau_tw."""
    return (f32(t_now, sae.device) - sae) < f32(tau_tw, sae.device)


def window_mask_edram(sae: torch.Tensor, t_now, params: edram.DecayParams,
                      v_tw) -> torch.Tensor:
    """Hardware comparison: V_mem > V_tw (one comparator per pixel)."""
    return ts_edram(sae, t_now, params) > f32(v_tw, sae.device)


def scatter_max_(flat: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """``flat[idx] = max(flat[idx], val)`` in place, duplicates combined by
    max, in plain tensor ops (no scatter-reduce primitive).

    Sorting by value and then stably by index puts each index's largest
    value last in its run; those run ends are unique indices, so one
    indexed assignment writes them.  max never rounds, so the result is
    bitwise the reference's ``.at[].max``.
    """
    if idx.numel() == 0:
        return flat
    val, order = torch.sort(val, stable=True)
    idx, order2 = torch.sort(idx[order], stable=True)
    val = val[order2]
    last = torch.ones_like(idx, dtype=torch.bool)
    last[:-1] = idx[1:] != idx[:-1]
    idx, val = idx[last], val[last]
    flat[idx] = torch.maximum(flat[idx], val)
    return flat


def sae_update(sae: torch.Tensor, ev: EventBatch,
               merge_polarity: bool = False) -> torch.Tensor:
    """Scatter one (N,) event batch into a (P, H, W) SAE (max-combine),
    returning a new SAE.

    max-combine makes the update order-independent within a batch, which
    is exactly the eDRAM semantics: a later write leaves the higher
    voltage.  Invalid events write nothing; an index in [-dim, 0) wraps
    (as Python indexing does) and any other out-of-range one drops, as in
    the reference's ``.at[].max(mode="drop")``.  This is the
    offline builder; the serving engine writes through the scatter kernel
    (``kernels.ops.chunk_scatter``).
    """
    pp, h, w = sae.shape
    p = torch.zeros_like(ev.p) if merge_polarity or pp == 1 else ev.p
    p, y, x = (torch.where(i < 0, i + n, i).long()
               for i, n in ((p, pp), (ev.y, h), (ev.x, w)))
    ok = (ev.valid & (x >= 0) & (x < w) & (y >= 0) & (y < h)
          & (p >= 0) & (p < pp))
    idx = (p * h + y) * w + x
    out = sae.clone()
    scatter_max_(out.view(-1), idx[ok], ev.t[ok])
    return out


def surface_read_kernel(state: SurfaceState, t_now, params) -> torch.Tensor:
    """Kernel-backed readout of a SurfaceState (any leading batch dims).

    The serving engine reads its whole slot pool through this same entry
    (``kernels.ops.ts_decay``), so an offline reader and the engine are
    bit-identical given equal SAE state.
    """
    from repro_torch.kernels import ops  # deferred: kernels sit above core

    return ops.ts_decay(state.sae, t_now, params)


def events_to_frames(
    ev: EventBatch,
    h: int,
    w: int,
    t_starts: torch.Tensor,
    frame_dt: float,
    tau: float,
    polarities: int = 1,
    params: Optional[edram.DecayParams] = None,
) -> torch.Tensor:
    """Per-window TS frames of one event batch, (F, P, H, W) on the
    events' device: frame f is the TS read at ``t_starts[f] + frame_dt``
    from all events with t < that time.  ``params=None`` -> ideal
    exponential TS; else the eDRAM model (planes allowed).

    Each frame re-scatters the whole masked batch, as the reference does
    for clarity; ``streaming_ts`` writes each event once.
    """
    sae = empty_sae(h, w, polarities, ev.t.device)
    frames = []
    for t_start in torch.as_tensor(t_starts, dtype=torch.float32,
                                   device=ev.t.device):
        t_read = t_start + f32(frame_dt, t_start.device)
        sae = sae_update(sae, ev._replace(valid=ev.valid & (ev.t < t_read)))
        frames.append(ts_ideal(sae, t_read, tau) if params is None
                      else ts_edram(sae, t_read, params))
    return torch.stack(frames)


def streaming_ts(
    chunks: EventBatch,
    h: int,
    w: int,
    read_times: torch.Tensor,
    tau: float,
    polarities: int = 1,
    params: Optional[edram.DecayParams] = None,
) -> torch.Tensor:
    """Write event chunks ((K, N) fields) in turn, each event once, and
    read the TS after each chunk at ``read_times[k]``: the production
    streaming form, O(E) writes and lazy decay at read time only.
    Returns (K, P, H, W) on the chunks' device."""
    dev = chunks.t.device
    state = surface_init(h, w, polarities, dev)
    frames = []
    for k, t_read in enumerate(torch.as_tensor(read_times,
                                               dtype=torch.float32,
                                               device=dev)):
        state = surface_update(state, EventBatch(*(f[k] for f in chunks)))
        frames.append(surface_read(state, t_read, tau=tau, params=params))
    return torch.stack(frames)
