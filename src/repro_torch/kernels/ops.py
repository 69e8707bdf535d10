"""Public kernel entries, dispatched by the device of the tensor they get.

On a CUDA tensor every entry that has a kernel launches the hand-written
CUDA kernel (``csrc/``) and raises if it cannot; on a CPU tensor it runs
the plain PyTorch version in ``kernels.ref``.  There is no backend knob
and no fallback: the device of the data is the only switch.

As in the reference (``repro.kernels.ops``), every decay evaluation in the
port goes through the one ``ts_decay`` entry -- the dense read, the
gathered dirty tiles, the comparator mask -- and the decay is elementwise,
so a cell reads the same bits whatever shape it was read in.  That is
what makes dirty-tile incremental == dense and engine == offline hold
bitwise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import edram
from repro_torch.core import time_surface as ts
from repro_torch.device import f32
from repro_torch.kernels import ref as _ref


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for any other."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch kernels run on cuda or cpu, not {x.device}")


def ts_decay(sae: torch.Tensor, t_now, params) -> torch.Tensor:
    """Time-surface readout of an SAE of any shape (uniform params, or
    (H, W) parameter planes over the trailing dims)."""
    if _on_card(sae):
        from repro_torch.kernels.ts_decay import ts_decay_cuda

        return ts_decay_cuda(sae, t_now, params)
    return _ref.ts_decay_ref(sae, t_now, params)


def ts_decay_with_mask(sae: torch.Tensor, t_now, params, v_tw_static: float):
    """Readout plus the fused comparator mask (v > v_tw), one pass."""
    if _on_card(sae):
        from repro_torch.kernels.ts_decay import ts_decay_cuda

        return ts_decay_cuda(sae, t_now, params, v_tw=v_tw_static)
    return _ref.ts_decay_ref(sae, t_now, params, v_tw=v_tw_static)


def stcf_support(mask: torch.Tensor, radius: int = 3,
                 include_self: bool = False) -> torch.Tensor:
    """Patch support count of a (..., H, W) bool mask."""
    if _on_card(mask):
        from repro_torch.kernels.stcf import stcf_support_cuda

        return stcf_support_cuda(mask, radius, include_self)
    return _ref.stcf_support_ref(mask, radius, include_self)


def stcf_support_fused(sae: torch.Tensor, params, v_tw: float, t_now,
                       radius: int = 3,
                       include_self: bool = False) -> torch.Tensor:
    """Fused SAE -> decay -> comparator -> support (uniform params)."""
    if _on_card(sae):
        from repro_torch.kernels.stcf import stcf_support_cuda

        return stcf_support_cuda(sae, radius, include_self,
                                 fused=(params, v_tw, t_now))
    return _ref.stcf_support_fused_ref(sae, radius, params, v_tw, t_now,
                                       include_self)


def chunk_scatter_(
    sae: torch.Tensor,
    slot_ids: torch.Tensor,
    ev: ts.EventBatch,
    dirty: Optional[torch.Tensor] = None,
    block: Tuple[int, int] = (8, 128),
    counts: Optional[torch.Tensor] = None,
    t_last: Optional[torch.Tensor] = None,
    n_events: Optional[torch.Tensor] = None,
) -> None:
    """Max-combine B chunks (``ev`` fields (B, N)) into slots ``slot_ids``
    of an (S, P, H, W) pool **in place**, updating whichever of the
    dirty-tile marks, counter plane, ``t_last`` and ``n_events`` are given
    (the engine's whole scatter step, one kernel pass)."""
    if _on_card(sae):
        from repro_torch.kernels.ts_fused import chunk_scatter_cuda

        chunk_scatter_cuda(sae, slot_ids, ev, dirty, block, counts, t_last,
                           n_events)
    else:
        _ref.chunk_scatter_ref(sae, slot_ids, ev, dirty, block, counts,
                               t_last, n_events)


def chunk_scatter(sae: torch.Tensor, ev: ts.EventBatch) -> torch.Tensor:
    """Max-combine one padded chunk per leading index into a
    (..., P, H, W) SAE; ``ev`` fields are (..., N) with matching leading
    dims.  Returns the new SAE (the input is left as it was).  Polarity
    merges to plane 0 when P == 1; invalid and out-of-range events are
    dropped.  max never rounds, so the result is bitwise the reference's.
    """
    p, h, w = sae.shape[-3:]
    new = sae.reshape(-1, p, h, w).clone()
    fev = ts.EventBatch(*(f.reshape(-1, f.shape[-1]) for f in ev))
    sids = torch.arange(new.shape[0], dtype=torch.int32, device=sae.device)
    chunk_scatter_(new, sids, fev)
    return new.reshape(sae.shape)


def ts_fused(sae, ev, t_now, params, v_tw_static: Optional[float] = None):
    """Chunk scatter, then the decay read of the new SAE through the same
    ``ts_decay`` entry an unfused reader uses.  Returns ``(new_sae,
    surface)``, plus the comparator mask when ``v_tw_static`` is given."""
    new = chunk_scatter(sae, ev)
    if v_tw_static is None:
        return new, ts_decay(new, t_now, params)
    v, m = ts_decay_with_mask(new, t_now, params, v_tw_static)
    return new, v, m


def decay_scan(a: torch.Tensor, x: torch.Tensor,
               s0: Optional[torch.Tensor] = None):
    """``s_t = a_t*s_{t-1} + x_t`` over (B, T, C) in float32, from ``s0``
    (B, C) or zeros.  Returns (states (B, T, C), final (B, C)).

    Differentiable on either device: on the card through ``DecayScan``
    (the forward kernel, and the backward kernel for its gradients), on
    the CPU through autograd of the plain version.  On ``meta`` tensors
    (the dry run) ``DecayScan`` computes nothing: it returns empty meta
    tensors and charges ``_lib.META_COSTS`` with the kernels' work."""
    if a.device.type == "meta" or _on_card(a):
        from repro_torch.kernels.decay_scan import DecayScan

        return DecayScan.apply(a, x, s0)
    return _ref.decay_scan_ref(a, x, s0)


# ----------------------------------------------------------------------------
# wrapped n-bit timestamps ([26]'s SRAM TPI storage)
# ----------------------------------------------------------------------------

def ts_quantize_sae(sae: torch.Tensor, n_bits: int = 16,
                    tick: float = 1e-3) -> torch.Tensor:
    """Wrap a raw SAE's stamps to n-bit ``tick``-second storage: the value
    the hardware would actually hold.  NEVER cells stay NEVER.  Stamps
    must be >= 0 (``time_surface.rebase_times``).  ``floor`` is monotone,
    so quantizing the maxed raw SAE equals maxing per-event quantized
    stamps whenever the stream spans less than one wrap period."""
    fin = torch.isfinite(sae)
    safe = torch.where(fin, sae, torch.zeros_like(sae))
    return torch.where(fin, _ref.quantize_stamps(safe, n_bits, tick),
                       torch.full_like(sae, ts.NEVER))


def ts_wrapped_read(stored: torch.Tensor, t_read, params, n_bits: int = 16,
                    tick: float = 1e-3) -> torch.Tensor:
    """TS readout over wrapped stamps (``ts_quantize_sae``): the hardware
    cannot know how many wraps happened, so the elapsed time is modular and
    ancient events alias as recent ([26]'s periodic corruption).

    The modular age is folded into a virtual SAE read at ``t_now = 0``
    (``sae' = -dt``, so the decay's ``0 - sae'`` is ``dt`` exactly) and
    read through the one ``ts_decay`` entry: on a CUDA tensor the
    hand-written kernel.
    """
    dt = _ref.wrapped_age(stored, t_read, n_bits, tick)
    virtual = torch.where(torch.isfinite(stored), -dt,
                          torch.full_like(dt, ts.NEVER))
    return ts_decay(virtual, 0.0, params)


def ts_analog_read(sae: torch.Tensor, t_now, params,
                   eps: Optional[torch.Tensor] = None,
                   row_hits: Optional[torch.Tensor] = None,
                   col_hits: Optional[torch.Tensor] = None,
                   alpha: float = 0.05,
                   coupling: float = 0.002) -> torch.Tensor:
    """Analog eDRAM readout: the leakage transient with a per-cell rate
    spread ``eps`` (``edram.sample_variability``'s ``tau -> tau / eps``),
    plus the 2D crossbar's half-select droop from per-row (..., H) and
    per-column (..., W) write counts.

    A rate spread is a per-cell dilation of the elapsed time, so it is
    folded into a virtual SAE read at ``t_now = 0`` (``sae' = -(dt *
    eps)``; the decay's ``0 - sae'`` is ``dt * eps`` exactly) and read
    through the one ``ts_decay`` entry: on a CUDA tensor the hand-written
    kernel.  With ``eps=None`` and no hits the call **is** ``ts_decay``
    on ``sae``, bitwise (the sigma = 0 anchor).  The droop multiplies
    ``(1 - alpha)^row_hits`` over rows, then ``(1 - coupling)^col_hits``
    over columns.
    """
    if eps is None:
        v = ts_decay(sae, t_now, params)
    else:
        dt = f32(t_now, sae.device) - sae
        virtual = torch.where(torch.isfinite(sae), -(dt * eps),
                              torch.full_like(dt, ts.NEVER))
        v = ts_decay(virtual, 0.0, params)
    if row_hits is None and col_hits is None:
        return v
    if row_hits is None or col_hits is None:
        raise ValueError("row_hits and col_hits must be given together")
    rowf, colf = edram.half_select_factors(row_hits, col_hits, alpha,
                                           coupling)
    return v * rowf[..., :, None] * colf[..., None, :]


# ----------------------------------------------------------------------------
# dirty-tile incremental readout (plain tensor indexing around ts_decay)
# ----------------------------------------------------------------------------

def tile_geometry(h: int, w: int, block: Tuple[int, int]):
    """(tiles_h, tiles_w, tiles_per_plane) for one (H, W) plane under a
    (bh, bw) tiling: the one source of the dirty-tile cache layout."""
    bh, bw = block
    th, tw = -(-h // bh), -(-w // bw)
    return th, tw, th * tw


def _gather_dirty_tiles(sae: torch.Tensor, idx: torch.Tensor,
                        block: Tuple[int, int]) -> torch.Tensor:
    """Gather tiles ``idx`` of (L, H, W) planes as (K, bh, bw), padded
    with NEVER past the plane edges (the decay of NEVER is 0, the value
    the dense tiling pads with)."""
    _, h, w = sae.shape
    bh, bw = block
    _, tw, tpl = tile_geometry(h, w, block)
    li, r = idx // tpl, idx % tpl
    ys = (r // tw)[:, None] * bh + torch.arange(bh, device=sae.device)
    xs = (r % tw)[:, None] * bw + torch.arange(bw, device=sae.device)
    tiles = sae[li[:, None, None], ys.clamp(max=h - 1)[:, :, None],
                xs.clamp(max=w - 1)[:, None, :]]
    inb = (ys < h)[:, :, None] & (xs < w)[:, None, :]
    return torch.where(inb, tiles, torch.full_like(tiles, ts.NEVER))


def _tile_surface(v: torch.Tensor, block: Tuple[int, int]) -> torch.Tensor:
    """(L, H, W) surface -> (L*T, bh, bw) tiled layout, edge tiles
    zero-padded."""
    l, h, w = v.shape
    bh, bw = block
    th, tw, tpl = tile_geometry(h, w, block)
    vp = torch.nn.functional.pad(v, (0, tw * bw - w, 0, th * bh - h))
    return (vp.reshape(l, th, bh, tw, bw).permute(0, 1, 3, 2, 4)
            .reshape(l * tpl, bh, bw))


def _untile_surface(cache: torch.Tensor, h: int, w: int,
                    block: Tuple[int, int]) -> torch.Tensor:
    """(L*T, bh, bw) tiled cache -> (L, H, W) dense surface."""
    bh, bw = block
    th, tw, tpl = tile_geometry(h, w, block)
    l = cache.shape[0] // tpl
    v = cache.reshape(l, th, tw, bh, bw).permute(0, 1, 3, 2, 4)
    return v.reshape(l, th * bh, tw * bw)[:, :h, :w]


def ts_fused_dirty(
    sae: torch.Tensor,     # (..., H, W) post-scatter SAE planes
    cache: torch.Tensor,   # (L*T, bh, bw) tiled last readout
    dirty: torch.Tensor,   # (L*T,) bool: tiles written since the cache fill
    t_now,
    params,
    max_dirty: int,
    block: Tuple[int, int] = (8, 128),
    force_dense: bool = False,
):
    """Dirty-tile incremental readout against a cached last readout.

    Only the tiles written since the cache fill are re-read through
    ``ts_decay`` (on the gathered (K, bh, bw) stack) and patched into the
    cache; clean tiles keep their cached bits.  When more than
    ``max_dirty`` tiles are dirty, or ``force_dense`` is set (``t_now``
    moved), the whole surface re-reads through ``ts_decay`` exactly as an
    unfused reader does.  Requires that clean tiles hold the readout of
    the current SAE at this ``t_now``.  Reading the dirty tiles' indices
    is this op's one host sync.

    Returns ``(surface, cache, dirty)``: surface shaped like ``sae``; the
    cache is patched in place (or replaced by a dense fill), and ``dirty``
    is cleared in place.
    """
    lead = sae.shape[:-2]
    h, w = sae.shape[-2:]
    _, _, tpl = tile_geometry(h, w, block)
    l = sae.numel() // (h * w)
    if cache.shape != (l * tpl,) + tuple(block) or dirty.shape != (l * tpl,):
        raise ValueError(f"cache {tuple(cache.shape)} / dirty "
                         f"{tuple(dirty.shape)} do not tile {tuple(sae.shape)}"
                         f" under block {block}")
    k = max(1, min(int(max_dirty), l * tpl))
    idx = None if force_dense else torch.nonzero(dirty).flatten()
    if idx is None or idx.numel() > k:
        v = ts_decay(sae, t_now, params)
        dirty.zero_()
        return v, _tile_surface(v.reshape(l, h, w), block), dirty
    if idx.numel():
        tiles = _gather_dirty_tiles(sae.reshape(l, h, w), idx, block)
        cache[idx] = ts_decay(tiles, t_now, params)
        dirty.zero_()
    surface = _untile_surface(cache, h, w, block).reshape(lead + (h, w))
    return surface, cache, dirty


# ----------------------------------------------------------------------------
# slot-pool forms of the Sec. II-B comparison representations
# ----------------------------------------------------------------------------

def event_count_read(counts: torch.Tensor, n_bits: int = 4) -> torch.Tensor:
    """Saturating n-bit readout of a (..., H, W) int32 counter plane."""
    return torch.clamp(counts, max=2 ** n_bits - 1).to(torch.float32)


def ebbi_read(sae: torch.Tensor) -> torch.Tensor:
    """Event-based binary image off a (..., P, H, W) SAE: 1.0 where any
    polarity plane was ever written (polarity-merged)."""
    return torch.isfinite(sae).any(dim=-3).to(torch.float32)
