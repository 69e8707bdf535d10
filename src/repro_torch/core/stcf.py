"""Spatio-Temporal Correlation Filter denoiser (paper Sec. IV-C, ref [51]).

The port of ``repro.core.stcf``.  An incoming event is *signal* if at
least ``threshold`` cells in the (2r+1)^2 patch around it hold a timestamp
within the correlation window ``tau_tw``:

  * ideal mode     -- digital comparison  (t_event - SAE_patch) < tau_tw
  * hardware mode  -- comparator          V_mem_patch > V_tw  (Fig. 10b)

``stcf_reference`` is the exact event-serial oracle (a Python loop over
events); ``stcf_chunked`` the production form: events in fixed-size
chunks against the pre-chunk SAE, plus an O(N^2) pairwise intra-chunk
term.  Both gather each event's patch of SAE stamps and compare only
those cells -- the same elementwise comparison as reading the window mask
of the whole SAE per event, at (2r+1)^2 cells per event.  The dense
support map the serving engine reads is the ``stcf_support`` kernel
(``kernels.ops``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import edram
from repro_torch.core import time_surface as ts
from repro_torch.device import f32
from repro_torch.hw import constants as C


class STCFConfig(NamedTuple):
    radius: int = 3                 # (2r+1)x(2r+1) patch; r=3 -> 7x7 as in [26]
    tau_tw: float = C.MEMORY_WINDOW_S
    threshold: int = 2              # min supporting cells
    include_self: bool = False      # count the event's own cell's past write
    polarity_sensitive: bool = False


def _patch(shape, x, y, p, cfg: STCFConfig):
    """Each event's (2r+1)^2 patch: flat cell indices into a (P, H, W)
    plane stack (clamped at the edges) and the in-bounds mask, both
    (N, K), with the event's own cell already dropped from the mask unless
    ``include_self``."""
    pp, h, w = shape
    r = cfg.radius
    pol = p if cfg.polarity_sensitive and pp > 1 else torch.zeros_like(p)
    offs = torch.arange(-r, r + 1, device=x.device)
    oy, ox = (o.reshape(-1)
              for o in torch.meshgrid(offs, offs, indexing="ij"))
    yy = y.long()[:, None] + oy[None, :]
    xx = x.long()[:, None] + ox[None, :]
    inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    if not cfg.include_self:
        inb = inb & ~((oy == 0) & (ox == 0))[None, :]
    cell = ((pol.long()[:, None] * h + yy.clamp(0, h - 1)) * w
            + xx.clamp(0, w - 1))
    return cell, inb


def _in_window(dt: torch.Tensor, cfg: STCFConfig, mode: str, params,
               v_tw) -> torch.Tensor:
    """The window test on elapsed times ``dt``: ``dt < tau_tw`` (ideal) or
    ``v_mem(dt) > v_tw`` (edram), elementwise in float32."""
    if mode == "ideal":
        return dt < f32(cfg.tau_tw, dt.device)
    return edram.v_mem(dt, params) > f32(v_tw, dt.device)


def _patch_support_at(sae: torch.Tensor, x, y, t, p, cfg: STCFConfig,
                      mode: str, params, v_tw) -> torch.Tensor:
    """Support count per event ((N,) int32) against a (P, H, W) SAE, by
    gathering the patch of stamps around each event and testing them at
    the event's own time t."""
    cell, inb = _patch(sae.shape, x, y, p, cfg)
    dt = t[:, None] - sae.reshape(-1)[cell]
    return (_in_window(dt, cfg, mode, params, v_tw) & inb).sum(
        dim=-1).to(torch.int32)


def resolve_edram(cfg: STCFConfig, mode: str,
                  params: Optional[edram.DecayParams] = None, v_tw=None):
    """Fill in (params, v_tw) defaults for the analog comparator path."""
    if mode != "edram":
        return None, None
    params_ = params if params is not None else edram.decay_params_for_cmem()
    v_tw_ = (v_tw if v_tw is not None
             else edram.v_tw_for_window(cfg.tau_tw, params_))
    return params_, v_tw_


def stcf_reference(ev: ts.EventBatch, h: int, w: int,
                   cfg: STCFConfig = STCFConfig(), mode: str = "ideal",
                   params: Optional[edram.DecayParams] = None, v_tw=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact serial STCF.  Returns (support (N,) int32, is_signal (N,)
    bool).  Events must be time-sorted; each one's support counts every
    earlier write, then the event writes its cell."""
    pols = 2 if cfg.polarity_sensitive else 1
    params_, v_tw_ = resolve_edram(cfg, mode, params, v_tw)
    sae = ts.empty_sae(h, w, pols, ev.x.device)
    n = ev.x.shape[0]
    support = torch.zeros(n, dtype=torch.int32, device=ev.x.device)
    for i in range(n):
        e = ts.EventBatch(*(f[i:i + 1] for f in ev))
        support[i] = _patch_support_at(sae, e.x, e.y, e.t, e.p, cfg, mode,
                                       params_, v_tw_)[0]
        sae = ts.sae_update(sae, e)
    return support, (support >= cfg.threshold) & ev.valid


def stcf_chunk_support(sae: torch.Tensor, ch: ts.EventBatch, cfg: STCFConfig,
                       mode: str = "ideal",
                       params: Optional[edram.DecayParams] = None, v_tw=None,
                       intra_chunk: bool = True) -> torch.Tensor:
    """Support ((N,) int32) of one chunk's events against the pre-chunk
    (P, H, W) SAE.  Pure read -- it does not advance the SAE.  Per slot
    this is the serving engine's labeled ingest; with the scatter added
    (``stcf_chunk_step``) it is the loop body of ``stcf_chunked``.
    ``params``/``v_tw`` must be resolved (``resolve_edram``) when
    ``mode == "edram"``."""
    sup = _patch_support_at(sae, ch.x, ch.y, ch.t, ch.p, cfg, mode, params,
                            v_tw)
    if intra_chunk:
        # event j supports event i if j is earlier, valid, within the
        # patch and (edram) still above the threshold at t_i: (N, N)
        r = cfg.radius
        dy = ch.y[:, None] - ch.y[None, :]
        dx = ch.x[:, None] - ch.x[None, :]
        near = (dy.abs() <= r) & (dx.abs() <= r)
        if not cfg.include_self:
            near = near & ~((dy == 0) & (dx == 0))
        earlier = (ch.t[None, :] < ch.t[:, None]) & ch.valid[None, :]
        if cfg.polarity_sensitive and sae.shape[0] > 1:
            near = near & (ch.p[:, None] == ch.p[None, :])
        dt = ch.t[:, None] - ch.t[None, :]
        if mode != "ideal":
            dt = dt.clamp_min(0.0)
        inwin = _in_window(dt, cfg, mode, params, v_tw)
        sup = sup + (near & earlier & inwin).sum(dim=-1).to(torch.int32)
    return sup


def stcf_chunk_step(sae: torch.Tensor, ch: ts.EventBatch, cfg: STCFConfig,
                    mode: str = "ideal",
                    params: Optional[edram.DecayParams] = None, v_tw=None,
                    intra_chunk: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One STCF step: chunk support, then scatter the chunk into the SAE.
    Returns ``(new_sae, support (chunk,) int32)``."""
    sup = stcf_chunk_support(sae, ch, cfg, mode=mode, params=params,
                             v_tw=v_tw, intra_chunk=intra_chunk)
    sae = ts.sae_update(sae, ch, merge_polarity=not cfg.polarity_sensitive)
    return sae, sup


def stcf_chunked(ev: ts.EventBatch, h: int, w: int,
                 cfg: STCFConfig = STCFConfig(), chunk: int = 128,
                 mode: str = "ideal",
                 params: Optional[edram.DecayParams] = None, v_tw=None,
                 intra_chunk: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked STCF: a Python loop of ``stcf_chunk_step`` over the chunks.
    Events must be time-sorted and padded to a multiple of ``chunk``.
    Returns (support (N,) int32, is_signal (N,) bool)."""
    n = ev.x.shape[0]
    if n % chunk:
        raise ValueError(f"{n} events: pad the batch to a multiple of the "
                         f"chunk size {chunk}")
    pols = 2 if cfg.polarity_sensitive else 1
    params_, v_tw_ = resolve_edram(cfg, mode, params, v_tw)
    sae = ts.empty_sae(h, w, pols, ev.x.device)
    sups = []
    for lo in range(0, n, chunk):
        ch = ts.EventBatch(*(f[lo:lo + chunk] for f in ev))
        sae, sup = stcf_chunk_step(sae, ch, cfg, mode=mode, params=params_,
                                   v_tw=v_tw_, intra_chunk=intra_chunk)
        sups.append(sup)
    support = (torch.cat(sups) if sups
               else torch.zeros(0, dtype=torch.int32, device=ev.x.device))
    return support, (support >= cfg.threshold) & ev.valid


def roc_curve(scores: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
              n_thresholds: int = 64):
    """ROC over integer support scores, sweeping the threshold over
    0..n_thresholds.  ``labels``: True = signal.  Returns (fpr, tpr, auc),
    float32."""
    ths = torch.arange(n_thresholds + 1, device=scores.device)
    pos = labels & valid
    neg = ~labels & valid
    pred = scores[None, :] >= ths[:, None]
    tpr = (pred & pos).sum(dim=-1) / pos.sum().clamp_min(1)
    fpr = (pred & neg).sum(dim=-1) / neg.sum().clamp_min(1)
    order = torch.argsort(fpr, stable=True)
    f, t = fpr[order], tpr[order]
    auc = 0.5 * (torch.diff(f) * (t[1:] + t[:-1])).sum()
    return fpr, tpr, auc
