"""The 3DS-ISC array as a stateful module (the port of
``repro.core.isc_array``).

``ISCArray`` bundles the lazy SAE state with the cell fidelity model and
exposes the hardware operations:

  * ``write(state, events)``   -- event-driven O(E) scatter (Cu-Cu bond path)
  * ``read(state, t)``         -- analog readout: the decayed voltage map
  * ``read_mask(state, t)``    -- comparator readout vs V_tw (STCF front end)

Fidelity modes
  ``mode="3d"``      clean per-pixel writes (the paper's architecture)
  ``mode="2d"``      adds the crossbar half-select disturbance (Fig. 4):
                     each write droops every other cell in its row and
                     couples into its column; the state carries the
                     accumulated droop factor per cell.
  ``mode="ideal"``   infinite-precision digital TS (software baseline)

The per-cell Monte-Carlo variability (Fig. 5b) is drawn once at ``init``
by ``edram.sample_variability`` from a threefry key (``core.prng``) and
stored in the state: it is a physical property of each cell.  State is
functional here, as in the reference: ``write`` returns a new state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import edram
from repro_torch.core import time_surface as ts
from repro_torch.device import f32, resolve_device
from repro_torch.hw import constants as C


class ISCState(NamedTuple):
    sae: torch.Tensor           # (P, H, W) float32 seconds; -inf = never
    droop: torch.Tensor         # (P, H, W) float32 half-select droop factor
    params: edram.DecayParams   # per-cell (P, H, W) planes or scalars


class ISCArray:
    def __init__(
        self,
        h: int = C.QVGA_H,
        w: int = C.QVGA_W,
        polarities: int = 1,
        cmem_f: float = C.ISC_CMEM_F,
        tau_ideal: float = C.MEMORY_WINDOW_S,
        mode: str = "3d",
        variability: bool = True,
        hs_alpha: float = edram.HALF_SELECT_ALPHA,
        device=None,
    ):
        if mode not in ("3d", "2d", "ideal"):
            raise ValueError(f"mode must be '3d', '2d' or 'ideal', "
                             f"got {mode!r}")
        self.h, self.w, self.polarities = h, w, polarities
        self.mode = mode
        self.tau_ideal = tau_ideal
        self.variability = variability and mode != "ideal"
        self.hs_alpha = hs_alpha
        self.cmem_f = cmem_f
        self.base_params = edram.decay_params_for_cmem(cmem_f)
        self.device = resolve_device(device)

    # -- state ---------------------------------------------------------------
    def init(self, key: Optional[torch.Tensor] = None) -> ISCState:
        """A fresh array: never written, no droop, and per-cell decay
        parameters drawn from ``key`` when variability is on."""
        shape = (self.polarities, self.h, self.w)
        if self.variability:
            if key is None:
                raise ValueError("variability sampling needs a PRNG key "
                                 "(core.prng.PRNGKey)")
            params = edram.sample_variability(key.to(self.device), shape,
                                              self.base_params)
        else:
            params = self.base_params
        return ISCState(
            sae=ts.empty_sae(self.h, self.w, self.polarities, self.device),
            droop=torch.ones(shape, dtype=torch.float32, device=self.device),
            params=params,
        )

    # -- hardware ops ----------------------------------------------------------
    def write(self, state: ISCState, ev: ts.EventBatch) -> ISCState:
        """Event-driven write; in 2D mode also the half-select droop."""
        sae = ts.sae_update(state.sae, ev)
        droop = state.droop
        if self.mode == "2d":
            # each write refreshes its own cell (droop back to 1) and
            # half-selects every other cell of its row and column
            pp, h, w = sae.shape
            pol = ev.p if pp > 1 else torch.zeros_like(ev.p)
            # an index in [-dim, 0) wraps and any other out-of-range one
            # drops, as the reference's .at[].add(mode="drop") does
            pol, y, x = (torch.where(i < 0, i + n, i).long()
                         for i, n in ((pol, pp), (ev.y, h), (ev.x, w)))
            ok_row = ev.valid & (pol >= 0) & (pol < pp) & (y >= 0) & (y < h)
            ok_col = ev.valid & (pol >= 0) & (pol < pp) & (x >= 0) & (x < w)
            row_hits = torch.zeros((pp, h), dtype=torch.int32,
                                   device=sae.device)
            col_hits = torch.zeros((pp, w), dtype=torch.int32,
                                   device=sae.device)
            one = torch.ones_like(ev.x)
            row_hits.index_put_((pol[ok_row], y[ok_row]), one[ok_row],
                                accumulate=True)
            col_hits.index_put_((pol[ok_col], x[ok_col]), one[ok_col],
                                accumulate=True)
            rowf, colf = edram.half_select_factors(
                row_hits, col_hits, self.hs_alpha, edram.HALF_SELECT_COUPLING)
            droop = droop * rowf[:, :, None] * colf[:, None, :]
            ok = ok_row & (x >= 0) & (x < w)
            written = torch.zeros_like(droop, dtype=torch.bool)
            written[pol[ok], y[ok], x[ok]] = True
            refreshed = (sae > state.sae) | (state.sae == ts.NEVER)
            droop = torch.where(written & refreshed, torch.ones_like(droop),
                                droop)
        return ISCState(sae=sae, droop=droop, params=state.params)

    def read(self, state: ISCState, t_now) -> torch.Tensor:
        """Analog readout: (P, H, W) voltage (or ideal TS value) at
        ``t_now``."""
        if self.mode == "ideal":
            return ts.ts_ideal(state.sae, t_now, self.tau_ideal)
        v = ts.ts_edram(state.sae, t_now, state.params)
        if self.mode == "2d":
            v = v * state.droop
        return v

    def v_tw(self, tau_tw: float = C.MEMORY_WINDOW_S) -> float:
        return edram.v_tw_for_window(tau_tw, self.base_params)

    def read_mask(self, state: ISCState, t_now,
                  tau_tw: float = C.MEMORY_WINDOW_S) -> torch.Tensor:
        """Comparator readout: True where the cell fired within tau_tw."""
        dev = state.sae.device
        if self.mode == "ideal":
            return (f32(t_now, dev) - state.sae) < f32(tau_tw, dev)
        return self.read(state, t_now) > f32(self.v_tw(tau_tw), dev)
