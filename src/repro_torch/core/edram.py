"""The 3DS-ISC eDRAM cell model (paper Sec. III-A).

The port of ``repro.core.edram``: the double-exponential leakage transient
fitted to the paper's SPICE anchors, ``v(dt) = a1*exp(-dt/tau1) +
a2*exp(-dt/tau2) + b``, its per-cell Monte-Carlo spread
(``sample_variability``) and the 2D crossbar's half-select disturbance
(``apply_half_select``, Fig. 4).  Times are float32 **seconds**, voltages
float32 **volts**.

``DecayParams`` holds float32 values rounded from the same float64 fit as
the reference, so the two packages hold bitwise-equal parameters.  Uniform
parameters are ``np.float32`` host scalars: a kernel takes them by value,
and reading them never waits for the device.  Per-cell (H, W) parameter
planes are float32 tensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import f32
from repro_torch.hw import constants as C
from repro_torch.hw import spice_fit

Param = Union[np.float32, torch.Tensor]


class DecayParams(NamedTuple):
    """Double-exp decay parameters: float32 scalars or per-cell planes."""

    a1: Param
    tau1: Param
    a2: Param
    tau2: Param
    b: Param

    @classmethod
    def from_fit(cls, p: spice_fit.DoubleExpParams) -> "DecayParams":
        f32 = np.float32
        return cls(f32(p.a1), f32(p.tau1), f32(p.a2), f32(p.tau2), f32(p.b))

    @property
    def varied(self) -> bool:
        """Whether these are per-cell planes (Monte-Carlo variability)."""
        return isinstance(self.tau1, torch.Tensor) and self.tau1.dim() > 0


@functools.lru_cache(maxsize=None)
def _fit_cache(cmem_f: float) -> spice_fit.DoubleExpParams:
    base = spice_fit.fit_20ff()
    return spice_fit.scale_cmem(base, C.ISC_CMEM_F, cmem_f)


def decay_params_for_cmem(cmem_f: float = C.ISC_CMEM_F) -> DecayParams:
    """Decay parameters for a given storage capacitance (default 20 fF)."""
    return DecayParams.from_fit(_fit_cache(float(cmem_f)))


def rate_sigma() -> float:
    """Per-cell leakage-rate CV calibrated to the Fig. 5b Monte-Carlo data."""
    return spice_fit.calibrate_rate_sigma(spice_fit.fit_20ff())


def sample_variability(key: torch.Tensor, shape, params: DecayParams,
                       sigma: float | None = None) -> DecayParams:
    """Per-cell decay parameters: the leakage rate scaled by ``1 + sigma *
    N(0, 1)``, drawn from the threefry ``key`` (``core.prng``) on the
    key's device, so ``tau -> tau / eps`` (the paper's mapping of 8 000
    Monte-Carlo SPICE fits onto pixels, Sec. IV-C).  ``sigma`` defaults
    to the calibrated ``rate_sigma()``.  Returns (``shape``) float32
    planes."""
    if sigma is None:
        sigma = rate_sigma()
    dev = key.device
    eps = f32(1.0, dev) + f32(sigma, dev) * prng.normal(key, shape)
    full = lambda x: torch.full(tuple(shape), float(x), dtype=torch.float32,
                                device=dev)
    return DecayParams(a1=full(params.a1), tau1=f32(params.tau1, dev) / eps,
                       a2=full(params.a2), tau2=f32(params.tau2, dev) / eps,
                       b=full(params.b))


def v_mem(dt, params: DecayParams) -> torch.Tensor:
    """Cell voltage ``dt`` seconds after a write, in float32.

    ``dt`` may be +inf (never written) -> 0: an unwritten cell holds no
    charge (``b`` models the fit's floor, not a standing offset).
    """
    dt = f32(dt)
    p = [f32(x, dt.device) for x in params]
    v = p[0] * torch.exp(-dt / p[1]) + p[2] * torch.exp(-dt / p[3]) + p[4]
    return torch.where(torch.isfinite(dt), v, torch.zeros_like(v))


def ideal_exp(dt, tau: float) -> torch.Tensor:
    """The ideal software TS kernel exp(-dt/tau) (paper Eq. 3/5)."""
    dt = f32(dt)
    v = torch.exp(-dt / f32(tau, dt.device))
    return torch.where(torch.isfinite(dt), v, torch.zeros_like(v))


#: Fractional charge loss per half-select exposure (green cells of Fig. 4a):
#: the ON-state LL switch leaks the capacitor into the grounded WBL during
#: the selected cell's write pulse, a droop proportional to the stored
#: voltage.
HALF_SELECT_ALPHA = 0.05
#: Capacitive-coupling ripple for blue cells (WBL active, WWL off).
HALF_SELECT_COUPLING = 0.002


def half_select_factors(row_hits: torch.Tensor, col_hits: torch.Tensor,
                        alpha: float = HALF_SELECT_ALPHA,
                        coupling: float = HALF_SELECT_COUPLING):
    """``((1 - alpha)^row_hits, (1 - coupling)^col_hits)`` in float32,
    the bases rounded to float32 as the reference's weakly typed Python
    floats are."""
    dev = row_hits.device
    rowf = torch.pow(f32(1.0 - alpha, dev), row_hits.to(torch.float32))
    colf = torch.pow(f32(1.0 - coupling, dev), col_hits.to(torch.float32))
    return rowf, colf


def apply_half_select(v: torch.Tensor, row_hits: torch.Tensor,
                      col_hits: torch.Tensor,
                      alpha: float = HALF_SELECT_ALPHA,
                      coupling: float = HALF_SELECT_COUPLING) -> torch.Tensor:
    """Disturb a (H, W) voltage map given per-row (H,) / per-column (W,)
    write counts: a write at (r, c) droops every cell of row r by
    ``1 - alpha`` and couples ``1 - coupling`` into every cell of
    column c."""
    rowf, colf = half_select_factors(row_hits, col_hits, alpha, coupling)
    return v * rowf[:, None] * colf[None, :]


def v_tw_for_window(tau_tw: float, params: DecayParams) -> float:
    """Voltage threshold equivalent to a time window ``tau_tw`` (Fig. 10b),
    evaluated in float32 as the reference does (``v_mem(float32(tau_tw))``)
    and returned as a host float.

    The transient is monotone, so "written less than tau_tw ago" is exactly
    "V_mem above the transient's value at tau_tw".
    """
    return float(v_mem(np.float32(tau_tw), params))
