"""Read-fidelity descriptors, as far as the digital serving path needs.

The port of the descriptor half of ``repro.serve.fidelity``: a frozen,
hashable ``FidelityModel`` (``ideal`` | ``analog_3d`` | ``analog_2d``)
that a ``Surface`` product may carry, and the spec-level queries the
engine asks.  The port serves the digital (``ideal``) read only; the
analog cell physics and its noise draws are ROADMAP queue 1 item 9, and a
spec read that asks for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

from repro_torch.core import edram

__all__ = [
    "FidelityModel", "IDEAL", "resolved_sigma", "needs_noise",
    "product_fidelity", "spec_needs_noise", "spec_needs_hits",
    "spec_fidelity_mode", "ANALOG_NOT_PORTED",
]

_MODES = ("ideal", "analog_3d", "analog_2d")

#: what an analog read raises with
ANALOG_NOT_PORTED = (
    "analog-fidelity reads are not ported to repro_torch yet (ROADMAP "
    "queue 1 item 9: serve/fidelity.py cell_eps/crossbar_hits and "
    "edram.sample_variability); serve the digital read or use the JAX "
    "package"
)

#: Fractional charge loss per half-select exposure (Fig. 4a).
HALF_SELECT_ALPHA = 0.05
#: Capacitive-coupling ripple for blue cells (WBL active, WWL off).
HALF_SELECT_COUPLING = 0.002


@dataclasses.dataclass(frozen=True)
class FidelityModel:
    """A frozen, hashable read-fidelity descriptor (part of the spec).

    ``sigma`` is the relative per-cell leakage-rate spread (``None`` = the
    SPICE-calibrated ``edram.rate_sigma()``, ``0.0`` = no draw); ``seed``
    roots the noise stream; ``alpha``/``coupling`` are the 2D half-select
    droop fractions (``analog_2d`` only).
    """

    mode: str = "ideal"
    sigma: Optional[float] = None
    seed: int = 0
    alpha: float = HALF_SELECT_ALPHA
    coupling: float = HALF_SELECT_COUPLING

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"FidelityModel mode must be one of {_MODES}, "
                f"got {self.mode!r}"
            )
        if self.sigma is not None and not self.sigma >= 0.0:
            raise ValueError(
                f"FidelityModel sigma must be >= 0, got {self.sigma}"
            )
        if not (0.0 <= self.alpha < 1.0 and 0.0 <= self.coupling < 1.0):
            raise ValueError(
                f"half-select fractions must lie in [0, 1): "
                f"alpha={self.alpha}, coupling={self.coupling}"
            )

    @property
    def is_analog(self) -> bool:
        return self.mode != "ideal"


#: the digital read: attaching it is a no-op by construction
IDEAL = FidelityModel("ideal")


@functools.lru_cache(maxsize=1)
def _calibrated_sigma() -> float:
    return float(edram.rate_sigma())


def resolved_sigma(fid: FidelityModel) -> float:
    """The spread this model reads with (0.0 for the digital read)."""
    if not fid.is_analog:
        return 0.0
    return fid.sigma if fid.sigma is not None else _calibrated_sigma()


def needs_noise(fid: Optional[FidelityModel]) -> bool:
    """Whether serving this model draws per-cell noise."""
    return fid is not None and fid.is_analog and resolved_sigma(fid) > 0.0


def product_fidelity(p) -> Optional[FidelityModel]:
    """The fidelity model of one stage-0 product, or None.  Surface
    carries it directly; Mask/Stcf inherit through their ``decay``."""
    fid = getattr(p, "fidelity", None)
    if fid is None:
        fid = getattr(getattr(p, "decay", None), "fidelity", None)
    return fid


@functools.lru_cache(maxsize=256)
def spec_needs_noise(spec) -> bool:
    """Whether any product of ``spec`` draws per-cell noise."""
    return any(needs_noise(product_fidelity(p)) for _, p in spec.products)


@functools.lru_cache(maxsize=256)
def spec_needs_hits(spec) -> bool:
    """Whether any product of ``spec`` is analog_2d (and therefore needs
    the counter plane for its half-select row/column hit counts)."""
    return any(
        (fid := product_fidelity(p)) is not None and fid.mode == "analog_2d"
        for _, p in spec.products
    )


@functools.lru_cache(maxsize=256)
def spec_fidelity_mode(spec) -> str:
    """The most analog fidelity mode among a spec's products:
    analog_2d > analog_3d > ideal."""
    best = 0
    for _, p in spec.products:
        fid = product_fidelity(p)
        if fid is not None:
            best = max(best, _MODES.index(fid.mode))
    return _MODES[best]
