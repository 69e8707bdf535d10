"""Analog-fidelity models: serve reads through the eDRAM cell physics.

The port of ``repro.serve.fidelity``.  A ``FidelityModel`` attaches the
analog side of the paper's power/accuracy trade to a surface-like spec
product (masks and STCF products inherit through their ``decay``):

    ``ideal``      the digital read (the default, a no-op marker)
    ``analog_3d``  the 3DS-ISC cell: the double-exp leakage transient plus
                   a per-cell Monte-Carlo leakage-rate spread
    ``analog_2d``  the 2D-integration strawman: all of the above plus the
                   crossbar's half-select droop (Fig. 4)

An analog read lowers to ``kernels.ops.ts_analog_read`` (the spread folded
into a virtual SAE read through the ``ts_decay`` kernel), and sigma = 0 is
bitwise the digital read.

Determinism: the per-cell noise of slot ``s`` is drawn from the threefry
key ``fold_in(fold_in(PRNGKey(seed), noise_step), generation[s])``
(``core.prng``, the reference's stream), where ``noise_step`` is the
stream runtime's step index and ``generation`` the slot's attach epoch.
Both are in the stream's action log, so the synchronous replay oracle
redraws every cell bitwise on the same device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core import edram
from repro_torch.core import prng
from repro_torch.device import f32

__all__ = [
    "FidelityModel", "IDEAL", "analog_3d", "analog_2d", "resolved_sigma",
    "needs_noise", "cell_eps", "crossbar_hits", "product_fidelity",
    "spec_needs_noise", "spec_needs_hits", "spec_fidelity_mode",
]

_MODES = ("ideal", "analog_3d", "analog_2d")


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
    alpha: float = edram.HALF_SELECT_ALPHA
    coupling: float = edram.HALF_SELECT_COUPLING

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


def analog_3d(sigma: Optional[float] = None, seed: int = 0) -> FidelityModel:
    """The 3DS-ISC analog cell: leakage transient + per-cell spread."""
    return FidelityModel("analog_3d", sigma=sigma, seed=seed)


def analog_2d(sigma: Optional[float] = None, seed: int = 0,
              alpha: float = edram.HALF_SELECT_ALPHA,
              coupling: float = edram.HALF_SELECT_COUPLING) -> FidelityModel:
    """The 2D-integration strawman: analog cell + half-select droop."""
    return FidelityModel("analog_2d", sigma=sigma, seed=seed, alpha=alpha,
                         coupling=coupling)


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


def cell_eps(fid: FidelityModel, noise_step: int, generation: torch.Tensor,
             pol_shape) -> torch.Tensor:
    """Per-cell leakage-rate multipliers, ``(S,) + pol_shape`` float32 on
    ``generation``'s device: ``eps[s] = 1 + sigma * N(0, 1)`` drawn from
    ``fold_in(fold_in(PRNGKey(seed), noise_step), generation[s])``, the
    key contract the replay oracle reproduces."""
    dev = generation.device
    base = prng.fold_in(prng.PRNGKey(fid.seed, dev), int(noise_step))
    keys = prng.fold_in(base, generation)
    return f32(1.0, dev) + f32(resolved_sigma(fid), dev) * prng.normal(
        keys, tuple(pol_shape))


def crossbar_hits(counts: torch.Tensor):
    """Per-row / per-column write counts for the half-select model from
    the (S, H, W) counter plane: every write to (y, x) half-selects all
    of row y and couples into all of column x.  Shaped (S, 1, H) /
    (S, 1, W) to broadcast over polarity."""
    return counts.sum(dim=-1)[:, None, :], counts.sum(dim=-2)[:, None, :]


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
