"""Declarative readout specs: *what to read*, not *which method to call*.

The port of the stage-0 half of ``repro.serve.spec``.  A ``ReadoutSpec``
is an immutable, hashable composition of named surface products, all read
off the same slot-pool state in one pass::

    surface(...)   decayed time surface (the classic TS readout)
    mask(...)      comparator mask V > V_tw (denoiser front end)
    stcf(...)      dense STCF patch-support map
    count(n_bits)  saturating per-pixel event counter  [refs 32, 33]
    ebbi()         event-based binary image            [refs 34, 35]
    sae_raw()      raw last-timestamp surface (-inf = never) [21, 36]

Not ported yet, and so not constructible here: ``ts_quantized`` (waits
for ``ts_wrapped_read``, ROADMAP queue 3), the stage-1 heads
``classify``/``denoise`` (ROADMAP queue 1 item 8), and analog-fidelity
reads (item 9; a read that asks for one raises ``NotImplementedError``).

Bit-identity contract: each product calls the same ``kernels.ops`` entry
its standalone read uses, so the ``surface()`` product of any spec is
bitwise a standalone ``ops.ts_decay`` of the same state.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import edram
from repro_torch.core import representations as representations_mod
from repro_torch.kernels import ops
from repro_torch.serve import fidelity as fidelity_mod
from repro_torch.serve.fidelity import FidelityModel

__all__ = [
    "ReadoutSpec", "Surface", "Mask", "Stcf", "Count", "Ebbi", "SaeRaw",
    "surface", "mask", "stcf", "count", "ebbi", "sae_raw", "SURFACE_SPEC",
    "needs_counts", "CompiledSpec", "compile_spec", "resolve_static",
    "resolve_dynamic", "read_stage0",
]


@dataclasses.dataclass(frozen=True)
class Surface:
    """Decayed time surface.  ``mode``/``tau``/``cmem_f`` default to the
    engine config's decay (None = inherit); overriding them serves a
    second decay profile off the same SAE.  ``fidelity`` names an analog
    read model (not ported: reading one raises)."""

    mode: Optional[str] = None       # "edram" | "ideal" | None (engine's)
    tau: Optional[float] = None      # ideal-TS decay constant override
    cmem_f: Optional[float] = None   # eDRAM storage-cap override
    fidelity: Optional[FidelityModel] = None

    def __post_init__(self):
        if self.mode not in (None, "edram", "ideal"):
            raise ValueError(f"Surface mode {self.mode!r}")
        if self.fidelity is not None and not isinstance(
            self.fidelity, FidelityModel
        ):
            raise TypeError(
                f"Surface fidelity must be a FidelityModel, "
                f"got {self.fidelity!r}"
            )


@dataclasses.dataclass(frozen=True)
class Mask:
    """Comparator mask V > V_tw (one bool plane per polarity).
    ``tau_tw`` overrides the engine's correlation window."""

    tau_tw: Optional[float] = None
    decay: Surface = Surface()


@dataclasses.dataclass(frozen=True)
class Stcf:
    """Dense STCF patch-support map (int32 per pixel): SAE -> decay ->
    comparator -> patch sum, fused in one kernel pass."""

    radius: Optional[int] = None     # None = engine's stcf_radius
    tau_tw: Optional[float] = None   # None = engine's correlation window
    include_self: bool = False
    decay: Surface = Surface()


@dataclasses.dataclass(frozen=True)
class Count:
    """Saturating n-bit per-pixel event counter (float32 in [0, 2^n-1]),
    polarity-merged.  Needs the engine's counter plane
    (``TSEngineConfig.specs``)."""

    n_bits: int = 4


@dataclasses.dataclass(frozen=True)
class Ebbi:
    """Event-based binary image: 1.0 where any event landed since the
    slot was attached (polarity-merged)."""


@dataclasses.dataclass(frozen=True)
class SaeRaw:
    """The raw surface of active events: last write time per cell in
    seconds, -inf = never written."""


_STAGE0_TYPES = (Surface, Mask, Stcf, Count, Ebbi, SaeRaw)

surface = Surface
mask = Mask
stcf = Stcf
count = Count
ebbi = Ebbi
sae_raw = SaeRaw


class ReadoutSpec:
    """An immutable, hashable composition of named readout products::

        ReadoutSpec(surface=surface(), stcf=stcf(), count=count(4))

    Two specs with the same (name, product) pairs are equal and hash
    equal regardless of construction order.
    """

    __slots__ = ("products", "_hash")

    def __init__(self, **products):
        if not products:
            raise ValueError("a ReadoutSpec needs at least one product")
        for name, p in products.items():
            if not isinstance(p, _STAGE0_TYPES):
                raise TypeError(
                    f"product {name!r} must be one of "
                    f"{[t.__name__ for t in _STAGE0_TYPES]}, got {p!r} "
                    "(ts_quantized, classify and denoise are not ported "
                    "to repro_torch yet; see ROADMAP)"
                )
            if isinstance(p, Count) and not (
                isinstance(p.n_bits, int) and 1 <= p.n_bits <= 24
            ):
                raise ValueError(
                    f"product {name!r}: Count.n_bits must be an int in "
                    f"[1, 24], got {p.n_bits!r}"
                )
        object.__setattr__(self, "products", tuple(sorted(products.items())))
        object.__setattr__(self, "_hash", hash(self.products))

    def __setattr__(self, *_):
        raise AttributeError("ReadoutSpec is immutable")

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return (isinstance(other, ReadoutSpec)
                and self.products == other.products)

    def __repr__(self):
        inner = ", ".join(f"{n}={p!r}" for n, p in self.products)
        return f"ReadoutSpec({inner})"

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.products)

    def __contains__(self, name: str) -> bool:
        return any(n == name for n, _ in self.products)

    def __getitem__(self, name: str):
        for n, p in self.products:
            if n == name:
                return p
        raise KeyError(name)

    def surface_products(self) -> Tuple[Tuple[str, Surface], ...]:
        return tuple((n, p) for n, p in self.products
                     if isinstance(p, Surface))


#: the spec behind the classic readout: one decayed surface, engine decay
SURFACE_SPEC = ReadoutSpec(surface=Surface())


def needs_counts(spec: ReadoutSpec) -> bool:
    """Whether serving ``spec`` requires the pool's counter plane."""
    return (any(isinstance(p, Count) for _, p in spec.products)
            or fidelity_mod.spec_needs_hits(spec))


# ----------------------------------------------------------------------------
# spec resolution: descriptors -> decay params and comparator thresholds
# ----------------------------------------------------------------------------

def _decay_params(p: Surface, cfg) -> edram.DecayParams:
    """Decay params for one surface-like product under engine config
    ``cfg``; every ``None`` field inherits.  Overrides the resolved mode
    cannot use fail fast instead of being silently ignored."""
    mode = p.mode or cfg.mode
    if mode == "ideal":
        if p.fidelity is not None and p.fidelity.is_analog:
            raise ValueError(
                f"surface product resolves to mode='ideal' but carries "
                f"analog fidelity {p.fidelity.mode!r}; the analog models "
                "emulate the eDRAM cell (pass mode='edram' or drop the "
                "fidelity)"
            )
        if p.cmem_f is not None:
            raise ValueError(
                f"surface product resolves to mode='ideal' but sets "
                f"cmem_f={p.cmem_f}; cmem_f only shapes the eDRAM "
                "transient (pass mode='edram' or drop it)"
            )
        return representations_mod.edram_ideal_params(
            p.tau if p.tau is not None else cfg.tau
        )
    if p.tau is not None:
        raise ValueError(
            f"surface product resolves to mode='edram' but sets "
            f"tau={p.tau}; tau only shapes the ideal exponential "
            "(pass mode='ideal' or drop it)"
        )
    return edram.decay_params_for_cmem(
        p.cmem_f if p.cmem_f is not None else cfg.cmem_f
    )


def _v_tw(decay: Surface, tau_tw: Optional[float], cfg) -> float:
    """Comparator threshold for a window product (host float; the
    kernels compare in float32)."""
    tw = tau_tw if tau_tw is not None else cfg.tau_tw
    mode = decay.mode or cfg.mode
    if mode == "ideal":
        tau = decay.tau if decay.tau is not None else cfg.tau
        return float(np.exp(-tw / tau))
    return edram.v_tw_for_window(tw, _decay_params(decay, cfg))


def resolve_static(spec: ReadoutSpec, cfg) -> Tuple[Tuple[str, float], ...]:
    """Per-product comparator thresholds: ``(name, v_tw)`` pairs."""
    return tuple(
        (name, _v_tw(p.decay, p.tau_tw, cfg))
        for name, p in spec.products if isinstance(p, (Mask, Stcf))
    )


def resolve_dynamic(spec: ReadoutSpec, cfg) -> Dict[str, edram.DecayParams]:
    """Per-product decay params for ``spec`` under ``cfg``."""
    dyn: Dict[str, edram.DecayParams] = {}
    for name, p in spec.products:
        if isinstance(p, Surface):
            dyn[name] = _decay_params(p, cfg)
        elif isinstance(p, (Mask, Stcf)):
            dyn[name] = _decay_params(p.decay, cfg)
    return dyn


class CompiledSpec(NamedTuple):
    """A spec planned under one engine config: its products' decay
    params (``dynamic``) and comparator thresholds (``statics``)."""

    spec: ReadoutSpec
    dynamic: Dict[str, edram.DecayParams]
    statics: Dict[str, float]


def compile_spec(spec: ReadoutSpec, cfg) -> CompiledSpec:
    """Resolve ``spec``'s decay params and thresholds under ``cfg``."""
    return CompiledSpec(spec, resolve_dynamic(spec, cfg),
                        dict(resolve_static(spec, cfg)))


def read_stage0(
    sae: torch.Tensor,                       # (S, P, H, W) slot-pool SAE
    counts: Optional[torch.Tensor],          # (S, H, W) int32 or None
    t_now,
    compiled: CompiledSpec,
    cfg,                                     # TSEngineConfig
) -> Dict[str, torch.Tensor]:
    """Every product of a compiled spec, read off the pool state, in the
    spec's canonical name order."""
    dynamic, v_tws = compiled.dynamic, compiled.statics
    out: Dict[str, torch.Tensor] = {}
    for name, p in compiled.spec.products:
        fid = fidelity_mod.product_fidelity(p)
        if fid is not None and fid.is_analog:
            raise NotImplementedError(
                f"product {name!r}: {fidelity_mod.ANALOG_NOT_PORTED}")
        if isinstance(p, Surface):
            out[name] = ops.ts_decay(sae, t_now, dynamic[name])
        elif isinstance(p, Mask):
            _, out[name] = ops.ts_decay_with_mask(sae, t_now, dynamic[name],
                                                  v_tws[name])
        elif isinstance(p, Stcf):
            radius = p.radius if p.radius is not None else cfg.stcf_radius
            out[name] = ops.stcf_support_fused(
                sae, dynamic[name], v_tws[name], t_now, radius=radius,
                include_self=p.include_self,
            )
        elif isinstance(p, Count):
            if counts is None:
                raise ValueError(
                    f"spec product {name!r} needs the counter plane; "
                    "declare a count-bearing spec in TSEngineConfig.specs"
                )
            out[name] = ops.event_count_read(counts, n_bits=p.n_bits)
        elif isinstance(p, Ebbi):
            out[name] = ops.ebbi_read(sae)
        elif isinstance(p, SaeRaw):
            out[name] = sae.clone()
        else:  # pragma: no cover - closed by the constructor's type check
            raise TypeError(p)
    return out
