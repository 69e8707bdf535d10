"""Declarative readout specs: *what to read*, not *which method to call*.

The port of ``repro.serve.spec``.  A ``ReadoutSpec`` is an immutable,
hashable composition of named products, all read off the same slot-pool
state.  It is a **two-stage product graph**.  Stage-0 *surface products*
read the pool::

    surface(...)       decayed time surface (the classic TS readout)
    mask(...)          comparator mask V > V_tw (denoiser front end)
    stcf(...)          dense STCF patch-support map
    count(n_bits)      saturating per-pixel event counter  [refs 32, 33]
    ebbi()             event-based binary image            [refs 34, 35]
    sae_raw()          raw last-timestamp surface (-inf = never) [21, 36]
    ts_quantized(...)  TS from n_T-bit wrapping timestamps  [ref 26]

Stage-1 *head products* consume stage-0 products **by name**::

    classify(inputs, weights, ...)   CNN class logits over a stack of
                                     surface products (Sec. IV-D)
    denoise(input, threshold)        STCF-thresholded event-label map

The constructor validates the wiring (``classify`` eats ``surface()``
products, ``denoise`` a ``stcf()``), so a malformed graph never reaches a
read.  ``compile_spec`` plans a spec into its stage-0 sub-spec, its heads
and its resolved decay params and thresholds; ``read_compiled`` reads
stage 0, then applies the heads to exactly the tensors stage 0 served
(eager PyTorch fuses nothing, so no barrier is needed for the staged
contract: a head's output is bitwise the standalone head on the served
stage-0 products).

A surface-like product that carries an analog ``FidelityModel`` reads
through the eDRAM cell physics (``_analog_read``, ``ops.ts_analog_read``):
the per-cell rate spread is drawn once per read for each (seed, sigma)
from the (noise step, slot generation) key contract and shared by every
product that asks for it; an analog ``Stcf`` thresholds the analog
voltage and counts with the mask form of ``stcf_support``.

Bit-identity contract: each stage-0 product calls the same
``kernels.ops`` entry its standalone read uses, so the ``surface()``
product of any spec is bitwise a standalone ``ops.ts_decay`` of the same
state.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import edram
from repro_torch.core import representations as representations_mod
from repro_torch.core import stcf as stcf_mod
from repro_torch.device import f32
from repro_torch.kernels import ops
from repro_torch.models import cnn
from repro_torch.models.frontends import ts_stack_frontend
from repro_torch.serve import fidelity as fidelity_mod
from repro_torch.serve.fidelity import FidelityModel

__all__ = [
    "ReadoutSpec", "Surface", "Mask", "Stcf", "Count", "Ebbi", "SaeRaw",
    "TsQuantized", "Classify", "Denoise", "surface", "mask", "stcf",
    "count", "ebbi", "sae_raw", "ts_quantized", "classify", "denoise",
    "SURFACE_SPEC", "needs_counts", "CompiledSpec", "compile_spec",
    "resolve_static", "resolve_dynamic", "read_stage0", "apply_heads",
    "read_compiled", "read_products",
]


@dataclasses.dataclass(frozen=True)
class Surface:
    """Decayed time surface.  ``mode``/``tau``/``cmem_f`` default to the
    engine config's decay (None = inherit); overriding them serves a
    second decay profile off the same SAE.  ``fidelity`` names an analog
    read model (``serve.fidelity``)."""

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

    @classmethod
    def from_config(cls, cfg: stcf_mod.STCFConfig) -> "Stcf":
        return cls(radius=cfg.radius, tau_tw=cfg.tau_tw,
                   include_self=cfg.include_self)


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


@dataclasses.dataclass(frozen=True)
class TsQuantized:
    """TS rebuilt from n_T-bit, ``tick``-second timestamps that WRAP on
    overflow -- the SRAM TPI failure mode of ref [26].  ``tau`` defaults
    to the engine's ideal-TS constant."""

    n_bits: int = 16
    tick: float = 1e-3
    tau: Optional[float] = None


_STAGE0_TYPES = (Surface, Mask, Stcf, Count, Ebbi, SaeRaw, TsQuantized)


@dataclasses.dataclass(frozen=True)
class Classify:
    """CNN class logits over a stack of surface products (stage-1 head).

    ``inputs`` names ``Surface`` products of the same spec, stacked on the
    channel axis (``models.frontends.ts_stack_frontend``) and fed to
    ``models.cnn.cnn_apply``.  ``weights`` is a key that ``serve.heads``
    resolves to a param tree (registry / checkpoint directory /
    ``"default"``).
    """

    inputs: Tuple[str, ...] = ("surface",)
    weights: str = "default"
    n_classes: int = 10
    width: int = 32

    def __post_init__(self):
        if isinstance(self.inputs, str):
            raise TypeError(
                f"Classify inputs must be a tuple of product names, got "
                f"the bare string {self.inputs!r} (write "
                f"inputs=({self.inputs!r},))"
            )
        object.__setattr__(self, "inputs", tuple(self.inputs))
        if not self.inputs:
            raise ValueError("Classify needs at least one input product")


@dataclasses.dataclass(frozen=True)
class Denoise:
    """STCF-thresholded event-label map (stage-1 head): True where the
    named ``Stcf`` product's support reaches ``threshold`` (``None`` = the
    engine's ``stcf_threshold``)."""

    input: str = "stcf"
    threshold: Optional[int] = None


_HEAD_TYPES = (Classify, Denoise)
_PRODUCT_TYPES = _STAGE0_TYPES + _HEAD_TYPES

#: which stage-0 family each head's inputs must come from
_HEAD_INPUT_TYPES = {Classify: Surface, Denoise: Stcf}

surface = Surface
mask = Mask
stcf = Stcf
count = Count
ebbi = Ebbi
sae_raw = SaeRaw
ts_quantized = TsQuantized
classify = Classify
denoise = Denoise


def _validate_ranges(name: str, p) -> None:
    """Range-check the knobs of one product at spec construction: counter
    reads and quantized stamps are exact integers in float32 up to 2^24."""
    if isinstance(p, (Count, TsQuantized)):
        if not isinstance(p.n_bits, int) or not 1 <= p.n_bits <= 24:
            raise ValueError(
                f"product {name!r}: {type(p).__name__}.n_bits must be an "
                f"int in [1, 24], got {p.n_bits!r}"
            )
    if isinstance(p, TsQuantized) and not (np.isfinite(p.tick)
                                           and p.tick > 0.0):
        raise ValueError(
            f"product {name!r}: TsQuantized.tick must be a finite "
            f"positive duration in seconds, got {p.tick!r}"
        )


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
            if not isinstance(p, _PRODUCT_TYPES):
                raise TypeError(
                    f"product {name!r} must be one of "
                    f"{[t.__name__ for t in _PRODUCT_TYPES]}, got {p!r}"
                )
            _validate_ranges(name, p)
        for name, p in products.items():
            if not isinstance(p, _HEAD_TYPES):
                continue
            want = _HEAD_INPUT_TYPES[type(p)]
            for inp in p.inputs if isinstance(p, Classify) else (p.input,):
                got = products.get(inp)
                if got is None:
                    raise ValueError(
                        f"head {name!r} consumes product {inp!r}, which "
                        f"this spec does not define"
                    )
                if not isinstance(got, want):
                    raise ValueError(
                        f"head {name!r} needs a {want.__name__} product "
                        f"for input {inp!r}, got {type(got).__name__} "
                        "(heads cannot consume other heads)"
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

    def head_products(self) -> Tuple[Tuple[str, object], ...]:
        """The (name, head) pairs of this spec's stage-1 products."""
        return tuple((n, p) for n, p in self.products
                     if isinstance(p, _HEAD_TYPES))

    @property
    def has_heads(self) -> bool:
        return any(isinstance(p, _HEAD_TYPES) for _, p in self.products)

    def stage0(self) -> "ReadoutSpec":
        """This spec minus its heads (itself when it has none).  Specs with
        equal stage-0 sub-specs share one stage-0 read in ``read_many``."""
        s0 = {n: p for n, p in self.products
              if not isinstance(p, _HEAD_TYPES)}
        return self if len(s0) == len(self.products) else ReadoutSpec(**s0)


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
        elif isinstance(p, TsQuantized):
            dyn[name] = representations_mod.edram_ideal_params(
                p.tau if p.tau is not None else cfg.tau)
    return dyn


class CompiledSpec(NamedTuple):
    """A spec planned under one engine config: its stage-0 sub-spec, its
    heads in canonical (sorted-name) order, and its products' decay params
    (``dynamic``) and comparator thresholds (``statics``)."""

    spec: ReadoutSpec
    stage0: ReadoutSpec
    heads: Tuple[Tuple[str, object], ...]
    dynamic: Dict[str, edram.DecayParams]
    statics: Dict[str, float]

    @property
    def has_heads(self) -> bool:
        return bool(self.heads)


def compile_spec(spec: ReadoutSpec, cfg) -> CompiledSpec:
    """Plan ``spec`` under ``cfg``: split stage 0 from the heads and
    resolve the decay params and thresholds."""
    return CompiledSpec(spec, spec.stage0(), spec.head_products(),
                        resolve_dynamic(spec, cfg),
                        dict(resolve_static(spec, cfg)))


def _analog_read(sae, counts, t_now, params, fid, name, noise_step,
                 generation, draws) -> torch.Tensor:
    """One analog surface read: the per-cell spread (drawn once per read
    for each (seed, sigma), kept in ``draws``), the half-select hit
    counts off the counter plane for ``analog_2d``, then
    ``ops.ts_analog_read``.  sigma = 0 draws nothing, so that read IS the
    digital ``ts_decay`` (the bitwise anchor)."""
    eps = None
    if fidelity_mod.needs_noise(fid):
        if noise_step is None or generation is None:
            raise ValueError(
                f"spec product {name!r} draws per-cell noise; the read "
                "must thread noise_step and the slot generations "
                "(engine.read(..., noise_step=...))")
        key = (fid.seed, fidelity_mod.resolved_sigma(fid))
        eps = draws.get(key)
        if eps is None:
            eps = draws[key] = fidelity_mod.cell_eps(
                fid, noise_step, generation, sae.shape[1:])
    row_hits = col_hits = None
    if fid.mode == "analog_2d":
        if counts is None:
            raise ValueError(
                f"spec product {name!r} has analog_2d fidelity and needs "
                "the counter plane for its half-select hit counts; "
                "declare the spec in TSEngineConfig.specs")
        row_hits, col_hits = fidelity_mod.crossbar_hits(counts)
    return ops.ts_analog_read(sae, t_now, params, eps=eps, row_hits=row_hits,
                              col_hits=col_hits, alpha=fid.alpha,
                              coupling=fid.coupling)


def read_stage0(
    sae: torch.Tensor,                       # (S, P, H, W) slot-pool SAE
    counts: Optional[torch.Tensor],          # (S, H, W) int32 or None
    t_now,
    compiled: CompiledSpec,
    cfg,                                     # TSEngineConfig
    noise_step: Optional[int] = None,        # the stream's step index
    generation: Optional[torch.Tensor] = None,  # (S,) int32 slot epochs
) -> Dict[str, torch.Tensor]:
    """Every stage-0 product of a compiled spec, read off the pool state,
    in canonical name order.  ``noise_step`` and ``generation`` key the
    analog products' noise draws; a spec that draws none ignores them.
    Every product is a new tensor, never a view of the pool state (the
    stream digests products after later pushes wrote the pool)."""
    dynamic, v_tws = compiled.dynamic, compiled.statics
    draws: Dict[tuple, torch.Tensor] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, p in compiled.stage0.products:
        fid = fidelity_mod.product_fidelity(p)
        analog = fid is not None and fid.is_analog
        if analog and isinstance(p, (Surface, Mask, Stcf)):
            v = _analog_read(sae, counts, t_now, dynamic[name], fid, name,
                             noise_step, generation, draws)
        if isinstance(p, Surface):
            out[name] = v if analog else ops.ts_decay(sae, t_now,
                                                      dynamic[name])
        elif isinstance(p, Mask):
            if analog:
                out[name] = v > f32(v_tws[name], v.device)
            else:
                _, out[name] = ops.ts_decay_with_mask(
                    sae, t_now, dynamic[name], v_tws[name])
        elif isinstance(p, Stcf):
            radius = p.radius if p.radius is not None else cfg.stcf_radius
            if analog:
                out[name] = ops.stcf_support(
                    v > f32(v_tws[name], v.device), radius=radius,
                    include_self=p.include_self)
            else:
                out[name] = ops.stcf_support_fused(
                    sae, dynamic[name], v_tws[name], t_now, radius=radius,
                    include_self=p.include_self)
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
        elif isinstance(p, TsQuantized):
            stored = ops.ts_quantize_sae(sae, n_bits=p.n_bits, tick=p.tick)
            out[name] = ops.ts_wrapped_read(stored, t_now, dynamic[name],
                                            n_bits=p.n_bits, tick=p.tick)
        else:  # pragma: no cover - closed by the constructor's type check
            raise TypeError(p)
    return out


def apply_heads(
    stage0_out: Dict[str, torch.Tensor],     # the served stage-0 products
    head_params: Optional[Dict[str, dict]],  # {classify head name: params}
    compiled: CompiledSpec,
    cfg,                                     # TSEngineConfig
) -> Dict[str, torch.Tensor]:
    """Every head of a compiled spec off the served stage-0 products.
    Logits and label maps lead with the slot axis."""
    out: Dict[str, torch.Tensor] = {}
    for name, h in compiled.heads:
        if isinstance(h, Classify):
            stack = ts_stack_frontend([stage0_out[n] for n in h.inputs])
            out[name] = cnn.cnn_apply(head_params[name], stack)
        elif isinstance(h, Denoise):
            thr = (h.threshold if h.threshold is not None
                   else cfg.stcf_threshold)
            out[name] = stage0_out[h.input] >= thr
        else:  # pragma: no cover - closed by the constructor's type check
            raise TypeError(h)
    return out


def read_compiled(sae, counts, t_now, compiled: CompiledSpec, cfg,
                  head_params: Optional[Dict[str, dict]] = None,
                  noise_step: Optional[int] = None,
                  generation: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
    """One staged spec read: the stage-0 products, then the heads over
    them, in the spec's canonical name order."""
    out = read_stage0(sae, counts, t_now, compiled, cfg, noise_step,
                      generation)
    if compiled.heads:
        out.update(apply_heads(out, head_params, compiled, cfg))
    return {name: out[name] for name in compiled.spec.names}


_read_products_warned = False


def read_products(sae, counts, t_now, dynamic: Dict[str, edram.DecayParams],
                  spec: ReadoutSpec, cfg, *,
                  statics: Tuple[Tuple[str, float], ...] = (),
                  head_params: Optional[Dict[str, dict]] = None
                  ) -> Dict[str, torch.Tensor]:
    """Deprecated flat-spec entry (one release of grace): use
    ``compile_spec`` + ``read_compiled``.

    Value-identical to the staged path -- it *is* the staged path, called
    through a plan built on the spot from the given ``dynamic`` and
    ``statics`` (which must match ``resolve_dynamic`` / ``resolve_static``
    when the spec needs them).  Warns once per process.  The reference's
    ``backend`` argument is gone: the tensor's device picks the kernel or
    its plain version, as in ``read_compiled``; ``statics`` and
    ``head_params`` are keyword-only, so an old call passing a backend
    string positionally raises ``TypeError``.
    """
    global _read_products_warned
    if not _read_products_warned:
        _read_products_warned = True
        warnings.warn(
            "serve.spec.read_products() is deprecated; plan the spec "
            "with compile_spec(spec, cfg) and call read_compiled()",
            DeprecationWarning, stacklevel=2,
        )
    compiled = CompiledSpec(spec, spec.stage0(), spec.head_products(),
                            dynamic, dict(statics))
    return read_compiled(sae, counts, t_now, compiled, cfg, head_params)
