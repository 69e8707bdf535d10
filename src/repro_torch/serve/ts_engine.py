"""Batched streaming time-surface serving engine (single device).

The port of ``repro.serve.ts_engine``'s single-device engine.  A fixed
pool of per-sensor *slots*, each an SAE (last-write time per cell and
polarity) plus its bookkeeping, batched along a leading slot axis:

  * **ingest** -- AER payloads (packed 64-bit words, host ``EventStream``s
    or pre-padded ``EventBatch``es) are cut into fixed-capacity chunks on
    the host, stacked with numpy, copied to the device once per field per
    push, and written by one launch of the ``chunk_scatter`` kernel, which
    also marks dirty tiles, bumps the counter plane and updates each
    slot's ``t_last``/``n_events``.  O(#events) writes.
  * **read** -- a ``serve.spec.ReadoutSpec`` is served over the whole pool
    by the ``ts_decay`` and ``stcf_support`` kernels, slot and polarity
    axes being batch dimensions of one launch; its stage-1 heads (CNN
    logits, denoise labels) then run on the served stage-0 tensors, with
    the ``Classify`` weights resolved once per spec onto the engine's
    device (``serve.heads``).
  * **labeled ingest** -- ``push_labeled`` labels each event with its STCF
    support against the slot's surface as each chunk lands, chunk by
    chunk, then scatters the chunk: the offline ``stcf_chunked`` at
    ``chunk = chunk_capacity``.
  * **staged ingest** -- ``push_staged`` takes raw ``(slot, (x, y, t,
    p))`` host parts (the stream runtime's hot path), fills one of the
    ``IngestRing``'s two pinned staging sets, copies each field to the
    card once (``non_blocking``, on a copy stream) and scatters in place:
    bitwise the ``push`` of the same parts.
  * **serve_step** -- push, then read with the spec's first surface
    product backed by a *dirty-tile cache*: repeat reads under one cache
    epoch (same ``t_now``, same surface product, tracked on the host in
    ``_cache_t``/``_cache_surface``) re-read only the tiles written since
    the last fill (``ops.ts_fused_dirty``); a new epoch, a cold cache or
    more than ``max_dirty_tiles`` dirty tiles refill densely.  Incremental
    and dense reads are bitwise equal: both run the same elementwise
    ``ts_decay``.

State lives in tensors on the engine's ``device`` and is updated in
place.  ``TimeSurfaceEngine(cfg)`` runs on the CUDA device and raises
when there is none; ``device="cpu"`` runs the plain PyTorch versions
(the tests do).  Both decay modes run through the same kernel: the ideal
TS is the double-exp transient with ``a1=1, a2=0, b=0, tau1=tau``.

Analog-fidelity products (``serve.fidelity``) read through the cell
physics; ``read``, ``read_many`` and ``serve_step`` take the stream's
``noise_step`` and pass the slots' generations, which key the noise.

**Elastic slot pools + live migration** -- the pool is not fixed:
``grow()`` adds acquirable capacity in ``slot_bucket`` increments (new
rows are never-written state: every pool leaf is reallocated with the
fresh rows appended), ``shrink()`` compacts live slots out of the tail
(live tail slots in increasing order move into the lowest free head
slots) and then cuts the tail off every leaf with a real copy, and
``migrate(src, dst)`` moves one live session's whole per-slot state --
SAE plane, ``t_last``/``n_events``, dirty-tile cache row and marks,
counter plane and the ``generation`` *value*, which keys the analog
noise -- onto a free slot (the lowest one by default), re-binding its
``SensorSession`` in place.  Every move keeps the dirty-tile cache epoch
coherent: a moved cache row holds the source's last read, and fresh or
wiped rows are zeros, the read of a never-written surface at any
``t_now``.  A resize replaces the state's tensors, so products read
before it never alias the new pool; a migration writes the pool in
place, and products are never views of it.

Not ported (ROADMAP queue 1 item 2): the device mesh.  The deprecated
method-per-feature shims are not ported either (queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import edram
from repro_torch.core import representations
from repro_torch.core import stcf as stcf_mod
from repro_torch.core import time_surface as ts
from repro_torch.device import resolve_device
from repro_torch.events import aer
from repro_torch.events import synthetic as syn
from repro_torch.hw import constants as C
from repro_torch.kernels import ops
from repro_torch.serve import fidelity as fidelity_mod
from repro_torch.serve import heads as heads_mod
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.api import SensorSession


@dataclasses.dataclass(frozen=True)
class TSEngineConfig:
    """Static engine configuration."""

    h: int = C.QVGA_H
    w: int = C.QVGA_W
    polarities: int = 1
    n_slots: int = 8                     # sensor pool size
    chunk_capacity: int = 2048           # events per ingest chunk (padded)
    mode: str = "edram"                  # "edram" | "ideal"
    tau: float = C.MEMORY_WINDOW_S       # ideal-TS decay constant
    tau_tw: float = C.MEMORY_WINDOW_S    # STCF correlation window
    cmem_f: float = C.ISC_CMEM_F
    stcf_radius: int = 3
    stcf_threshold: int = 2
    block: Tuple[int, int] = (8, 128)    # dirty-tile size
    slot_bucket: Optional[int] = None    # slots per ``grow()`` call
    # (``None`` = the initial ``n_slots``)
    max_dirty_tiles: int = 0             # incremental-read gather cap;
    # 0 = auto (a quarter of the pool's tiles, at least 16).  Overflow
    # falls back to one dense pass: correctness never depends on it.
    specs: Tuple[spec_mod.ReadoutSpec, ...] = ()
    # the specs this engine intends to serve; a declared spec needing the
    # counter plane (``count(...)``) makes ``init_state`` allocate it

    def __post_init__(self):
        if self.mode not in ("edram", "ideal"):
            raise ValueError(f"mode must be 'edram' or 'ideal', "
                             f"got {self.mode!r}")
        if self.slot_bucket is not None and self.slot_bucket < 1:
            raise ValueError(f"slot_bucket must be >= 1 or None, "
                             f"got {self.slot_bucket}")
        for s in self.specs:
            if not isinstance(s, spec_mod.ReadoutSpec):
                raise TypeError(f"specs must be ReadoutSpecs, got {s!r}")

    @property
    def needs_counts(self) -> bool:
        """Whether any declared spec requires the counter plane."""
        return any(spec_mod.needs_counts(s) for s in self.specs)

    def tile_counts(self) -> Tuple[int, int, int]:
        """(tiles_h, tiles_w, tiles_per_slot) for the dirty-tile cache."""
        th, tw, tpl = ops.tile_geometry(self.h, self.w, self.block)
        return th, tw, self.polarities * tpl

    def decay_params(self) -> edram.DecayParams:
        """Uniform decay params; ideal TS as a degenerate double-exp."""
        if self.mode == "ideal":
            return representations.edram_ideal_params(self.tau)
        return edram.decay_params_for_cmem(self.cmem_f)

    def v_tw(self) -> float:
        """Comparator threshold equivalent to the ``tau_tw`` window."""
        if self.mode == "ideal":
            return float(np.exp(-self.tau_tw / self.tau))
        return edram.v_tw_for_window(self.tau_tw, self.decay_params())

    def stcf_config(self) -> stcf_mod.STCFConfig:
        return stcf_mod.STCFConfig(
            radius=self.stcf_radius, tau_tw=self.tau_tw,
            threshold=self.stcf_threshold,
            polarity_sensitive=self.polarities > 1,
        )


class ReadoutCache(NamedTuple):
    """Dirty-tile readout cache, one row per slot.

    ``tiles`` holds the last surface read in tiled layout -- tile
    ``(p, ty, tx)`` of slot ``s`` at flat index ``(p*TH + ty)*TW + tx`` --
    edge tiles zero-padded as the dense tiling pads.  A zeroed row is the
    read of a never-written slot at any ``t_now``, so slot resets keep
    the pool-wide cache epoch valid.
    """

    tiles: torch.Tensor   # (S, TP, bh, bw) float32
    dirty: torch.Tensor   # (S, TP) bool: tiles written since the fill


class EngineState(NamedTuple):
    """The whole slot pool (leading axis = slot).  ``counts`` is the
    optional polarity-merged event-counter plane, allocated only when a
    declared spec needs it."""

    surfaces: ts.SurfaceState   # sae (S, P, H, W), t_last (S,), n_events (S,)
    generation: torch.Tensor    # (S,) int32, bumped on every attach
    cache: ReadoutCache
    counts: Optional[torch.Tensor] = None  # (S, H, W) int32


def init_state(cfg: TSEngineConfig, device=None,
               n_slots: Optional[int] = None) -> EngineState:
    """Fresh pool state on ``device``; ``n_slots`` overrides the config's
    pool size (an elastic pool's new rows)."""
    s = cfg.n_slots if n_slots is None else n_slots
    p, h, w = cfg.polarities, cfg.h, cfg.w
    bh, bw = cfg.block
    _, _, tp = cfg.tile_counts()
    z = dict(device=device)
    return EngineState(
        surfaces=ts.SurfaceState(
            sae=torch.full((s, p, h, w), ts.NEVER, dtype=torch.float32, **z),
            t_last=torch.zeros(s, dtype=torch.float32, **z),
            n_events=torch.zeros(s, dtype=torch.int32, **z),
        ),
        generation=torch.zeros(s, dtype=torch.int32, **z),
        cache=ReadoutCache(
            tiles=torch.zeros((s, tp, bh, bw), dtype=torch.float32, **z),
            dirty=torch.zeros((s, tp), dtype=torch.bool, **z),
        ),
        counts=(torch.zeros((s, h, w), dtype=torch.int32, **z)
                if cfg.needs_counts else None),
    )


def reset_slot(state: EngineState, slot: int,
               bump_generation: bool = True) -> EngineState:
    """Wipe one slot back to 'never written', in place; an attach also
    bumps its generation.  The slot's cache row resets to zeros with no
    dirty tiles, which keeps the pool-wide cache epoch valid."""
    sur = state.surfaces
    sur.sae[slot] = ts.NEVER
    sur.t_last[slot] = 0.0
    sur.n_events[slot] = 0
    if bump_generation:
        state.generation[slot] += 1
    state.cache.tiles[slot] = 0.0
    state.cache.dirty[slot] = False
    if state.counts is not None:
        state.counts[slot] = 0
    return state


def migrate_slot(state: EngineState, src: int, dst: int) -> EngineState:
    """Move slot ``src``'s rows onto slot ``dst`` and wipe ``src``, in
    place.  Every per-slot leaf moves: the SAE plane, ``t_last`` /
    ``n_events``, the cache tiles and dirty marks (the destination's
    cached tiles are the source's last valid read, so the pool-wide cache
    epoch stays coherent), the counter plane and the ``generation``
    value -- the analog noise key is folded from the value, never the
    slot index, so an analog slot's noise moves bitwise with it.  ``src``
    is wiped as ``reset_slot`` wipes it, without a generation bump (its
    next attach bumps from the carried value).  ``src != dst`` is the
    caller's contract (``TimeSurfaceEngine.migrate`` enforces it)."""
    sur, cache = state.surfaces, state.cache
    rows = [sur.sae, sur.t_last, sur.n_events, cache.tiles, cache.dirty]
    if state.counts is not None:
        rows.append(state.counts)
    for leaf in rows:
        leaf[dst] = leaf[src]
    state.generation[dst] = state.generation[src]
    return reset_slot(state, src, bump_generation=False)


def _scatter_chunks(state: EngineState, slot_ids: torch.Tensor,
                    ev: ts.EventBatch) -> EngineState:
    """Write B chunks (``ev`` fields (B, N)) into slots ``slot_ids``, in
    place: the SAE max-combine, the dirty-tile marks, the counter plane
    and ``t_last``/``n_events``, all in one ``chunk_scatter`` pass."""
    sur = state.surfaces
    ops.chunk_scatter_(
        sur.sae, slot_ids, ev, dirty=state.cache.dirty,
        block=tuple(state.cache.tiles.shape[-2:]), counts=state.counts,
        t_last=sur.t_last, n_events=sur.n_events,
    )
    return state


def ingest_support(state: EngineState, slot_ids: torch.Tensor,
                   ev: ts.EventBatch, cfg_stcf: stcf_mod.STCFConfig,
                   mode: str, params: edram.DecayParams, v_tw,
                   intra_chunk: bool = True) -> torch.Tensor:
    """STCF support ((B, N) int32) of each chunk's events (``ev`` fields
    (B, N)) against its slot's pre-ingest SAE: the offline
    ``stcf_chunk_support`` per row.  A pure read."""
    sae_b = state.surfaces.sae[slot_ids.long()]          # (B, P, H, W)
    return torch.stack([
        stcf_mod.stcf_chunk_support(
            sae_b[i], ts.EventBatch(*(f[i] for f in ev)), cfg_stcf,
            mode=mode, params=params, v_tw=v_tw, intra_chunk=intra_chunk)
        for i in range(sae_b.shape[0])])


#: the device mesh waits for the multi-device slice
MESH_NOT_PORTED = (
    "is not ported to repro_torch yet (ROADMAP queue 1 item 2: the slot "
    "pool over several devices); use the JAX package"
)

#: one raw ingest part: (x, y, t, p) host arrays, equal length <= capacity
RawPart = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class IngestRing:
    """Double-buffered host staging for ``TimeSurfaceEngine.push_staged``.

    ``depth`` staging sets per padded batch size ``b`` (a power of two, so
    few sizes occur), each whole (b, cap) fields -- pinned host memory
    when the engine is on the card -- are filled row by row with numpy
    and copied to the device with one ``non_blocking`` copy per field.
    On the card the copies run on a side stream, so a deadline's upload
    overlaps whatever the compute stream still runs; the scatter's
    stream waits on the copies, and the device buffers are recorded on
    it for the caching allocator.  A staging set is refilled only after
    its previous copy finished (its event is waited on in ``acquire``):
    without that, the DMA and the host would race on the pinned buffer.

    Only ``valid`` (and the slot ids) are zeroed on reuse: the scatter
    writes nothing for an invalid event, so stale coordinates behind
    ``valid = False`` never reach a surface, and ring-staged ingest is
    bitwise the host-staged ``push``.
    """

    _SPEC = (("sids", torch.int32, False), ("x", torch.int32, True),
             ("y", torch.int32, True), ("t", torch.float32, True),
             ("p", torch.int32, True), ("valid", torch.bool, True))

    def __init__(self, capacity: int, device, depth: int = 2):
        if depth < 2:
            raise ValueError(f"an ingest ring needs depth >= 2, got {depth}")
        self.capacity = capacity
        self.device = torch.device(device)
        self.depth = depth
        self._sets: Dict[int, List[dict]] = {}   # padded b -> staging sets
        self._turn: Dict[int, int] = {}
        self._copy_stream = None

    def _alloc(self, b: int) -> dict:
        pin = self.device.type == "cuda"
        buf = {"event": None}
        for name, dtype, wide in self._SPEC:
            shape = (b, self.capacity) if wide else (b,)
            t = torch.zeros(shape, dtype=dtype, pin_memory=pin)
            buf[name] = t
            buf[name + "_np"] = t.numpy()
        return buf

    def acquire(self, b: int) -> dict:
        """The next staging set for padded batch size ``b``, its previous
        upload finished and its ``valid`` and slot ids zeroed."""
        sets = self._sets.get(b)
        if sets is None:
            sets = self._sets[b] = [self._alloc(b) for _ in range(self.depth)]
            self._turn[b] = 0
        i = self._turn[b]
        self._turn[b] = (i + 1) % self.depth
        buf = sets[i]
        if buf["event"] is not None:
            buf["event"].synchronize()
        buf["valid_np"][:] = False
        buf["sids_np"][:] = 0
        return buf

    @staticmethod
    def fill_row(buf: dict, row: int, slot: int, part: RawPart) -> None:
        """Stage one (slot, part) into row ``row`` of a staging set."""
        x, y, t, p = part
        n = len(x)
        buf["sids_np"][row] = slot
        if n:
            buf["x_np"][row, :n] = x
            buf["y_np"][row, :n] = y
            buf["t_np"][row, :n] = t
            buf["p_np"][row, :n] = p
            buf["valid_np"][row, :n] = True

    def upload(self, buf: dict):
        """One copy per field to the ring's device: ``(slot ids,
        EventBatch)``, ready for the current stream."""
        names = [name for name, _, _ in self._SPEC]
        if self.device.type != "cuda":   # the CPU scatter reads them now
            return buf["sids"], ts.EventBatch(*(buf[n] for n in names[1:]))
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = [buf[n].to(self.device, non_blocking=True) for n in names]
        done = torch.cuda.Event()
        done.record(self._copy_stream)
        buf["event"] = done
        compute.wait_event(done)
        for t in out:
            t.record_stream(compute)
        return out[0], ts.EventBatch(*out[1:])


def _pad_batch(n: int) -> int:
    """The smallest power of two >= n (the ring keeps one set per size)."""
    b = 1
    while b < n:
        b *= 2
    return b


#: an ingest item: (slot id | session, packed AER words | EventStream |
#: EventBatch)
IngestItem = Tuple[Union[int, SensorSession],
                   Union[np.ndarray, syn.EventStream, ts.EventBatch]]

_FIELDS = (("x", np.int32), ("y", np.int32), ("t", np.float32),
           ("p", np.int32), ("valid", np.bool_))


class TimeSurfaceEngine:
    """Host-facing multi-sensor serving engine over the slot pool::

        from repro_torch.serve import spec as rs

        eng = TimeSurfaceEngine(TSEngineConfig(h=240, w=320, n_slots=8))
        cam = eng.attach()                     # SensorSession on a slot
        cam.push(packed_aer_words)
        spec = rs.ReadoutSpec(surface=rs.surface(), stcf=rs.stcf())
        out = cam.read(spec, t_now)            # {"surface": ..., "stcf": ...}
        cam.detach()

    Pool-level calls (``read`` / ``serve_step``) return pool-shaped
    products for all slots.
    """

    def __init__(self, cfg: TSEngineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = init_state(cfg, self.device)
        self.capacity = cfg.n_slots
        self._free: List[int] = list(range(cfg.n_slots))
        self._sessions: Dict[int, SensorSession] = {}
        # dirty-tile cache epoch: the (surface product, t_now) the clean
        # cache tiles were read under (None = cold)
        self._cache_t: Optional[float] = None
        self._cache_surface: Optional[Tuple[str, spec_mod.Surface]] = None
        self._compiled_cache: Dict[spec_mod.ReadoutSpec,
                                   spec_mod.CompiledSpec] = {}
        self._head_cache: Dict[spec_mod.ReadoutSpec, Optional[dict]] = {}
        self._rest_cache: Dict[spec_mod.ReadoutSpec,
                               Optional[spec_mod.ReadoutSpec]] = {}
        self._recompute_max_dirty()
        self._ring = IngestRing(cfg.chunk_capacity, self.device)

    # -- sessions ------------------------------------------------------------
    def attach(self, qos=None) -> SensorSession:
        """Claim a free slot (resetting it) and return the session owning
        it; raises ``RuntimeError`` when the pool is full.  ``qos`` tags
        the session with a ``serve.stream.QoSClass`` (the engine itself
        ignores it; scheduling lives in ``StreamRuntime``)."""
        if not self._free:
            raise RuntimeError(
                f"no free sensor slots (pool capacity {self.capacity})")
        slot = self._free.pop(0)
        reset_slot(self.state, slot, bump_generation=True)
        session = SensorSession(self, slot, qos=qos)
        self._sessions[slot] = session
        return session

    def _detach(self, slot: int) -> None:
        """Session teardown: wipe the slot and return it to the pool."""
        self._check_acquired(slot)
        reset_slot(self.state, slot, bump_generation=False)
        self._sessions.pop(slot, None)
        self._free.append(slot)
        self._free.sort()

    def _check_acquired(self, slot: int) -> None:
        if not 0 <= slot < self.capacity:
            raise ValueError(f"slot {slot} out of range [0, {self.capacity})")
        if slot in self._free:
            raise ValueError(f"slot {slot} is not acquired")

    @property
    def n_live(self) -> int:
        return self.capacity - len(self._free)

    # -- ingest --------------------------------------------------------------
    def _host_chunks(self, payload) -> List[np.ndarray]:
        """One payload as (k, chunk_capacity) numpy fields x, y, t, p,
        valid (an empty payload is one all-invalid chunk)."""
        cap = self.cfg.chunk_capacity
        if isinstance(payload, ts.EventBatch):
            if payload.x.shape != (cap,):
                raise ValueError(
                    f"EventBatch of shape {tuple(payload.x.shape)}; the "
                    f"engine takes one ({cap},) chunk per EventBatch")
            return [getattr(payload, f).detach().cpu().numpy().astype(d)
                    .reshape(1, cap) for f, d in _FIELDS]
        if isinstance(payload, np.ndarray):   # packed 64-bit AER words
            payload = aer.unpack(payload.astype(np.uint64), self.cfg.h,
                                 self.cfg.w)
        if not isinstance(payload, syn.EventStream):
            raise TypeError(f"cannot ingest {type(payload).__name__}")
        n = payload.n
        k = max(1, -(-n // cap))
        pad = k * cap - n
        out = [np.pad(getattr(payload, f).astype(d), (0, pad)).reshape(k, cap)
               for f, d in _FIELDS[:4]]
        valid = np.zeros(k * cap, bool)
        valid[:n] = True
        return out + [valid.reshape(k, cap)]

    def _item_chunks(self, items: Sequence[IngestItem]):
        """Items -> [(slot, its five (k, cap) fields)] on the host, every
        slot checked before any is written."""
        out = []
        for slot, payload in items:
            if isinstance(slot, SensorSession):
                slot._check()
                slot = slot.slot
            self._check_acquired(slot)
            out.append((slot, self._host_chunks(payload)))
        return out

    def _collect(self, items: Sequence[IngestItem]):
        """Items -> (slot ids (B,), the five (B, cap) fields) on the host."""
        parts = self._item_chunks(items)
        if not parts:
            return None
        slot_ids = [slot for slot, f in parts for _ in range(f[0].shape[0])]
        fields = [np.concatenate(f) for f in zip(*(f for _, f in parts))]
        return np.asarray(slot_ids, np.int32), fields

    def push(self, items: Sequence[IngestItem]) -> None:
        """Pool-level batched ingest: one scatter launch for every chunk
        of every item.  ``items`` pairs a ``SensorSession`` (or its slot
        id) with a payload; payloads longer than ``chunk_capacity`` are
        split on the host."""
        host = self._collect(items)
        if host is None:
            return
        sids, fields = host
        dev = self.device
        ev = ts.EventBatch(*(torch.from_numpy(f).to(dev) for f in fields))
        _scatter_chunks(self.state, torch.from_numpy(sids).to(dev), ev)

    def push_staged(self, items: Sequence[Tuple[int, RawPart]]) -> None:
        """Ring-staged batched ingest: raw ``(slot | session, (x, y, t,
        p))`` host parts, each at most ``chunk_capacity`` events, staged
        into the ``IngestRing`` and scattered by one ``chunk_scatter``
        launch (rows padded to a power of two with invalid rows).  Bitwise
        the ``push`` of the same parts."""
        cap = self.cfg.chunk_capacity
        rows = []
        for slot, part in items:
            if isinstance(slot, SensorSession):
                slot._check()
                slot = slot.slot
            self._check_acquired(slot)
            if len(part[0]) > cap:
                raise ValueError(
                    f"part of {len(part[0])} events exceeds the chunk "
                    f"capacity {cap}; split parts on the host")
            rows.append((slot, part))
        if not rows:
            return
        buf = self._ring.acquire(_pad_batch(len(rows)))
        for i, (slot, part) in enumerate(rows):
            IngestRing.fill_row(buf, i, slot, part)
        sids, ev = self._ring.upload(buf)
        _scatter_chunks(self.state, sids, ev)

    def _ingest_labeled(self, items: Sequence[IngestItem]) -> list:
        """Scatter payloads *and* label each event with its STCF support
        (the body behind ``SensorSession.push_labeled``).

        Chunks go one at a time -- each chunk's support is read against
        the slot's SAE with every earlier chunk written, then the chunk is
        scattered -- so the labels are those of the offline
        ``stcf_chunked`` at ``chunk = chunk_capacity``.  Returns, per
        item, ``(support (n,) int32, support >= stcf_threshold)`` over its
        valid events, on the engine's device.
        """
        cfg, dev = self.cfg, self.device
        stcf_cfg, params = cfg.stcf_config(), cfg.decay_params()
        v_tw = cfg.v_tw()
        out = []
        for slot, fields in self._item_chunks(items):
            ev = ts.EventBatch(*(torch.from_numpy(f).to(dev) for f in fields))
            sid = torch.tensor([slot], dtype=torch.int32, device=dev)
            sups = []
            for i in range(ev.x.shape[0]):
                chunk = ts.EventBatch(*(f[i:i + 1] for f in ev))
                sups.append(ingest_support(self.state, sid, chunk, stcf_cfg,
                                           cfg.mode, params, v_tw)[0])
                _scatter_chunks(self.state, sid, chunk)
            sup = torch.cat(sups)[ev.valid.reshape(-1)]
            out.append((sup, sup >= cfg.stcf_threshold))
        return out

    # -- spec reads ----------------------------------------------------------
    def _check_spec(self, spec: spec_mod.ReadoutSpec) -> None:
        if not isinstance(spec, spec_mod.ReadoutSpec):
            raise TypeError(
                f"expected a ReadoutSpec, got {type(spec).__name__}; "
                "compose one with serve.spec (e.g. "
                "ReadoutSpec(surface=surface()))"
            )
        if spec_mod.needs_counts(spec) and self.state.counts is None:
            raise ValueError(
                "spec needs the counter plane (a count(...) product) but "
                "this engine has none; declare a counts-needing spec in "
                "TSEngineConfig.specs so init_state allocates it"
            )

    def _compiled(self, spec: spec_mod.ReadoutSpec) -> spec_mod.CompiledSpec:
        plan = self._compiled_cache.get(spec)
        if plan is None:
            plan = self._compiled_cache[spec] = spec_mod.compile_spec(
                spec, self.cfg)
        return plan

    def _resolved(self, spec: spec_mod.ReadoutSpec):
        """``(compiled plan, {classify head name: params} or None)``, both
        resolved once per spec; head weights land on the engine's device
        (``serve.heads``)."""
        compiled = self._compiled(spec)
        if spec not in self._head_cache:
            params = {name: heads_mod.resolve_head_params(h, self.cfg,
                                                          self.device)
                      for name, h in compiled.heads
                      if isinstance(h, spec_mod.Classify)}
            self._head_cache[spec] = params or None
        return compiled, self._head_cache[spec]

    def read(self, spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
             t_now: float = 0.0, noise_step: int = 0
             ) -> Dict[str, torch.Tensor]:
        """Every product of ``spec`` over the whole pool at ``t_now``:
        the stage-0 products, then the heads over exactly those tensors.
        Free slots read as never-written.  The ``surface()`` product is
        the same ``ops.ts_decay`` an offline reader
        (``time_surface.surface_read_kernel``) runs, so engine and
        offline reads of equal SAE state are bitwise equal.
        ``noise_step`` (with each slot's generation) keys the analog
        products' noise; a spec that draws none ignores it."""
        self._check_spec(spec)
        compiled, head_params = self._resolved(spec)
        return spec_mod.read_compiled(
            self.state.surfaces.sae, self.state.counts, t_now, compiled,
            self.cfg, head_params, noise_step=noise_step,
            generation=self.state.generation)

    def read_many(self, specs: Sequence[spec_mod.ReadoutSpec],
                  t_now: float = 0.0, noise_step: int = 0
                  ) -> Dict[spec_mod.ReadoutSpec, Dict[str, torch.Tensor]]:
        """Serve several specs against the same pool state.  Duplicate
        specs are read once, and specs with equal stage-0 sub-specs share
        one stage-0 read, each member's heads running on its tensors --
        bitwise what the member's own ``read`` serves."""
        uniq = list(dict.fromkeys(specs))
        groups: Dict[spec_mod.ReadoutSpec, List[spec_mod.ReadoutSpec]] = {}
        for sp in uniq:
            self._check_spec(sp)
            groups.setdefault(self._compiled(sp).stage0, []).append(sp)
        out: Dict[spec_mod.ReadoutSpec, Dict[str, torch.Tensor]] = {}
        for stage0, members in groups.items():
            if len(members) == 1:
                out[members[0]] = self.read(members[0], t_now, noise_step)
                continue
            base = self.read(stage0, t_now, noise_step)
            for sp in members:
                compiled, head_params = self._resolved(sp)
                heads = spec_mod.apply_heads(base, head_params, compiled,
                                             self.cfg)
                merged = {**base, **heads}
                out[sp] = {n: merged[n] for n in sp.names}
        return {sp: out[sp] for sp in uniq}

    def serve_step(self, items: Sequence[IngestItem],
                   spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
                   t_now: float = 0.0, noise_step: int = 0
                   ) -> Dict[str, torch.Tensor]:
        """Push ``items``, then serve every product of ``spec`` at
        ``t_now`` with its first surface product read through the
        dirty-tile cache (an empty ``items`` is a pure cached read).
        Other products read densely, after the push.  A head-bearing spec
        reads everything densely after the push (the heads need every
        input current), and so does an analog spec (the cache holds
        digital tiles; an analog read goes through the cell physics every
        time): the same staged read a ``read`` runs."""
        self._check_spec(spec)
        surface_products = spec.surface_products()
        if (not surface_products or spec.has_heads
                or fidelity_mod.spec_fidelity_mode(spec) != "ideal"):
            self.push(items)
            return self.read(spec, t_now, noise_step)
        self.push(items)
        name0, prod0 = surface_products[0]
        params0 = self._compiled(spec).dynamic[name0]
        refresh_all = (self._cache_t is None or float(t_now) != self._cache_t
                       or self._cache_surface != (name0, prod0))
        state = self.state
        s, p, h, w = state.surfaces.sae.shape
        tp = state.cache.dirty.shape[1]
        bh, bw = self.cfg.block
        surface, tiles, dirty = ops.ts_fused_dirty(
            state.surfaces.sae, state.cache.tiles.view(s * tp, bh, bw),
            state.cache.dirty.view(s * tp), t_now, params0,
            max_dirty=self._max_dirty, block=self.cfg.block,
            force_dense=refresh_all,
        )
        self.state = state._replace(cache=ReadoutCache(
            tiles=tiles.view(s, tp, bh, bw), dirty=dirty.view(s, tp)))
        self._cache_t = float(t_now)
        self._cache_surface = (name0, prod0)
        out = {name0: surface}
        if spec not in self._rest_cache:
            rest = {n: q for n, q in spec.products if n != name0}
            self._rest_cache[spec] = (spec_mod.ReadoutSpec(**rest)
                                      if rest else None)
        rest_spec = self._rest_cache[spec]
        if rest_spec is not None:
            out.update(self.read(rest_spec, t_now))
        return {name: out[name] for name in spec.names}

    # -- elastic capacity + live migration ------------------------------------
    @property
    def slot_bucket(self) -> int:
        """The growth increment (``cfg.slot_bucket`` or the initial pool
        size)."""
        return self.cfg.slot_bucket or self.cfg.n_slots

    def _recompute_max_dirty(self) -> None:
        _, _, tp = self.cfg.tile_counts()
        self._max_dirty = (self.cfg.max_dirty_tiles
                           or max(16, self.capacity * tp // 4))

    def _resize_state(self, n_slots: int) -> None:
        """Reallocate every pool leaf at ``n_slots`` rows: growth appends
        never-written rows, shrinking copies the head rows (a real copy,
        so the released tail's storage is freed)."""
        old = self.state
        if n_slots > self.capacity:
            tail = init_state(self.cfg, self.device,
                              n_slots=n_slots - self.capacity)
            fit = lambda a, b: torch.cat([a, b])
        else:
            tail = old
            fit = lambda a, _: a[:n_slots].clone()
        self.state = EngineState(
            surfaces=ts.SurfaceState(*map(fit, old.surfaces, tail.surfaces)),
            generation=fit(old.generation, tail.generation),
            cache=ReadoutCache(*map(fit, old.cache, tail.cache)),
            counts=(None if old.counts is None
                    else fit(old.counts, tail.counts)),
        )

    def grow(self, capacity: Optional[int] = None) -> int:
        """Grow the pool to ``capacity`` acquirable slots (default: one
        ``slot_bucket`` more).  The new rows are never-written state;
        live slots keep their bits.  Returns the new capacity."""
        if capacity is None:
            capacity = self.capacity + self.slot_bucket
        if capacity <= self.capacity:
            raise ValueError(f"grow target {capacity} <= current capacity "
                             f"{self.capacity} (use shrink())")
        self._resize_state(capacity)
        self._free.extend(range(self.capacity, capacity))
        self._free.sort()
        self.capacity = capacity
        self._recompute_max_dirty()
        return self.capacity

    def shrink(self, capacity: int) -> List[Tuple[int, int]]:
        """Shrink the pool to ``capacity`` acquirable slots: live slots in
        the released tail first move, in increasing order, into the lowest
        free head slots in increasing order; then the tail is cut off
        every leaf.  Returns the ``(src, dst)`` moves, so callers re-key
        their own slot-indexed state and the replay oracle can check it
        derives the same ones.  Raises when more than ``capacity`` slots
        are live."""
        if not 1 <= capacity < self.capacity:
            raise ValueError(
                f"shrink target {capacity} not in [1, {self.capacity})")
        if self.n_live > capacity:
            raise RuntimeError(
                f"cannot shrink to {capacity}: {self.n_live} slots live")
        live_tail = [s for s in range(capacity, self.capacity)
                     if s not in self._free]
        free_head = sorted(d for d in self._free if d < capacity)
        moves = list(zip(live_tail, free_head))
        for src, dst in moves:
            self._migrate_slot(src, dst)
        self._resize_state(capacity)
        self._free = [d for d in self._free if d < capacity]
        self.capacity = capacity
        self._recompute_max_dirty()
        return moves

    def _migrate_slot(self, src: int, dst: int) -> None:
        """The state move and the host re-key for one live slot (shared by
        ``migrate`` and ``shrink``; the caller validates)."""
        migrate_slot(self.state, src, dst)
        self._free.remove(dst)
        session = self._sessions.pop(src, None)
        if session is not None:
            session._slot = dst
            self._sessions[dst] = session
        self._free.append(src)
        self._free.sort()

    def migrate(self, src: int, dst: Optional[int] = None) -> int:
        """Live-migrate the session on slot ``src`` to free slot ``dst``
        (default: the lowest free slot).  Its whole per-slot state moves
        (``migrate_slot``), its ``SensorSession`` re-binds in place, and
        ``src`` is wiped and freed.  Returns the destination slot."""
        self._check_acquired(src)
        if dst is None:
            if not self._free:
                raise RuntimeError("no free slot to migrate into")
            dst = self._free[0]
        if dst == src:
            raise ValueError(f"migration src == dst ({src})")
        if not 0 <= dst < self.capacity:
            raise ValueError(f"slot {dst} out of range [0, {self.capacity})")
        if dst not in self._free:
            raise ValueError(f"destination slot {dst} is not free")
        self._migrate_slot(src, dst)
        return dst

    # -- state hand-over -----------------------------------------------------
    def load_state(self, state: EngineState) -> None:
        """Install a whole pool state (for example one carried over from
        the JAX engine, ``convert.engine_state_from_numpy``).  Shapes and
        dtypes must match this engine's; the cache epoch goes cold, so the
        next ``serve_step`` refills densely."""
        want = init_state(self.cfg, "meta", n_slots=self.capacity)
        for name, got, ref in (
            ("sae", state.surfaces.sae, want.surfaces.sae),
            ("t_last", state.surfaces.t_last, want.surfaces.t_last),
            ("n_events", state.surfaces.n_events, want.surfaces.n_events),
            ("generation", state.generation, want.generation),
            ("cache.tiles", state.cache.tiles, want.cache.tiles),
            ("cache.dirty", state.cache.dirty, want.cache.dirty),
        ):
            if got.shape != ref.shape or got.dtype != ref.dtype:
                raise ValueError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        if (state.counts is None) != (want.counts is None) or (
            state.counts is not None
            and (state.counts.shape != want.counts.shape
                 or state.counts.dtype != want.counts.dtype)
        ):
            raise ValueError("counts plane does not match this engine's "
                             "declared specs")
        dev = self.device
        self.state = EngineState(
            surfaces=ts.SurfaceState(*(x.to(dev).contiguous()
                                       for x in state.surfaces)),
            generation=state.generation.to(dev).contiguous(),
            cache=ReadoutCache(*(x.to(dev).contiguous() for x in state.cache)),
            counts=(None if state.counts is None
                    else state.counts.to(dev).contiguous()),
        )
        self._cache_t = None
        self._cache_surface = None

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> dict:
        s, n = self.state, self.capacity
        return {
            "device": str(self.device),
            "capacity": n,
            "slot_bucket": self.slot_bucket,
            "live": [i not in self._free for i in range(n)],
            "generation": s.generation.tolist(),
            "n_events": s.surfaces.n_events.tolist(),
            "t_last": s.surfaces.t_last.tolist(),
            "free_slots": list(self._free),
            "dirty_tiles": int(s.cache.dirty.sum()),
            "cache_t": self._cache_t,
            "max_dirty_tiles": self._max_dirty,
            "sessions": sorted(self._sessions),
            "counts_plane": s.counts is not None,
            "compiled_specs": len(self._compiled_cache),
        }
