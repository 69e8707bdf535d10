"""Batched streaming time-surface serving engine, on one device or a mesh.

The port of ``repro.serve.ts_engine``.  A fixed
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
noise -- onto a free slot (by default the lowest free slot of the
least-loaded shard, so the lowest free slot on one device), re-binding its
``SensorSession`` in place.  Every move keeps the dirty-tile cache epoch
coherent: a moved cache row holds the source's last read, and fresh or
wiped rows are zeros, the read of a never-written surface at any
``t_now``.  A resize replaces the state's tensors, so products read
before it never alias the new pool; a migration writes the pool in
place, and products are never views of it.

**Device-parallel mode** -- pass a ``mesh`` (``launch.mesh.
make_host_mesh``) and the pool's slot axis splits into ``n_shards``
contiguous blocks of ``slots_per_shard`` slots, padded up to a multiple
of the shard count (``n_slots_padded``; the dead tail is never handed
out and reads as never-written).  Each shard keeps its rows in tensors of
its own on its device, two shards on one card included.  The host routes
each chunk to the shard owning its slot with local slot ids
(``_ShardPlan.route``), and every hot-path op -- scatter, reset, spec
reads, heads (on weights copied to each shard's device), the dirty-tile
refresh -- launches per shard on that shard's tensors and device, each
shard picking incremental or dense on its own dirty count.  Only a
migration between shards crosses devices: a row copy to the
destination's device, then a wipe of the source row.  Pool-level
products come back in slot order at ``n_slots_padded`` rows, gathered on
shard 0's device (``device``), and so is ``gather_state()``, a copy of
the whole pool's state (``state``, the pool's own tensors, exists for one
shard only); a session's ``read`` reads its own shard only.  Per-slot
results are bitwise the one-device engine's at any shard count: the math
per slot never changes, only where the slot lives.

**Deprecated shims** -- the pre-spec method names (``acquire``,
``release``, ``ingest``, ``ingest_and_read``, ``readout``,
``readout_with_mask``, ``support_map``) stay for one release of grace.
Each warns once per engine and name, then forwards to ``attach`` /
``detach`` / ``push`` / ``read`` / ``serve_step``, so it launches the same
kernels and returns the same bits as the session/spec call.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import edram
from repro_torch.core import representations
from repro_torch.core import stcf as stcf_mod
from repro_torch.core import time_surface as ts
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.events import aer
from repro_torch.events import synthetic as syn
from repro_torch.hw import constants as C
from repro_torch.kernels import ops
from repro_torch.models import module as M
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
    pool size (a padded pool, one shard's block, an elastic pool's new
    rows)."""
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


def _leaves(state: EngineState) -> List[Optional[torch.Tensor]]:
    """Every per-slot leaf of a pool state, in one fixed order
    (``_from_leaves`` inverts it; ``counts`` may be None)."""
    sur, cache = state.surfaces, state.cache
    return [sur.sae, sur.t_last, sur.n_events, state.generation,
            cache.tiles, cache.dirty, state.counts]


def _from_leaves(leaves: Sequence[Optional[torch.Tensor]]) -> EngineState:
    sae, t_last, n_events, generation, tiles, dirty, counts = leaves
    return EngineState(
        surfaces=ts.SurfaceState(sae, t_last, n_events),
        generation=generation, cache=ReadoutCache(tiles, dirty),
        counts=counts)


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


def migrate_slot(state: EngineState, src: int, dst: int,
                 dst_state: Optional[EngineState] = None) -> EngineState:
    """Move slot ``src``'s rows onto slot ``dst`` and wipe ``src``, in
    place.  Every per-slot leaf moves: the SAE plane, ``t_last`` /
    ``n_events``, the cache tiles and dirty marks (the destination's
    cached tiles are the source's last valid read, so the pool-wide cache
    epoch stays coherent), the counter plane and the ``generation``
    value -- the analog noise key is folded from the value, never the
    slot index, so an analog slot's noise moves bitwise with it.  ``src``
    is wiped as ``reset_slot`` wipes it, without a generation bump (its
    next attach bumps from the carried value).  ``src != dst`` is the
    caller's contract (``TimeSurfaceEngine.migrate`` enforces it).

    ``dst_state`` names the shard holding ``dst`` when it is not
    ``state`` (``dst`` is then its local index): each row is copied to
    that shard's device.  A copy keeps every bit, ``-inf`` SAE cells and
    bool marks included, as the reference's sum-broadcast over shards
    does."""
    to = state if dst_state is None else dst_state
    for a, b in zip(_leaves(state), _leaves(to)):
        if a is not None:
            b[dst].copy_(a[src])
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


class _ShardPlan:
    """Where the pool's slots live: ``n_shards`` contiguous blocks of
    ``slots_per_shard`` slots, shard ``k`` on ``devices[k]``.

    The pool is padded up to a multiple of the shard count
    (``n_slots_padded``).  The host routes each chunk to the shard owning
    its slot with *local* slot ids (``route``), and every hot-path op --
    scatter, reset, spec reads, heads, the dirty-tile refresh -- runs on
    one shard's tensors alone, so no shard ever waits on another's.  Each
    shard counts its own dirty tiles against ``max_dirty``, derived from
    ``slots_per_shard`` as the reference derives its per-shard cap.  An
    engine without a mesh is one shard over its one device.
    """

    def __init__(self, cfg: TSEngineConfig, devices: Sequence[torch.device],
                 mesh=None):
        self.mesh = mesh
        self.devices = list(devices)
        self.axes = shd.data_axes(mesh) if mesh is not None else ()
        self.n_shards = len(self.devices)
        self._cfg = cfg
        self.resize(self.pad(cfg.n_slots))

    def pad(self, capacity: int) -> int:
        """The padded pool size for ``capacity`` acquirable slots."""
        return (capacity if self.mesh is None
                else shd.pad_pool(capacity, self.mesh))

    def resize(self, n_slots_padded: int) -> None:
        """Track a capacity change: the block size and the per-shard
        dirty-gather cap move with the padded pool."""
        if n_slots_padded % self.n_shards:
            raise ValueError(f"{n_slots_padded} slots do not split over "
                             f"{self.n_shards} shards")
        self.n_slots_padded = n_slots_padded
        self.slots_per_shard = n_slots_padded // self.n_shards
        _, _, tp = self._cfg.tile_counts()
        self.max_dirty = (self._cfg.max_dirty_tiles
                          or max(16, self.slots_per_shard * tp // 4))

    def locate(self, slot: int) -> Tuple[int, int]:
        """``(shard, local slot)`` of a global slot."""
        return divmod(slot, self.slots_per_shard)

    def shard_of(self, slot: int) -> int:
        return shd.shard_of(slot, self.slots_per_shard)

    def route(self, parts: Sequence[Tuple[int, List[np.ndarray]]]):
        """Per-slot -> per-shard ingest routing: ``[(slot, its five (k,
        cap) fields)]`` -> ``[(shard, local slot ids (B,), the five (B,
        cap) fields)]`` for every shard that owns at least one part,
        parts in their given order.  Parts group by shard before they are
        stacked, so every field is copied once, as on one device.  A
        shard's rows are its own launch, so no shard is padded to
        another's row count (the reference pads to a common power of two
        only because ``shard_map`` splits one array into equal blocks),
        and the ring's staging (``TimeSurfaceEngine.push_staged``) keeps
        that rule."""
        groups: List[list] = [[] for _ in range(self.n_shards)]
        for slot, fields in parts:
            k, local = self.locate(slot)
            groups[k].append((local, fields))
        out = []
        for k, rows in enumerate(groups):
            if rows:
                sids = [local for local, f in rows
                        for _ in range(f[0].shape[0])]
                fields = [np.concatenate(f)
                          for f in zip(*(f for _, f in rows))]
                out.append((k, np.asarray(sids, np.int32), fields))
        return out


#: an ingest item: (slot id | session, packed AER words | EventStream |
#: EventBatch)
IngestItem = Tuple[Union[int, SensorSession],
                   Union[np.ndarray, syn.EventStream, ts.EventBatch]]

_FIELDS = (("x", np.int32), ("y", np.int32), ("t", np.float32),
           ("p", np.int32), ("valid", np.bool_))

# the specs the deprecated shims read
_SURFACE_MASK_SPEC = spec_mod.ReadoutSpec(surface=spec_mod.Surface(),
                                          mask=spec_mod.Mask())
_STCF_SPEC = spec_mod.ReadoutSpec(stcf=spec_mod.Stcf())


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
    products for all slots, ``n_slots_padded`` rows on ``device``.  With
    a ``mesh`` (``launch.mesh.make_host_mesh``) the pool splits over the
    mesh's shards (see the module docstring); ``device`` is then shard
    0's, ``gather_state()`` copies the whole pool there, and ``state``
    (the pool's own tensors) exists for one shard only.
    """

    def __init__(self, cfg: TSEngineConfig, device=None, mesh=None):
        self.cfg = cfg
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            devices = shd.slot_pool_devices(mesh)
            if device is not None and resolve_device(device) != devices[0]:
                raise ValueError(f"device {device} is not the mesh's shard "
                                 f"0 device {devices[0]}")
        self.mesh = mesh
        self._plan = _ShardPlan(cfg, devices, mesh)
        self.device = devices[0]
        sps = self._plan.slots_per_shard
        self._states: List[EngineState] = [None] * len(devices)
        for k, dev in enumerate(devices):
            self._install(k, init_state(cfg, dev, n_slots=sps))
        self.capacity = cfg.n_slots
        self._free: List[int] = list(range(cfg.n_slots))
        self._sessions: Dict[int, SensorSession] = {}
        # dirty-tile cache epoch: the (surface product, t_now) the clean
        # cache tiles were read under (None = cold)
        self._cache_t: Optional[float] = None
        self._cache_surface: Optional[Tuple[str, spec_mod.Surface]] = None
        self._compiled_cache: Dict[spec_mod.ReadoutSpec,
                                   spec_mod.CompiledSpec] = {}
        self._head_cache: Dict[Tuple[spec_mod.ReadoutSpec, str],
                               Optional[dict]] = {}
        self._rest_cache: Dict[spec_mod.ReadoutSpec,
                               Optional[spec_mod.ReadoutSpec]] = {}
        # one ring per shard: its own pinned staging sets and copy stream
        self._rings = [IngestRing(cfg.chunk_capacity, dev) for dev in devices]
        self._warned: set = set()   # deprecated shim names already warned

    # -- shards ----------------------------------------------------------------
    @property
    def n_slots_padded(self) -> int:
        """Rows of the pool and of every pool-level product: the capacity
        padded up to a multiple of the shard count."""
        return self._plan.n_slots_padded

    @property
    def shard_devices(self) -> List[torch.device]:
        """The device of each shard, in shard order."""
        return list(self._plan.devices)

    def _install(self, k: int, state: EngineState) -> None:
        """Make ``state`` shard ``k``'s, raising unless every leaf lives
        on the shard's device."""
        dev = self._plan.devices[k]
        for leaf in _leaves(state):
            if leaf is not None and leaf.device != dev:
                raise ValueError(f"shard {k} lives on {dev} but a state "
                                 f"leaf is on {leaf.device}")
        self._states[k] = state

    def _gather(self, parts: Sequence[Dict[str, torch.Tensor]]
                ) -> Dict[str, torch.Tensor]:
        """Per-shard products -> pool products on ``device``, slot order."""
        if len(parts) == 1:
            return parts[0]
        return {name: torch.cat([p[name].to(self.device) for p in parts])
                for name in parts[0]}

    @property
    def state(self) -> EngineState:
        """The pool's own state tensors, for an engine of one shard.  A
        sharded pool has no one state: read a copy with
        ``gather_state`` and install one with ``load_state``."""
        if len(self._states) != 1:
            raise RuntimeError(
                f"the pool is split over {len(self._states)} shards; "
                "gather_state() returns a copy of the whole pool")
        return self._states[0]

    def gather_state(self) -> EngineState:
        """A copy of the whole pool's state, ``n_slots_padded`` rows in
        slot order on ``device``, for any shard count (writing to it
        writes nothing back; ``load_state`` installs a state)."""
        per_leaf = zip(*(_leaves(st) for st in self._states))
        return _from_leaves([
            None if parts[0] is None
            else torch.cat([t.to(self.device) for t in parts])
            for parts in per_leaf])

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
        k, local = self._plan.locate(slot)
        reset_slot(self._states[k], local, bump_generation=True)
        session = SensorSession(self, slot, qos=qos)
        self._sessions[slot] = session
        return session

    def _detach(self, slot: int) -> None:
        """Session teardown: wipe the slot and return it to the pool."""
        self._check_acquired(slot)
        k, local = self._plan.locate(slot)
        reset_slot(self._states[k], local, bump_generation=False)
        self._sessions.pop(slot, None)
        self._free.append(slot)
        self._free.sort()

    def _check_acquired(self, slot: int) -> None:
        if not 0 <= slot < self.capacity:
            raise ValueError(f"slot {slot} out of range [0, {self.capacity})")
        if slot in self._free:
            raise ValueError(f"slot {slot} is not acquired")

    def _slot_generation(self, slot: int) -> int:
        k, local = self._plan.locate(slot)
        return int(self._states[k].generation[local])

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
        """Items -> ``[(shard, local slot ids (B,), the five (B, cap)
        fields)]`` on the host (``_ShardPlan.route``)."""
        return self._plan.route(self._item_chunks(items))

    def push(self, items: Sequence[IngestItem]) -> None:
        """Pool-level batched ingest: one scatter launch per shard for
        every chunk of every item aimed at it.  ``items`` pairs a
        ``SensorSession`` (or its slot id) with a payload; payloads longer
        than ``chunk_capacity`` are split on the host."""
        for k, sids, fields in self._collect(items):
            dev = self._plan.devices[k]
            ev = ts.EventBatch(*(torch.from_numpy(f).to(dev) for f in fields))
            _scatter_chunks(self._states[k], torch.from_numpy(sids).to(dev),
                            ev)

    def push_staged(self, items: Sequence[Tuple[int, RawPart]]) -> None:
        """Ring-staged batched ingest: raw ``(slot | session, (x, y, t,
        p))`` host parts, each at most ``chunk_capacity`` events, staged
        into each shard's ``IngestRing`` and scattered by one
        ``chunk_scatter`` launch per shard.  Rows group by the shard owning
        their slot (ids local); each shard's rows pad with invalid rows to
        a power of two of their own, as ``_ShardPlan.route`` leaves each
        shard's rows its own.  Bitwise the ``push`` of the same parts."""
        cap = self.cfg.chunk_capacity
        per_shard: List[List[Tuple[int, RawPart]]] = [
            [] for _ in range(self._plan.n_shards)]
        for slot, part in items:
            if isinstance(slot, SensorSession):
                slot._check()
                slot = slot.slot
            self._check_acquired(slot)
            if len(part[0]) > cap:
                raise ValueError(
                    f"part of {len(part[0])} events exceeds the chunk "
                    f"capacity {cap}; split parts on the host")
            k, local = self._plan.locate(slot)
            per_shard[k].append((local, part))
        for k, rows in enumerate(per_shard):
            if not rows:
                continue
            ring = self._rings[k]
            buf = ring.acquire(_pad_batch(len(rows)))
            for i, (local, part) in enumerate(rows):
                IngestRing.fill_row(buf, i, local, part)
            sids, ev = ring.upload(buf)
            _scatter_chunks(self._states[k], sids, ev)

    def _ingest_labeled(self, items: Sequence[IngestItem]) -> list:
        """Scatter payloads *and* label each event with its STCF support
        (the body behind ``SensorSession.push_labeled``).

        Chunks go one at a time -- each chunk's support is read against
        the slot's SAE with every earlier chunk written, then the chunk is
        scattered -- so the labels are those of the offline
        ``stcf_chunked`` at ``chunk = chunk_capacity``.  Returns, per
        item, ``(support (n,) int32, support >= stcf_threshold)`` over its
        valid events, on the device of the slot's shard.
        """
        cfg = self.cfg
        stcf_cfg, params = cfg.stcf_config(), cfg.decay_params()
        v_tw = cfg.v_tw()
        out = []
        for slot, fields in self._item_chunks(items):
            k, local = self._plan.locate(slot)
            dev, state = self._plan.devices[k], self._states[k]
            ev = ts.EventBatch(*(torch.from_numpy(f).to(dev) for f in fields))
            sid = torch.tensor([local], dtype=torch.int32, device=dev)
            sups = []
            for i in range(ev.x.shape[0]):
                chunk = ts.EventBatch(*(f[i:i + 1] for f in ev))
                sups.append(ingest_support(state, sid, chunk, stcf_cfg,
                                           cfg.mode, params, v_tw)[0])
                _scatter_chunks(state, sid, chunk)
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
        if spec_mod.needs_counts(spec) and self._states[0].counts is None:
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

    def _resolved(self, spec: spec_mod.ReadoutSpec, k: int = 0):
        """``(compiled plan, {classify head name: params} or None)`` for
        shard ``k``, both resolved once per spec: head weights resolve on
        ``device`` (``serve.heads``) and are copied to each other shard's
        device, so every shard reads with the same bits."""
        compiled = self._compiled(spec)
        dev = self._plan.devices[k]
        key = (spec, str(dev))
        if key not in self._head_cache:
            if k:
                base = self._resolved(spec)[1]
                params = None if base is None else {
                    name: M.unflatten({n: v.to(dev) for n, v in
                                       M.flatten(p).items()})
                    for name, p in base.items()}
            else:
                params = {name: heads_mod.resolve_head_params(h, self.cfg,
                                                              dev)
                          for name, h in compiled.heads
                          if isinstance(h, spec_mod.Classify)} or None
            self._head_cache[key] = params
        return compiled, self._head_cache[key]

    def _read_shard(self, k: int, spec: spec_mod.ReadoutSpec, t_now,
                    noise_step: int) -> Dict[str, torch.Tensor]:
        """Every product of ``spec`` over shard ``k``'s slots."""
        compiled, head_params = self._resolved(spec, k)
        st = self._states[k]
        return spec_mod.read_compiled(
            st.surfaces.sae, st.counts, t_now, compiled, self.cfg,
            head_params, noise_step=noise_step, generation=st.generation)

    def read(self, spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
             t_now: float = 0.0, noise_step: int = 0
             ) -> Dict[str, torch.Tensor]:
        """Every product of ``spec`` over the whole pool at ``t_now``:
        the stage-0 products, then the heads over exactly those tensors,
        each shard reading its own slots.  Free and dead-tail slots read
        as never-written.  The ``surface()`` product is the same
        ``ops.ts_decay`` an offline reader
        (``time_surface.surface_read_kernel``) runs, so engine and
        offline reads of equal SAE state are bitwise equal.
        ``noise_step`` (with each slot's generation) keys the analog
        products' noise; a spec that draws none ignores it."""
        self._check_spec(spec)
        return self._gather([self._read_shard(k, spec, t_now, noise_step)
                             for k in range(self._plan.n_shards)])

    def _read_slot(self, slot: int, spec: spec_mod.ReadoutSpec, t_now,
                   noise_step: int = 0) -> Dict[str, torch.Tensor]:
        """One slot's products: a read of its own shard only."""
        self._check_spec(spec)
        k, local = self._plan.locate(slot)
        return {name: v[local] for name, v in
                self._read_shard(k, spec, t_now, noise_step).items()}

    def read_many(self, specs: Sequence[spec_mod.ReadoutSpec],
                  t_now: float = 0.0, noise_step: int = 0
                  ) -> Dict[spec_mod.ReadoutSpec, Dict[str, torch.Tensor]]:
        """Serve several specs against the same pool state.  Duplicate
        specs are read once, and specs with equal stage-0 sub-specs share
        one stage-0 read, each member's heads running on its tensors --
        bitwise what the member's own ``read`` serves (every shard runs
        its heads on its own slots, as ``read`` does)."""
        uniq = list(dict.fromkeys(specs))
        groups: Dict[spec_mod.ReadoutSpec, List[spec_mod.ReadoutSpec]] = {}
        for sp in uniq:
            self._check_spec(sp)
            groups.setdefault(self._compiled(sp).stage0, []).append(sp)
        per_shard = []
        for k in range(self._plan.n_shards):
            out: Dict[spec_mod.ReadoutSpec, Dict[str, torch.Tensor]] = {}
            for stage0, members in groups.items():
                if len(members) == 1:
                    out[members[0]] = self._read_shard(k, members[0], t_now,
                                                       noise_step)
                    continue
                base = self._read_shard(k, stage0, t_now, noise_step)
                for sp in members:
                    compiled, head_params = self._resolved(sp, k)
                    heads = spec_mod.apply_heads(base, head_params, compiled,
                                                 self.cfg)
                    merged = {**base, **heads}
                    out[sp] = {n: merged[n] for n in sp.names}
            per_shard.append(out)
        return {sp: self._gather([out[sp] for out in per_shard])
                for sp in uniq}

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
        time): the same staged read a ``read`` runs.  Each shard refreshes
        its own cache rows, choosing incremental or dense on its own dirty
        count; either choice is bitwise."""
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
        bh, bw = self.cfg.block
        surfaces = []
        for k, state in enumerate(self._states):
            s = state.surfaces.sae.shape[0]
            tp = state.cache.dirty.shape[1]
            surface, tiles, dirty = ops.ts_fused_dirty(
                state.surfaces.sae, state.cache.tiles.view(s * tp, bh, bw),
                state.cache.dirty.view(s * tp), t_now, params0,
                max_dirty=self._plan.max_dirty, block=self.cfg.block,
                force_dense=refresh_all,
            )
            self._states[k] = state._replace(cache=ReadoutCache(
                tiles=tiles.view(s, tp, bh, bw), dirty=dirty.view(s, tp)))
            surfaces.append({name0: surface})
        self._cache_t = float(t_now)
        self._cache_surface = (name0, prod0)
        out = self._gather(surfaces)
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

    def _resize_state(self, n_slots_padded: int) -> None:
        """Reallocate every shard at ``n_slots_padded / n_shards`` rows:
        global slot ``g`` keeps its bits wherever the new blocks put it,
        rows past the old pool are never-written, rows past the new one
        are dropped.  Each shard gets tensors of its own (a real copy, so
        released storage is freed), filled block by block from the old
        shards (a row copy to the new owner's device)."""
        if n_slots_padded == self.n_slots_padded:
            return
        old, old_sps = self._states, self._plan.slots_per_shard
        sps = n_slots_padded // self._plan.n_shards
        keep = min(n_slots_padded, self.n_slots_padded)
        news = []
        for k, dev in enumerate(self._plan.devices):
            new = init_state(self.cfg, dev, n_slots=sps)
            lo, hi = k * sps, min((k + 1) * sps, keep)
            for j, src in enumerate(old):
                a, b = max(lo, j * old_sps), min(hi, (j + 1) * old_sps)
                if a >= b:
                    continue
                for x, y in zip(_leaves(src), _leaves(new)):
                    if x is not None:
                        y[a - lo:b - lo].copy_(
                            x[a - j * old_sps:b - j * old_sps])
            news.append(new)
        for k, new in enumerate(news):
            self._install(k, new)
        self._plan.resize(n_slots_padded)

    def grow(self, capacity: Optional[int] = None) -> int:
        """Grow the pool to ``capacity`` acquirable slots (default: one
        ``slot_bucket`` more).  The new rows are never-written state;
        live slots keep their bits.  On a mesh the padded pool moves to
        the new capacity's padded size.  Returns the new capacity."""
        if capacity is None:
            capacity = self.capacity + self.slot_bucket
        if capacity <= self.capacity:
            raise ValueError(f"grow target {capacity} <= current capacity "
                             f"{self.capacity} (use shrink())")
        self._resize_state(self._plan.pad(capacity))
        self._free.extend(range(self.capacity, capacity))
        self._free.sort()
        self.capacity = capacity
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
        self._resize_state(self._plan.pad(capacity))
        self._free = [d for d in self._free if d < capacity]
        self.capacity = capacity
        return moves

    def _pick_migration_dst(self, src: int) -> int:
        """The default destination: the lowest free slot on the
        least-loaded shard (live slots other than ``src``, which is about
        to leave its shard); one shard takes the lowest free slot.  The
        action log records the pair, so the oracle replays the choice
        rather than re-deriving it."""
        if not self._free:
            raise RuntimeError("no free slot to migrate into")
        load: Dict[int, int] = {}
        for s in range(self.capacity):
            if s != src and s not in self._free:
                k = self._plan.shard_of(s)
                load[k] = load.get(k, 0) + 1
        return min(self._free,
                   key=lambda d: (load.get(self._plan.shard_of(d), 0), d))

    def _migrate_slot(self, src: int, dst: int) -> None:
        """The state move and the host re-key for one live slot (shared by
        ``migrate`` and ``shrink``; the caller validates).  Across shards
        the rows are copied to the destination shard's device."""
        ks, ls = self._plan.locate(src)
        kd, ld = self._plan.locate(dst)
        migrate_slot(self._states[ks], ls, ld,
                     None if kd == ks else self._states[kd])
        self._free.remove(dst)
        session = self._sessions.pop(src, None)
        if session is not None:
            session._slot = dst
            self._sessions[dst] = session
        self._free.append(src)
        self._free.sort()

    def migrate(self, src: int, dst: Optional[int] = None) -> int:
        """Live-migrate the session on slot ``src`` to free slot ``dst``
        (default: ``_pick_migration_dst``).  Its whole per-slot state
        moves (``migrate_slot``), its ``SensorSession`` re-binds in place,
        and ``src`` is wiped and freed.  Returns the destination slot."""
        self._check_acquired(src)
        if dst is None:
            dst = self._pick_migration_dst(src)
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
        """Install a whole pool state of ``n_slots_padded`` rows (for
        example one carried over from the JAX engine,
        ``convert.engine_state_from_numpy``), split over the shards.
        Shapes and dtypes must match this engine's; the cache epoch goes
        cold, so the next ``serve_step`` refills densely."""
        want = init_state(self.cfg, "meta", n_slots=self.n_slots_padded)
        names = ("sae", "t_last", "n_events", "generation", "cache.tiles",
                 "cache.dirty", "counts")
        for name, got, ref in zip(names, _leaves(state), _leaves(want)):
            if (got is None) != (ref is None):
                raise ValueError("counts plane does not match this "
                                 "engine's declared specs")
            if got is not None and (got.shape != ref.shape
                                    or got.dtype != ref.dtype):
                raise ValueError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                                 f"{tuple(ref.shape)} {ref.dtype}")
        sps = self._plan.slots_per_shard
        for k, dev in enumerate(self._plan.devices):
            rows = slice(k * sps, (k + 1) * sps)
            self._install(k, _from_leaves([
                None if x is None else x[rows].to(dev).contiguous()
                for x in _leaves(state)]))
        self._cache_t = None
        self._cache_surface = None

    # -- deprecated method-per-feature shims (one release of grace) ----------
    def _deprecated(self, name: str, use: str) -> None:
        if name in self._warned:
            return
        self._warned.add(name)
        warnings.warn(
            f"TimeSurfaceEngine.{name}() is deprecated; use {use} "
            "(see the serve.spec module docstring)",
            DeprecationWarning, stacklevel=3,
        )

    def acquire(self) -> int:
        """Deprecated: use ``attach()`` (returns a ``SensorSession``)."""
        self._deprecated("acquire", "attach()")
        return self.attach().slot

    def release(self, slot: int) -> None:
        """Deprecated: use ``SensorSession.detach()``."""
        self._deprecated("release", "SensorSession.detach()")
        self._check_acquired(slot)
        self._sessions[slot].detach()   # every live slot has its session

    def ingest(self, items: Sequence[IngestItem], with_support: bool = False):
        """Deprecated: use ``SensorSession.push`` / ``push_labeled`` (or
        the pool-level ``push`` / ``serve_step`` for multi-sensor steps).
        With ``with_support`` returns ``push_labeled``'s ``(support,
        is_signal)`` per item."""
        self._deprecated("ingest", "SensorSession.push()/push_labeled()")
        if with_support:
            return self._ingest_labeled(items)
        self.push(items)
        return None

    def ingest_and_read(self, items: Sequence[IngestItem],
                        t_now) -> torch.Tensor:
        """Deprecated: use ``serve_step(items, SURFACE_SPEC, t_now)`` (or
        ``SensorSession.push_and_read``); returns its ``surface``."""
        self._deprecated("ingest_and_read", "serve_step(items, spec, t_now)")
        return self.serve_step(items, spec_mod.SURFACE_SPEC, t_now)["surface"]

    def readout(self, t_now) -> torch.Tensor:
        """Deprecated: use ``read(ReadoutSpec(surface=surface()), t_now)``;
        returns that spec's ``surface`` product."""
        self._deprecated("readout", 'read(spec, t_now)["surface"]')
        return self.read(spec_mod.SURFACE_SPEC, t_now)["surface"]

    def readout_with_mask(self, t_now):
        """Deprecated: use ``read`` with a composed
        ``ReadoutSpec(surface=surface(), mask=mask())``."""
        self._deprecated(
            "readout_with_mask",
            "read(ReadoutSpec(surface=surface(), mask=mask()), t_now)")
        out = self.read(_SURFACE_MASK_SPEC, t_now)
        return out["surface"], out["mask"]

    def support_map(self, t_now) -> torch.Tensor:
        """Deprecated: use ``read`` with a ``stcf()`` product."""
        self._deprecated("support_map",
                         "read(ReadoutSpec(stcf=stcf()), t_now)")
        return self.read(_STCF_SPEC, t_now)["stcf"]

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> dict:
        n, states = self.capacity, self._states

        def per_slot(leaf) -> list:   # slot order, each shard's own rows
            return [v for st in states for v in leaf(st).tolist()][:n]

        out = {
            "device": str(self.device),
            "capacity": n,
            "n_slots_padded": self.n_slots_padded,
            "slot_bucket": self.slot_bucket,
            "live": [i not in self._free for i in range(n)],
            "generation": per_slot(lambda st: st.generation),
            "n_events": per_slot(lambda st: st.surfaces.n_events),
            "t_last": per_slot(lambda st: st.surfaces.t_last),
            "free_slots": list(self._free),
            "dirty_tiles": sum(int(st.cache.dirty.sum()) for st in states),
            "cache_t": self._cache_t,
            "max_dirty_tiles": self._plan.max_dirty,
            "sessions": sorted(self._sessions),
            "counts_plane": states[0].counts is not None,
            "compiled_specs": len(self._compiled_cache),
        }
        if self.mesh is not None:
            out["mesh"] = {
                "axes": list(self._plan.axes),
                "n_shards": self._plan.n_shards,
                "n_slots_padded": self.n_slots_padded,
                "slots_per_shard": self._plan.slots_per_shard,
                "devices": [str(d) for d in self._plan.devices],
            }
        return out
