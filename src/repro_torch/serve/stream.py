"""Real-time streaming runtime: continuous event traffic over the engine.

The port of ``repro.serve.stream``, on one device.  The engine is
request/response -- callers hand it pre-windowed chunks and block on
every read.  ``StreamRuntime`` turns it into the
sustained-traffic system the paper's in-sensor array actually is: events
arrive continuously, storage is finite, and readouts happen on
*deadlines*, not on demand.

Three layers, all deterministic given the event timestamps::

    sensor.offer(events)          bounded ingress queue, overload policy
          |                       (the software analogue of finite analog
          v                        storage: MOMCAP charge, LL retention)
    runtime.step(t_deadline)      EDF-schedule ready sensors -> coalesce
          |                       their queues into engine-shaped chunks,
          v                       grouped per tier into shared dispatches
    push (async) + read (async)   pipelined dispatch: the next step's
    sync previous read            host work overlaps the previous read's
                                  device compute -- ONE host sync/deadline

**QoS classes** (``QoSClass``) -- every sensor carries one: a named
*tier*, a *priority* (lower = more important), its own readout
*period* (``period_s``; ``None`` inherits the runtime deadline), a p99
readout-latency SLO budget (``slo_p99_s``), a declared event rate for
admission control (``rate_hint``), and optionally its own
``ReadoutSpec`` -- including head-bearing specs, so a tier can stream
stage-1 model outputs (CNN logits, denoise labels) every deadline; head
products digest-chain exactly like surfaces, the engine's ``read_many``
shares one stage-0 dispatch across tiers whose specs differ only in
heads, and the replay oracle gates the logits bitwise.  The runtime
keeps one *deadline stream* per sensor:
deadlines at multiples of its period.  ``step(t)`` schedules the
sensors whose next deadline has arrived in **EDF order** (earliest
deadline first; ties break by priority, then slot) and coalesces
same-tier chunks into shared engine dispatches so the fused
scatter+spec-read path stays batched.

**Overload + preemption** -- with ``StreamConfig.step_chunk_budget`` set,
a step dispatches at most that many engine chunks.  When the ready work
exceeds the budget the step is *overloaded*: scheduling switches from
EDF to priority order (a ``gesture`` tier preempts ``telemetry``), and
sensors that do not fit are **deferred** -- their deadline stays put (so
they lead the next step's EDF order), their queued events keep aging
under the overload policy (telemetry absorbs the drops), and the
deferral is counted per tier.

**Admission control** -- with ``StreamConfig.capacity_eps`` set (the
engine's declared drain capacity, events per virtual second),
``connect(qos)`` refuses a session whose declared rate would break the
already-admitted tiers' budgets: the demand of each live sensor is
``max(rate_hint, observed drain-rate EWMA)`` -- observed drain rates
catch under-declared producers -- and admission requires
``demand + new rate_hint <= capacity_eps`` (``AdmissionError``
otherwise).

**Overload policy** (``StreamConfig.policy``) -- what happens when a
sensor's queue is full; every path keeps exact drop counters:

  * ``"block"``       -- ``offer`` accepts what fits and returns the count;
                        the producer holds the rest (backpressure).
  * ``"drop_oldest"`` -- new events evict the oldest queued ones (the
                        cache-like bounded-space semantics of streaming
                        DVS filters); ``dropped`` counts evictions.
  * ``"drop_newest"`` -- overflow is discarded on arrival.

**Flow control** -- ``offer`` returns an ``OfferResult``: an ``int``
(events consumed, exactly the pre-QoS return value) that also carries a
``retry_after`` hint in seconds, derived from the sensor's queue
drain-rate EWMA (backlog / observed drain rate; the sensor period when
no drain has been observed yet).  ``retry_after == 0.0`` means the queue
has room -- producers need no policy knowledge, just a sleep hint.

**Coalescing** is rate-adaptive with no tuning: at each of its deadlines
a sensor's whole queue drains into ceil(n / chunk_capacity) chunks.  At
high rates chunks run full (dispatch overhead amortized); at low rates a
partial chunk ships at the deadline (latency stays bounded).  The final
surface is invariant to the chunking -- the engine scatter is a
max-combine and the counter plane an add, both order-insensitive -- which
the replay oracle (``events.replay``) gates bitwise.

**Per-tier accounting** -- ``tier_counters()`` aggregates the exact
per-sensor counters by tier, including across mid-run tier migration
(``set_tier`` re-attributes a sensor's queued-but-unserved events to its
new tier, so the conservation identity holds *per tier* under any
migration schedule)::

    offered == ingested + dropped + refused + discarded + deferred

where ``deferred`` is the still-queued remainder (events whose service
is deferred to a later deadline) and ``deferrals`` counts scheduler
postponements cumulatively.  Per-tier readout-latency percentiles
(``latencies_by_tier``) are the SLO currency of each tier.

**Pipelining** exploits CUDA's asynchronous launches: ``step(t)``
dispatches this deadline's scatter and spec read(s), records a
``torch.cuda.Event`` after the reads, *then* syncs the previous
deadline's event and digests its products.  Host-side work (queue
drains, ring staging, launch overhead) for step k runs while step k-1's
read is still on the device; each step performs exactly one host sync.
``flush()`` syncs the last in-flight read.  With ``pipeline=False``
every step syncs its own read.  Every product is a tensor of its own,
never a view of the pool state, so step k+1's in-place scatter cannot
change the bytes step k's digest reads.  On the CPU every launch is
synchronous and the pipeline changes only when the digest is taken.

**Long-horizon timestamp precision** -- offered stamps are absolute
float64 session times; the runtime pins ``t_epoch`` to the whole-second
floor of the first stamp it ever sees (so sessions starting near t = 0
keep epoch 0 -- bitwise the pre-epoch behavior) and rebases every
engine-facing time (queued event stamps
and deadline read times) against it *before* the float32 cast
(``core.time_surface.rebase_times``).  Surfaces depend only on time
differences, so a stream starting at t = 3600 s reads out bit-identical
to the same stream at t = 0 -- without rebasing, float32's ~0.4 ms ulp
at an hour would have collapsed microsecond stamps.  Scheduling (the
deadline grids) stays in absolute time; the action log records rebased
times, so the replay oracle consumes it verbatim.

**Fleet elasticity + live migration** -- with ``StreamConfig.elastic``,
``connect()`` grows the engine's slot pool by one bucket
(``TSEngineConfig.slot_bucket``) instead of failing when occupancy
would cross ``grow_watermark`` (clamped to ``max_slots``), and each
deadline may release one bucket -- compacting live slots downward --
once occupancy falls to ``shrink_watermark`` of the shrunken capacity.
``migrate(sensor, dst)`` moves a live session between slots at a
deadline boundary: surface rows, dirty tiles, counter plane and the
analog noise generation move bitwise (the noise key folds the
generation *value*, never the slot index), and the sensor's queued
events are re-attributed exactly (``migrated`` per-tier counter --
telemetry alongside the conservation identity, like ``deferrals``).
Every grow / shrink / migrate lands in the action log, so churn
schedules replay bitwise through the synchronous oracle.  A move writes
the pool in place while the previous step's products may still be
pending; those products are tensors of their own (see Pipelining), so
the move cannot change what their digest reads.

**Shard budget** -- ``StreamConfig.shard_budget`` caps the chunks a step
dispatches per shard of the slot pool, priority first, overflow deferred
all-or-nothing per sensor; every ``shard_barrier_every`` deadlines the
step is a **barrier**: the budget lifts, every ready sensor is served and
the per-shard virtual clocks re-sync.  The port's engine is one shard
(the multi-device pool is ROADMAP queue 1 item 2), so the budget caps the
whole pool and there is one clock.

Determinism contract: which events are accepted, dropped, scheduled,
deferred, and coalesced into which chunk of which step is a pure
function of the offered event sequence, the per-sensor deadline
streams, and the QoS classes -- never of wall-clock timing.  The
recorded action log (attach-with-tier / set_tier / detach / step with
host-side chunk copies, EDF order, and the specs read) replays bitwise
through a fresh engine (``events.replay.oracle_digests``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import time_surface as ts_core
from repro_torch.events import aer
from repro_torch.events import synthetic as syn
from repro_torch.hw import energy_model
from repro_torch.serve import fidelity as fidelity_mod
from repro_torch.serve import spec as spec_mod

__all__ = [
    "POLICIES", "QoSClass", "DEFAULT_QOS", "GESTURE_TIER", "TELEMETRY_TIER",
    "AdmissionError", "OfferResult", "StreamConfig", "StreamSensor",
    "StreamRuntime", "StepRecord", "digest_products", "digest_step",
]

POLICIES = ("block", "drop_oldest", "drop_newest")

#: the per-sensor counters that aggregate by tier (exact, deterministic)
TIER_KEYS = ("offered", "accepted", "dropped", "refused", "ingested",
             "discarded", "deferrals", "migrated")

#: the per-sensor modeled-energy accumulators (joules; aggregate by tier
#: like TIER_KEYS but float-valued -- the metering layer's currency)
ENERGY_KEYS = ("energy_write_j", "energy_read_j", "energy_leak_j")


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """One sensor's quality-of-service contract (hashable, logged).

    ``tier`` names the accounting/gating bucket; ``priority`` orders
    tiers under overload (lower = more important -- a priority-0 gesture
    sensor preempts a priority-2 telemetry one); ``period_s`` is the
    sensor's own readout period (its deadline stream is the multiples
    of this period; ``None`` inherits ``StreamConfig.deadline_s``);
    ``slo_p99_s`` is the tier's p99 readout-latency budget (the budget
    admission control protects); ``rate_hint`` is the declared event rate in events per
    *virtual* second (the admission-control currency; 0 = undeclared);
    ``spec`` optionally overrides the runtime's ``ReadoutSpec`` for
    steps that serve this sensor (sensors sharing a spec share one
    fused dispatch -- ``TimeSurfaceEngine.read_many`` dedupes).
    """

    tier: str = "default"
    priority: int = 1
    period_s: Optional[float] = None
    slo_p99_s: float = math.inf
    rate_hint: float = 0.0
    spec: Optional[spec_mod.ReadoutSpec] = None

    def __post_init__(self):
        if not self.tier:
            raise ValueError("tier name must be non-empty")
        if self.period_s is not None and not self.period_s > 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")
        if not self.slo_p99_s > 0:
            raise ValueError(f"slo_p99_s must be > 0, got {self.slo_p99_s}")
        if not self.rate_hint >= 0:
            raise ValueError(f"rate_hint must be >= 0, got {self.rate_hint}")


DEFAULT_QOS = QoSClass()
#: ready-made tiers for the paper's canonical mixed workload: a
#: gesture-recognition sensor outranks environment telemetry
GESTURE_TIER = QoSClass(tier="gesture", priority=0, slo_p99_s=0.25)
TELEMETRY_TIER = QoSClass(tier="telemetry", priority=2, slo_p99_s=2.0)


class AdmissionError(RuntimeError):
    """connect() refused: the declared rate would break admitted tiers."""


class OfferResult(int):
    """``offer``'s return value: an ``int`` (events consumed -- exactly
    the pre-QoS semantics, so ``offer(ev) == n`` keeps working) that
    also carries the flow-control breakdown of this offer and a
    ``retry_after`` sleep hint in seconds (0.0 = queue has room;
    derived from the queue drain-rate EWMA, never wall time)."""

    def __new__(cls, consumed: int, *, accepted: int = 0, dropped: int = 0,
                refused: int = 0, retry_after: float = 0.0):
        self = super().__new__(cls, consumed)
        self.accepted = accepted
        self.dropped = dropped
        self.refused = refused
        self.retry_after = retry_after
        return self

    def __repr__(self) -> str:
        return (f"OfferResult({int(self)}, accepted={self.accepted}, "
                f"dropped={self.dropped}, refused={self.refused}, "
                f"retry_after={self.retry_after:.4g})")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static runtime configuration.

    ``queue_capacity`` bounds each sensor's ingress queue in *events* --
    the finite-storage knob; ``deadline_s`` is the default readout
    period (every ``step`` call is one deadline on the runtime grid;
    sensors with a ``QoSClass.period_s`` keep their own deadline
    streams); ``policy`` picks the overload behavior;
    ``step_chunk_budget`` caps the engine chunks one step may dispatch
    (``None`` = unlimited; exceeding it is *overload*: priority
    preempts EDF and the rest defer); ``capacity_eps`` is the declared
    drain capacity in events per virtual second that admission control
    protects (``None`` disables admission); ``pipeline=False`` degrades
    to sync-per-step (the synchronous comparator);
    ``device_ring=True`` (the default) routes ingest through the
    engine's pinned double-buffered staging ring
    (``TimeSurfaceEngine.push_staged``): each deadline's upload is one
    copy per field on a side stream, bitwise identical to the
    host-staged ``push`` path (``device_ring=False``);
    ``record_chunks=False`` drops the host-side chunk copies from the
    action log (timing-only runs -- the oracle replay then has nothing
    to consume).

    Fleet knobs: ``elastic=True`` lets ``connect()`` grow the engine's
    slot pool by buckets instead of failing, up to ``max_slots`` (``None``
    = unbounded); growth triggers when one more sensor would push
    occupancy past ``grow_watermark`` of capacity (1.0 = grow only when
    full).  ``shrink_watermark`` > 0 enables auto-shrink: at a deadline
    boundary, if occupancy is at or below that fraction of the *shrunken*
    capacity, one bucket is released (live tail slots compact downward;
    never below the capacity the engine started with).  ``shard_budget``
    caps the chunks one step may dispatch per shard (priority claims the
    budget first; overflow defers); ``shard_barrier_every`` = N makes
    every Nth deadline a barrier step that lifts the shard budgets and
    re-syncs the per-shard virtual clocks (0 disables barriers).
    """

    policy: str = "drop_oldest"
    queue_capacity: int = 1 << 15
    deadline_s: float = 0.01
    step_chunk_budget: Optional[int] = None
    capacity_eps: Optional[float] = None
    pipeline: bool = True
    device_ring: bool = True
    record_chunks: bool = True
    max_record_steps: Optional[int] = 10_000
    elastic: bool = False
    max_slots: Optional[int] = None
    grow_watermark: float = 1.0
    shrink_watermark: float = 0.0
    shard_budget: Optional[int] = None
    shard_barrier_every: int = 0
    # retention bound on the action log: beyond this many recorded
    # steps the oldest step entries are trimmed (counted in
    # ``log_trimmed_steps``) so a long-running deployment cannot retain
    # every ingested event in host memory.  A trimmed log is no longer
    # oracle-replayable from t=0 -- ``events.replay.check_oracle`` says
    # so explicitly.  ``None`` disables trimming (replay-harness runs).

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {self.policy!r}"
            )
        for name, ok in (
            ("queue_capacity", self.queue_capacity >= 1),
            ("deadline_s", self.deadline_s > 0),
            ("step_chunk_budget", self.step_chunk_budget is None
             or self.step_chunk_budget >= 1),
            ("capacity_eps", self.capacity_eps is None
             or self.capacity_eps > 0),
            ("max_record_steps", self.max_record_steps is None
             or self.max_record_steps >= 1),
            ("max_slots", self.max_slots is None or self.max_slots >= 1),
            ("grow_watermark", 0.0 < self.grow_watermark <= 1.0),
            ("shrink_watermark", 0.0 <= self.shrink_watermark <= 1.0),
            ("shard_budget", self.shard_budget is None
             or self.shard_budget >= 1),
            ("shard_barrier_every", self.shard_barrier_every >= 0),
        ):
            if not ok:
                raise ValueError(f"StreamConfig.{name} out of range: "
                                 f"{getattr(self, name)!r}")

#: one queued segment: (x, y, t, p) host arrays, equal length
_Segment = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

#: scheduling epsilon: a deadline k*period compares ready at t=k*period
#: despite float rounding of the grid arithmetic
_EPS = 1e-9

#: EWMA smoothing for the observed per-sensor drain rate
_EWMA_ALPHA = 0.3


def _as_arrays(events, h: int, w: int) -> _Segment:
    """Normalize an offer payload (``EventStream``, packed uint64 AER
    words, or an (x, y, t, p) tuple of arrays) to host numpy arrays.

    Timestamps stay **float64** here: they are absolute session times,
    and the float32 cast only happens *after* epoch rebasing (see
    ``StreamRuntime._rebase``) -- casting absolute times directly would
    quantize microsecond stamps to ~0.4 ms once a session is an hour
    old (float32 ulp at 3600 s)."""
    if isinstance(events, np.ndarray) and events.dtype == np.uint64:
        events = aer.unpack(events, h, w)
    if isinstance(events, syn.EventStream):
        return (events.x.astype(np.int32), events.y.astype(np.int32),
                events.t.astype(np.float64), events.p.astype(np.int32))
    x, y, t, p = events
    return (np.asarray(x, np.int32), np.asarray(y, np.int32),
            np.asarray(t, np.float64), np.asarray(p, np.int32))


class StreamSensor:
    """One sensor's bounded ingress queue + its engine session + QoS.

    Create via ``StreamRuntime.connect(qos)``.  ``offer(events)`` is the
    producer side; the runtime drains the queue at each of the sensor's
    own deadlines.  All counters are exact and deterministic (see the
    module docstring).
    """

    def __init__(self, runtime: "StreamRuntime", session,
                 qos: QoSClass = DEFAULT_QOS):
        self._runtime = runtime
        self.session = session
        self.qos = qos
        self._segments: List[_Segment] = []
        self._queued = 0
        # -- per-sensor deadline stream + drain-rate observation ----------
        self.next_deadline = -math.inf   # ready at the first step
        self._last_sched_t: Optional[float] = None
        self.drain_eps: Optional[float] = None   # observed EWMA, ev/s
        # -- exact accounting --------------------------------------------
        self.offered = 0     # events handed to offer()
        self.accepted = 0    # events that entered the queue
        self.dropped = 0     # evicted (drop_oldest) or refused (drop_newest)
        self.refused = 0     # block policy: events offer() did not take
        self.ingested = 0    # events drained into engine chunks
        self.discarded = 0   # queued events thrown away by disconnect()
        self.deferrals = 0   # events postponed by overload scheduling
        self.migrated = 0    # queued events re-attributed by slot migration
        # -- modeled energy (joules; hw.energy_model.EnergyMeter) ---------
        self.energy_write_j = 0.0   # ingest: write energy x events
        self.energy_read_j = 0.0    # readout: array access x dispatches
        self.energy_leak_j = 0.0    # retention: leakage power x window
        self._last_energy_t: Optional[float] = None
        # tier-attribution snapshot: counter values at the last tier
        # change (tier aggregation reads the delta since)
        self._snap = {k: 0 for k in TIER_KEYS}
        self._energy_snap = {k: 0.0 for k in ENERGY_KEYS}

    # -- producer side --------------------------------------------------------
    @property
    def slot(self) -> int:
        return self.session.slot

    @property
    def queued(self) -> int:
        """Events currently waiting in the queue."""
        return self._queued

    @property
    def period_s(self) -> float:
        """This sensor's readout period (its own deadline stream)."""
        return (self.qos.period_s if self.qos.period_s is not None
                else self._runtime.cfg.deadline_s)

    def _retry_after(self, backlog: int) -> float:
        """Flow-control hint: seconds until ``backlog`` events drain at
        the observed drain rate (the sensor period before any drain has
        been observed -- one full deadline is the natural first guess)."""
        if backlog <= 0:
            return 0.0
        if self.drain_eps and self.drain_eps > 0:
            return backlog / self.drain_eps
        return self.period_s

    def offer(self, events) -> OfferResult:
        """Offer events; returns an ``OfferResult`` -- an ``int`` of how
        many were *consumed* (accepted or dropped by policy) carrying a
        ``retry_after`` backpressure hint.  Under ``"block"`` the value
        may be short -- the producer re-offers the remainder after
        ``retry_after`` seconds (that IS the backpressure).  Events must
        be time-sorted within one offer.  Accepted events are **copied**
        into the queue: producers may reuse or mutate their buffers
        immediately after ``offer`` returns (the natural real-time
        sensor-loop pattern)."""
        if self.session is None:
            raise RuntimeError("sensor is disconnected")
        cfg = self._runtime.cfg
        x, y, t, p = _as_arrays(events, self._runtime.engine.cfg.h,
                                self._runtime.engine.cfg.w)
        n = len(x)
        self.offered += n
        if n:
            # rebase absolute float64 stamps to the runtime epoch and
            # only then go float32 (long-horizon precision; the epoch
            # pins off the first stamp this runtime ever sees, accepted
            # or not, so it is a pure function of the offered sequence)
            t = self._runtime._rebase(t)
        if n == 0:
            return OfferResult(0, retry_after=self._retry_after(
                self._queued - cfg.queue_capacity))
        free = cfg.queue_capacity - self._queued
        if cfg.policy == "block":
            take = min(free, n)
            self.refused += n - take
            if take:
                self._append((x[:take], y[:take], t[:take], p[:take]))
            return OfferResult(
                take, accepted=take, refused=n - take,
                retry_after=self._retry_after(n - take),
            )
        if cfg.policy == "drop_newest":
            take = min(free, n)
            self.dropped += n - take
            if take:
                self._append((x[:take], y[:take], t[:take], p[:take]))
            return OfferResult(
                n, accepted=take, dropped=n - take,
                retry_after=self._retry_after(n - take),
            )
        # drop_oldest: everything enters, the head makes room
        self._append((x, y, t, p))
        overflow = self._queued - cfg.queue_capacity
        if overflow > 0:
            self._evict_oldest(overflow)
        return OfferResult(
            n, accepted=n, dropped=max(overflow, 0),
            retry_after=self._retry_after(overflow),
        )

    def _append(self, seg: _Segment) -> None:
        # own a copy: _as_arrays/asarray and slicing return views of the
        # producer's buffers, which it may legitimately reuse after
        # offer() returns -- the queue (and the action log built from it)
        # must never alias caller memory
        self._segments.append(tuple(np.array(a, copy=True) for a in seg))
        self._queued += len(seg[0])
        self.accepted += len(seg[0])

    def _evict_oldest(self, n: int) -> None:
        self.dropped += n
        self._queued -= n
        while n > 0:
            head = self._segments[0]
            m = len(head[0])
            if m <= n:
                self._segments.pop(0)
                n -= m
            else:
                self._segments[0] = tuple(a[n:] for a in head)
                n = 0

    # -- runtime side ---------------------------------------------------------
    def _drain(self) -> Optional[_Segment]:
        """Pop everything queued as one concatenated segment."""
        if not self._queued:
            return None
        segs = self._segments
        out = tuple(
            np.concatenate([s[i] for s in segs]) for i in range(4)
        ) if len(segs) > 1 else segs[0]
        self._segments = []
        self.ingested += self._queued
        self._queued = 0
        return out

    def _note_scheduled(self, t: float, drained: int) -> None:
        """Advance this sensor's deadline stream past ``t`` and fold the
        drain into the observed drain-rate EWMA (virtual time only)."""
        if drained > 0:
            dt = (t - self._last_sched_t
                  if self._last_sched_t is not None else self.period_s)
            if dt > 0:
                inst = drained / dt
                self.drain_eps = (
                    inst if self.drain_eps is None
                    else _EWMA_ALPHA * inst
                    + (1.0 - _EWMA_ALPHA) * self.drain_eps
                )
        self._last_sched_t = t
        period = self.period_s
        self.next_deadline = (math.floor((t + _EPS) / period) + 1) * period

    # -- tier attribution -----------------------------------------------------
    def _tier_delta(self) -> Dict[str, int]:
        """Counter movement since the last tier change (what the current
        tier owns)."""
        return {k: getattr(self, k) - self._snap[k] for k in TIER_KEYS}

    def _fold_tier(self, buckets: Dict[str, Dict[str, int]],
                   migrate_queued: bool = False) -> None:
        """Retire this sensor's delta into its current tier's bucket.

        With ``migrate_queued`` (tier migration), the still-queued
        events' ``offered``/``accepted`` counts move *with* the sensor
        to its next tier -- so each tier's conservation identity
        (offered == ingested + dropped + refused + discarded + queued)
        holds exactly on both sides of the migration.
        """
        bucket = buckets.setdefault(self.qos.tier,
                                    {k: 0 for k in TIER_KEYS})
        delta = self._tier_delta()
        if migrate_queued:
            delta["offered"] -= self._queued
            delta["accepted"] -= self._queued
        for k in TIER_KEYS:
            bucket[k] += delta[k]
        self._snap = {k: getattr(self, k) for k in TIER_KEYS}
        if migrate_queued:
            self._snap["offered"] -= self._queued
            self._snap["accepted"] -= self._queued

    def _energy_delta(self) -> Dict[str, float]:
        """Modeled-energy movement since the last tier change."""
        return {k: getattr(self, k) - self._energy_snap[k]
                for k in ENERGY_KEYS}

    def _fold_energy(self, buckets: Dict[str, Dict[str, float]]) -> None:
        """Retire this sensor's energy delta into its current tier (the
        float twin of ``_fold_tier``; energy accrued under a tier stays
        attributed to it across migration)."""
        bucket = buckets.setdefault(self.qos.tier,
                                    {k: 0.0 for k in ENERGY_KEYS})
        for k, v in self._energy_delta().items():
            bucket[k] += v
        self._energy_snap = {k: getattr(self, k) for k in ENERGY_KEYS}

    def stats(self) -> dict:
        return {
            "slot": self.slot if self.session is not None else None,
            "tier": self.qos.tier, "priority": self.qos.priority,
            "period_s": self.period_s,
            "next_deadline": self.next_deadline,
            "drain_eps": self.drain_eps,
            "queued": self._queued, "offered": self.offered,
            "accepted": self.accepted, "dropped": self.dropped,
            "refused": self.refused, "ingested": self.ingested,
            "discarded": self.discarded, "deferrals": self.deferrals,
            "migrated": self.migrated,
            "energy_write_j": self.energy_write_j,
            "energy_read_j": self.energy_read_j,
            "energy_leak_j": self.energy_leak_j,
        }


@dataclasses.dataclass
class StepRecord:
    """One deadline's dispatch, with enough host state to replay it.

    ``chunks`` holds host-side copies of the coalesced (slot, events)
    pairs exactly as dispatched (absent when ``record_chunks=False``);
    ``order`` is the EDF/priority schedule this step ran -- (slot, tier,
    deadline) per scheduled sensor, in drain order; ``deferred`` lists
    the sensors overload pushed past this step as (slot, tier, queued);
    ``specs`` are the ReadoutSpecs this step read (primary first);
    ``digest`` is the SHA-256 of the synced products, filled at sync
    time, which the synchronous oracle must reproduce bitwise.
    ``latency_s`` is dispatch -> sync-returned wall time (in pipelined
    mode the sync happens at the next deadline, so it is the latency the
    *consumer* of the previous frame observes).
    """

    t_read: float
    n_events: int
    n_chunks: int
    chunks: Optional[List[Tuple[int, _Segment]]]
    wall_dispatch: float
    order: List[Tuple[int, str, float]] = dataclasses.field(
        default_factory=list)
    deferred: List[Tuple[int, str, int]] = dataclasses.field(
        default_factory=list)
    overload: bool = False
    specs: Tuple[spec_mod.ReadoutSpec, ...] = ()
    noise_step: int = 0      # analog-fidelity noise key (the step index)
    barrier: bool = False    # shard-clock barrier step (budgets lifted)
    latency_s: float = float("nan")
    digest: str = ""


#: action-log entries:
#:   ("attach", (slot, QoSClass)) | ("set_tier", (slot, QoSClass))
#:   | ("detach", slot) | ("step", rec)
#:   | ("grow", new_capacity) | ("shrink", (new_capacity, moves))
#:   | ("migrate", (src_slot, dst_slot))
LogEntry = Tuple[str, Union[int, Tuple, StepRecord]]


def digest_products(products: Dict[str, torch.Tensor]) -> str:
    """SHA-256 over the (name-sorted) product tensors' raw bytes, copied
    to the host -- the bitwise-equality currency of the replay oracle
    gate."""
    h = hashlib.sha256()
    for name in sorted(products):
        a = products[name].detach().cpu().numpy()
        h.update(name.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def digest_step(products_list: Sequence[Dict[str, torch.Tensor]]) -> str:
    """Digest of one step's reads.  A single-spec step digests exactly
    as before (``digest_products``) so pre-QoS digests stay comparable;
    a multi-spec step chains the per-spec digests in read order."""
    if len(products_list) == 1:
        return digest_products(products_list[0])
    h = hashlib.sha256()
    for products in products_list:
        h.update(digest_products(products).encode())
    return h.hexdigest()


class _Inflight:
    """One dispatched step: its record, its products, and the CUDA event
    recorded after its reads (None on the CPU, where reads are done when
    they return)."""

    __slots__ = ("record", "products_list", "done")

    def __init__(self, record: StepRecord,
                 products_list: List[Dict[str, torch.Tensor]], done):
        self.record = record
        self.products_list = products_list
        self.done = done


class StreamRuntime:
    """Continuous-traffic front end over a ``TimeSurfaceEngine``.

    One runtime owns its engine's traffic: ``connect(qos)`` admits and
    attaches a session and wraps it in a ``StreamSensor`` queue,
    ``step(t)`` runs one deadline (EDF-schedule -> drain -> pipelined
    push+read -> sync previous), and ``flush()`` syncs the tail.
    """

    def __init__(
        self,
        engine,
        cfg: StreamConfig = StreamConfig(),
        spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
        *,
        max_latency_samples: int = 100_000,
    ):
        self.engine = engine
        self.cfg = cfg
        self.spec = spec
        self.sensors: Dict[int, StreamSensor] = {}   # slot -> sensor
        self._use_ring = cfg.device_ring
        self.log: List[LogEntry] = []
        self.latencies_s: List[float] = []
        self.latencies_by_tier: Dict[str, List[float]] = {}
        self._max_lat = max_latency_samples
        self._inflight: Optional[_Inflight] = None
        self._retired: Dict[str, int] = {
            k: 0 for k in ("offered", "accepted", "dropped", "refused",
                           "ingested", "discarded", "migrated")
        }
        # elastic floor: never auto-shrink below the starting capacity
        self._min_capacity = engine.capacity
        # per-shard virtual clocks: the last deadline each shard served
        # work at; barriers re-sync all of them
        self._shard_clocks: Dict[int, float] = {}
        self._tier_retired: Dict[str, Dict[str, int]] = {}
        self._tier_slo: Dict[str, float] = {}
        # -- modeled-energy metering (hw.energy_model; host-float only) ---
        ecfg = engine.cfg
        self.meter = energy_model.EnergyMeter(
            h=ecfg.h, w=ecfg.w, polarities=ecfg.polarities,
            cmem_f=ecfg.cmem_f)
        self._retired_energy: Dict[str, float] = {
            k: 0.0 for k in ENERGY_KEYS}
        self._tier_energy: Dict[str, Dict[str, float]] = {}
        self._mode_cache: Dict[spec_mod.ReadoutSpec, str] = {}
        self.n_steps = 0
        self.log_trimmed_steps = 0
        #: per-runtime timestamp epoch (absolute seconds, float64): the
        #: whole-second floor of the first stamp ever offered.  Every
        #: engine-facing time -- event
        #: stamps and deadline read times -- is rebased against it before
        #: the float32 cast (see ``core.time_surface.rebase_times``);
        #: scheduling stays in absolute time.
        self.t_epoch: Optional[float] = None

    def _rebase(self, t: np.ndarray) -> np.ndarray:
        """Pin the epoch to the whole second **floor** of the first stamp
        seen, then rebase ``t``.  The floor (rather than the stamp
        itself) keeps a session that starts inside its first second at
        epoch 0 -- bitwise the pre-epoch behavior -- while still bounding
        the rebased magnitude to span + 1 s (float32 ulp ~60 ns at 1 s,
        ample for microsecond stamps)."""
        if self.t_epoch is None:
            self.t_epoch = float(np.floor(np.float64(t[0])))
        return ts_core.rebase_times(t, self.t_epoch)

    # -- lifecycle ------------------------------------------------------------
    def _admit(self, qos: QoSClass) -> None:
        """SLO-aware admission control: refuse a session whose declared
        rate would break the admitted tiers' budgets.  Demand per live
        sensor is max(declared rate, observed drain-rate EWMA) -- the
        observed rates catch producers that under-declared."""
        cap = self.cfg.capacity_eps
        if cap is None:
            return
        demand = sum(
            max(s.qos.rate_hint, s.drain_eps or 0.0)
            for s in self.sensors.values()
        )
        if demand + qos.rate_hint > cap:
            per_tier: Dict[str, float] = {}
            for s in self.sensors.values():
                per_tier[s.qos.tier] = per_tier.get(s.qos.tier, 0.0) + max(
                    s.qos.rate_hint, s.drain_eps or 0.0)
            detail = ", ".join(
                f"{t}={r:.0f}ev/s" for t, r in sorted(per_tier.items()))
            raise AdmissionError(
                f"admission refused: tier {qos.tier!r} declares "
                f"{qos.rate_hint:.0f} ev/s but admitted demand is already "
                f"{demand:.0f} of {cap:.0f} ev/s capacity ({detail or 'none'})"
            )

    def _grow_bucket(self) -> None:
        """Grow the pool by one bucket (clamped to ``max_slots``), logged
        so the oracle replays the same capacity trajectory."""
        eng = self.engine
        target = eng.capacity + eng.slot_bucket
        if self.cfg.max_slots is not None:
            target = min(target, self.cfg.max_slots)
        self.log.append(("grow", eng.grow(target)))

    def _may_grow(self) -> bool:
        return (self.cfg.max_slots is None
                or self.engine.capacity < self.cfg.max_slots)

    def connect(self, qos: QoSClass = DEFAULT_QOS) -> StreamSensor:
        """Admit + attach a session under ``qos`` (raises
        ``AdmissionError`` when the declared rate does not fit,
        ``RuntimeError`` when the pool is full and cannot grow) and
        return its queue-fronted sensor handle.  With
        ``StreamConfig.elastic``, a pool whose occupancy would cross
        ``grow_watermark`` grows by buckets (up to ``max_slots``)
        instead of refusing."""
        self._admit(qos)
        if self.cfg.elastic:
            eng = self.engine
            while (eng.n_live + 1 > self.cfg.grow_watermark * eng.capacity
                   and self._may_grow()):
                self._grow_bucket()
        session = self.engine.attach(qos=qos)
        sensor = StreamSensor(self, session, qos)
        self.sensors[session.slot] = sensor
        self._tier_slo[qos.tier] = min(
            self._tier_slo.get(qos.tier, math.inf), qos.slo_p99_s)
        self.log.append(("attach", (session.slot, qos)))
        return sensor

    def set_tier(self, sensor: StreamSensor, qos: QoSClass) -> None:
        """Migrate a live sensor to a new QoS class.  The sensor's
        served/dropped history stays attributed to the old tier; its
        still-queued events (and their offered/accepted counts) move to
        the new tier, so per-tier conservation holds exactly across the
        migration.  The deadline stream re-periods at the next
        schedule."""
        if sensor.session is None:
            raise RuntimeError("sensor is disconnected")
        sensor._fold_tier(self._tier_retired, migrate_queued=True)
        sensor._fold_energy(self._tier_energy)
        sensor.qos = qos
        self._tier_slo[qos.tier] = min(
            self._tier_slo.get(qos.tier, math.inf), qos.slo_p99_s)
        self.log.append(("set_tier", (sensor.slot, qos)))

    def migrate(self, sensor: StreamSensor, dst: Optional[int] = None) -> int:
        """Move a live sensor to another slot (``dst=None``: the lowest
        free slot; a full elastic pool grows a bucket first).  The slot's
        whole device state -- surface rows, dirty tiles, counter plane and
        the analog noise *generation* -- moves bitwise, so later analog
        reads draw the noise they would have drawn in the source slot.
        The queued events follow the sensor (counted per tier in
        ``migrated``); its deadline stream, QoS class and counters are
        untouched.  The (src, dst) pair is logged for the oracle."""
        if sensor.session is None:
            raise RuntimeError("sensor is disconnected")
        src = sensor.slot
        eng = self.engine
        if (dst is None and self.cfg.elastic
                and eng.n_live >= eng.capacity and self._may_grow()):
            self._grow_bucket()
        dst = eng.migrate(src, dst)
        self.sensors[dst] = self.sensors.pop(src)
        sensor.migrated += sensor.queued
        self.log.append(("migrate", (src, dst)))
        return dst

    def _maybe_shrink(self) -> None:
        """Release one bucket at this deadline boundary when the elastic
        policy says so: occupancy at or below ``shrink_watermark`` of the
        *shrunken* capacity, and never below the starting capacity.  Live
        tail slots compact downward (each a bitwise slot move); the
        (capacity, moves) pair is logged so the oracle reproduces the
        same compaction."""
        cfg = self.cfg
        if not cfg.elastic or cfg.shrink_watermark <= 0.0:
            return
        eng = self.engine
        target = eng.capacity - eng.slot_bucket
        if target < max(self._min_capacity, 1):
            return
        if eng.n_live > cfg.shrink_watermark * target:
            return
        moves = eng.shrink(target)
        for src, dst in moves:
            moved = self.sensors.pop(src, None)
            if moved is not None:
                self.sensors[dst] = moved
                moved.migrated += moved.queued
        self.log.append(("shrink", (target, moves)))

    def disconnect(self, sensor: StreamSensor) -> None:
        """Detach: the sensor's queued events are discarded (counted in
        ``discarded`` -- a disconnect is data loss, and we say so), its
        slot returns to the pool."""
        if sensor.session is None:
            raise RuntimeError("sensor already disconnected")
        sensor.discarded += sensor.queued
        sensor._segments, sensor._queued = [], 0
        sensor._fold_tier(self._tier_retired)
        sensor._fold_energy(self._tier_energy)
        slot = sensor.slot
        st = sensor.stats()
        for k in self._retired:
            self._retired[k] += st[k]
        for k in ENERGY_KEYS:
            self._retired_energy[k] += st[k]
        self.sensors.pop(slot, None)
        sensor.session.detach()
        sensor.session = None
        self.log.append(("detach", slot))

    # -- modeled-energy accounting --------------------------------------------
    def _sensor_mode(self, sensor: StreamSensor) -> str:
        """The fidelity mode of the substrate serving this sensor -- its
        tier spec's (or the primary spec's) dominant mode.  Decides
        which of the meter's cost cards its activity is billed to."""
        sp = sensor.qos.spec if sensor.qos.spec is not None else self.spec
        mode = self._mode_cache.get(sp)
        if mode is None:
            mode = fidelity_mod.spec_fidelity_mode(sp)
            self._mode_cache[sp] = mode
        return mode

    def _account_step_energy(self, t: float) -> None:
        """Accrue per-sensor retention leakage (over the virtual-time
        window since the sensor was last metered) and one array-readout
        access (every step's fused read samples every live slot).  Pure
        host-float bookkeeping off exact counters -- never touches device
        state, so metering cannot perturb the replay contract."""
        for s in self.sensors.values():
            mode = self._sensor_mode(s)
            if s._last_energy_t is not None and t > s._last_energy_t:
                s.energy_leak_j += self.meter.leakage_energy_j(
                    mode, t - s._last_energy_t)
            s._last_energy_t = t
            s.energy_read_j += self.meter.read_energy_j(mode)

    # -- the deadline loop ----------------------------------------------------
    def _shard_of(self, slot: int) -> int:
        """The shard a slot lives on: 0, the port's pool being one."""
        return 0

    def _n_shards(self) -> int:
        return 1

    def _schedule(self, t: float):
        """Pick this step's sensors: every sensor whose next deadline
        has arrived, EDF order (deadline, then priority, then slot).
        With a ``step_chunk_budget`` and more ready chunks than budget,
        the step is *overloaded*: order switches to priority-first and
        the overflow defers (deadline unmoved, so deferred sensors lead
        the next EDF pass).  With ``shard_budget`` a second, per-shard
        cap applies the same way -- priority claims a shard's budget
        first, deferral stays all-or-nothing per sensor -- except on
        *barrier* steps (every ``shard_barrier_every`` deadlines), where
        the shard budgets lift.  Pure virtual-time scheduling -- the
        replay oracle re-derives nothing, it replays the recorded
        schedule.

        Returns ``(take, defer, overload, barrier)``."""
        ready = [
            s for _, s in sorted(self.sensors.items())
            if s.next_deadline <= t + _EPS
        ]
        ready.sort(key=lambda s: (s.next_deadline, s.qos.priority, s.slot))
        barrier = (self.cfg.shard_barrier_every > 0
                   and (self.n_steps + 1) % self.cfg.shard_barrier_every == 0)
        take, defer, overload = ready, [], False
        budget = self.cfg.step_chunk_budget
        cap = self.engine.cfg.chunk_capacity
        if budget is not None:
            need = {s.slot: -(-s.queued // cap) for s in ready}
            if sum(need.values()) > budget:
                # overload: priority preempts EDF; deferral is
                # all-or-nothing per sensor (a partial drain would split
                # one deadline's events across steps and break the
                # coalescing invariant)
                by_priority = sorted(
                    ready,
                    key=lambda s: (s.qos.priority, s.next_deadline, s.slot))
                used, take, defer = 0, [], []
                for s in by_priority:
                    if need[s.slot] and used + need[s.slot] > budget:
                        defer.append(s)
                    else:
                        take.append(s)
                        used += need[s.slot]
                overload = True
        sbudget = self.cfg.shard_budget
        if sbudget is not None and not barrier and take:
            by_priority = sorted(
                take, key=lambda s: (s.qos.priority, s.next_deadline, s.slot))
            used_by_shard: Dict[int, int] = {}
            kept, over = [], []
            for s in by_priority:
                nd = -(-s.queued // cap)
                shard = self._shard_of(s.slot)
                if nd and used_by_shard.get(shard, 0) + nd > sbudget:
                    over.append(s)
                else:
                    kept.append(s)
                    used_by_shard[shard] = used_by_shard.get(shard, 0) + nd
            if over:
                take, defer, overload = kept, defer + over, True
        return take, defer, overload, barrier

    def _coalesce(self, scheduled: Sequence[StreamSensor], t: float):
        """Drain the scheduled sensors' queues into capacity-sized
        engine chunks, **grouped by tier** so same-tier chunks share one
        engine dispatch (the fused scatter stays batched).

        Returns (groups, chunk_copies, n_events, order): ``groups`` is
        a list of (tier, items) with ``items`` the pairs for one engine
        dispatch -- raw (slot, part) tuples on the device-ring path
        (``engine.push_staged`` stages them directly), (slot,
        EventStream) pairs for host-staged ``engine.push`` otherwise;
        ``chunk_copies`` are the host-side numpy twins for the action
        log, flat in dispatch order; ``order`` records the EDF schedule
        (slot, tier, deadline the sensor was served under)."""
        cap = self.engine.cfg.chunk_capacity
        h, w = self.engine.cfg.h, self.engine.cfg.w
        groups: List[Tuple[str, list]] = []
        group_of: Dict[str, list] = {}
        copies, order, n_events = [], [], 0
        for sensor in scheduled:
            deadline = sensor.next_deadline
            order.append((sensor.slot, sensor.qos.tier,
                          deadline if math.isfinite(deadline) else t))
            seg = sensor._drain()
            drained = 0 if seg is None else len(seg[0])
            sensor._note_scheduled(t, drained)
            if drained:
                sensor.energy_write_j += self.meter.write_energy_j(
                    self._sensor_mode(sensor), drained)
            if seg is None:
                continue
            items = group_of.get(sensor.qos.tier)
            if items is None:
                items = group_of[sensor.qos.tier] = []
                groups.append((sensor.qos.tier, items))
            x, y, tt, p = seg
            n_events += drained
            for lo in range(0, drained, cap):
                part = tuple(a[lo:lo + cap] for a in (x, y, tt, p))
                if self._use_ring:
                    items.append((sensor.slot, part))
                else:
                    stream = syn.EventStream(
                        x=part[0], y=part[1], t=part[2], p=part[3],
                        is_signal=np.ones(len(part[0]), bool), h=h, w=w,
                    )
                    items.append((sensor.slot, stream))
                copies.append((sensor.slot, part))
        return groups, copies, n_events, order

    def _step_specs(
        self, scheduled: Sequence[StreamSensor],
    ) -> Tuple[spec_mod.ReadoutSpec, ...]:
        """The ReadoutSpecs this step must serve: the runtime's primary
        spec plus any scheduled sensor's QoS override, deduped in a
        deterministic order (primary first, then first-scheduled
        order).  Sensors sharing a spec share one fused dispatch."""
        specs = [self.spec]
        for s in scheduled:
            if s.qos.spec is not None and s.qos.spec not in specs:
                specs.append(s.qos.spec)
        return tuple(specs)

    def step(self, t_deadline: float) -> StepRecord:
        """Run one deadline: schedule (EDF; priority preempts under
        overload), coalesce per tier, dispatch scatter + spec read(s),
        sync the *previous* read (one host sync).  Returns this step's
        record (its ``latency_s``/``digest`` fill at the next sync).
        With ``pipeline=False`` the sync is this step's own read."""
        self._maybe_shrink()
        scheduled, deferred, overload, barrier = self._schedule(t_deadline)
        for s in deferred:
            s.deferrals += s.queued
        groups, copies, n_events, order = self._coalesce(
            scheduled, t_deadline)
        specs = self._step_specs(scheduled)
        # the engine reads in epoch-rebased time, same basis the queued
        # stamps were rebased to at offer time (scheduling above stays
        # absolute); recorded as-rebased so the replay oracle consumes
        # the log verbatim
        t_read = t_deadline - (self.t_epoch or 0.0)
        noise_step = self.n_steps   # the analog-fidelity noise key input
        self._account_step_energy(t_deadline)
        wall0 = time.perf_counter()
        for _tier, items in groups:
            if self._use_ring:
                self.engine.push_staged(items)
            else:
                self.engine.push(items)
        products_by_spec = self.engine.read_many(specs, t_read,
                                                 noise_step=noise_step)
        products_list = [products_by_spec[sp] for sp in specs]
        done = None
        if self.engine.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.engine.device))
        record = StepRecord(
            t_read=float(t_read), n_events=n_events,
            n_chunks=len(copies),
            chunks=copies if self.cfg.record_chunks else None,
            wall_dispatch=wall0,
            order=order,
            deferred=[(s.slot, s.qos.tier, s.queued) for s in deferred],
            overload=overload,
            specs=specs,
            noise_step=noise_step,
            barrier=barrier,
        )
        # per-shard virtual clocks: shards that served work advance to
        # this deadline; a barrier re-syncs every shard (virtual time only)
        if barrier:
            for k in range(self._n_shards()):
                self._shard_clocks[k] = t_deadline
        else:
            for s in scheduled:
                self._shard_clocks[self._shard_of(s.slot)] = t_deadline
        self.log.append(("step", record))
        self.n_steps += 1
        cap = self.cfg.max_record_steps
        if cap is not None and self.n_steps - self.log_trimmed_steps > cap:
            for i, (kind, _) in enumerate(self.log):
                if kind == "step":   # trim the oldest step (chunks and all)
                    del self.log[i]
                    self.log_trimmed_steps += 1
                    break
        prev = self._inflight
        self._inflight = _Inflight(record, products_list, done)
        if self.cfg.pipeline:
            if prev is not None:
                self._sync(prev)
        else:
            self._sync(self._inflight)
            self._inflight = None
        return record

    def _sync(self, fl: _Inflight) -> None:
        """Wait for one step's reads (its CUDA event), note its latency
        (host time from dispatch to the event) and digest its products."""
        if fl.done is not None:
            fl.done.synchronize()
        lat = time.perf_counter() - fl.record.wall_dispatch
        fl.record.latency_s = lat
        if len(self.latencies_s) < self._max_lat:
            self.latencies_s.append(lat)
        for tier in {tier for _, tier, _ in fl.record.order}:
            samples = self.latencies_by_tier.setdefault(tier, [])
            if len(samples) < self._max_lat:
                samples.append(lat)
        fl.record.digest = digest_step(fl.products_list)

    def flush(self) -> Optional[Dict[str, torch.Tensor]]:
        """Sync the in-flight read (if any) and return its *primary*
        spec's products -- the tail of the pipeline, and the way tests
        grab the *current* step's output right after ``step``."""
        fl, self._inflight = self._inflight, None
        if fl is None:
            return None
        if np.isnan(fl.record.latency_s):   # not yet synced
            self._sync(fl)
        return fl.products_list[0]

    # -- telemetry ------------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        """Exact event accounting: retired (disconnected) + live sensors."""
        out = dict(self._retired)
        out["queued"] = 0
        for sensor in self.sensors.values():
            st = sensor.stats()
            for k in self._retired:
                out[k] += st[k]
            out["queued"] += st["queued"]
        return out

    def tier_counters(self) -> Dict[str, Dict[str, int]]:
        """Exact per-tier accounting (retired + live, migration-safe).

        Every tier satisfies the conservation identity::

            offered == ingested + dropped + refused + discarded + deferred

        where ``deferred`` is the still-queued remainder (events whose
        service is deferred to a later deadline) and ``deferrals``
        counts overload postponements cumulatively (telemetry, not part
        of the identity).  ``migrated`` is telemetry too: queued events
        re-attributed by live slot migration (migrate / elastic-shrink
        compaction), never double-counted in the identity.
        """
        out = {
            tier: dict(bucket, deferred=0)
            for tier, bucket in self._tier_retired.items()
        }
        for sensor in self.sensors.values():
            tier = sensor.qos.tier
            bucket = out.setdefault(
                tier, {k: 0 for k in TIER_KEYS} | {"deferred": 0})
            delta = sensor._tier_delta()
            for k in TIER_KEYS:
                bucket[k] += delta[k]
            bucket["deferred"] += sensor.queued
        return out

    def energy_j(self) -> Dict[str, float]:
        """Total modeled energy (joules) by component, retired + live."""
        out = dict(self._retired_energy)
        for sensor in self.sensors.values():
            for k in ENERGY_KEYS:
                out[k] += getattr(sensor, k)
        out["energy_total_j"] = sum(out[k] for k in ENERGY_KEYS)
        return out

    def tier_energy_uj(self) -> Dict[str, Dict[str, float]]:
        """Per-tier modeled energy in microjoules (retired + live,
        migration-safe like ``tier_counters``) -- the currency of the
        per-tier energy report."""
        acc = {tier: dict(b) for tier, b in self._tier_energy.items()}
        for sensor in self.sensors.values():
            bucket = acc.setdefault(sensor.qos.tier,
                                    {k: 0.0 for k in ENERGY_KEYS})
            for k, v in sensor._energy_delta().items():
                bucket[k] += v
        return {
            tier: {
                "write_uj": b["energy_write_j"] * 1e6,
                "read_uj": b["energy_read_j"] * 1e6,
                "leak_uj": b["energy_leak_j"] * 1e6,
                "total_uj": sum(b[k] for k in ENERGY_KEYS) * 1e6,
            }
            for tier, b in acc.items()
        }

    def tier_latencies_us(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Per-tier readout-latency percentiles (p50/p95/p99, in us)
        over the steps that served each tier, plus the tier's tightest
        SLO budget."""
        out = {}
        for tier, samples in self.latencies_by_tier.items():
            lat = np.asarray(samples, np.float64)
            slo = self._tier_slo.get(tier, math.inf)
            out[tier] = {
                "latency_p50_us": float(np.percentile(lat, 50) * 1e6)
                if lat.size else None,
                "latency_p95_us": float(np.percentile(lat, 95) * 1e6)
                if lat.size else None,
                "latency_p99_us": float(np.percentile(lat, 99) * 1e6)
                if lat.size else None,
                "slo_p99_us": slo * 1e6 if math.isfinite(slo) else None,
                "n_steps": int(lat.size),
            }
        return out

    def stats(self) -> dict:
        c = self.counters()
        lat = np.asarray(self.latencies_s, np.float64)
        return {
            **c,
            "n_steps": self.n_steps,
            "t_epoch": self.t_epoch,
            "log_trimmed_steps": self.log_trimmed_steps,
            "n_sensors": len(self.sensors),
            "policy": self.cfg.policy,
            "deadline_s": self.cfg.deadline_s,
            "step_chunk_budget": self.cfg.step_chunk_budget,
            "capacity_eps": self.cfg.capacity_eps,
            "capacity": self.engine.capacity,
            "elastic": self.cfg.elastic,
            "shard_budget": self.cfg.shard_budget,
            "shard_clocks": dict(self._shard_clocks),
            "drop_rate": c["dropped"] / c["offered"] if c["offered"] else 0.0,
            "tiers": self.tier_counters(),
            "tier_latencies_us": self.tier_latencies_us(),
            "energy": {
                **{k.replace("_j", "_uj"): v * 1e6
                   for k, v in self.energy_j().items()},
                "energy_per_event_nj": (
                    self.energy_j()["energy_total_j"] / c["ingested"] * 1e9
                    if c["ingested"] else None),
                "tiers": self.tier_energy_uj(),
            },
            "latency_p50_us": float(np.percentile(lat, 50) * 1e6) if lat.size else None,
            "latency_p95_us": float(np.percentile(lat, 95) * 1e6) if lat.size else None,
            "latency_p99_us": float(np.percentile(lat, 99) * 1e6) if lat.size else None,
        }
