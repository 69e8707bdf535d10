"""Deterministic virtual-clock replay: recorded/synthetic streams driven
through a ``StreamRuntime`` as sustained traffic, with a synchronous
bitwise oracle.

The port of ``repro.events.replay``, over one-device and sharded engine
factories alike.  The oracle holds the port against itself: a runtime's
digests are replayed on a fresh engine on the same devices (float decays
differ from the JAX package's by ULPs, so digests are never compared
across packages).

The harness owns *time*: it walks a virtual clock in readout deadlines,
delivers each feed's events in arrival granules (``arrival_substeps``
offers per deadline, so queue overflow and overload policies actually
bite between reads), applies sensor churn (mid-run attach/detach), and
calls ``runtime.step`` at every deadline.  Everything that decides which
events land where -- acceptance, drops, coalescing boundaries, chunk
membership -- is a pure function of event timestamps and the deadline
grid, so two replays of the same feeds are identical event-for-event.
Wall-clock numbers (throughput, latency percentiles) measure the real
compute; ``speed`` only adds pacing sleep (0 = as fast as possible,
1.0 = real time, 2.0 = twice real time) and can never change results.

The **oracle gate**: the runtime's action log holds host-side copies of
the exact coalesced chunks each step dispatched.  ``oracle_digests``
replays that log through a fresh engine with plain synchronous
``push`` + ``read`` + block per step; ``check_oracle`` asserts the
pipelined runtime produced bitwise-identical products at every deadline.
The digests cover every product of every spec a step served -- stage-1
head outputs (classifier logits, denoise labels) included, so a
model-serving tier is gated bitwise end to end, not just its surfaces.
Pipelining and coalescing may only move *when* work happens -- never what
it computes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.events import synthetic as syn
from repro_torch.serve import fidelity as fidelity_mod
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.stream import (
    DEFAULT_QOS, GESTURE_TIER, TELEMETRY_TIER, QoSClass, StepRecord,
    StreamConfig, StreamRuntime, digest_step,
)

__all__ = [
    "SensorFeed", "ReplayReport", "replay", "oracle_digests",
    "check_oracle", "mixed_scene_feeds", "fleet_scene_feeds",
]


@dataclasses.dataclass
class SensorFeed:
    """One sensor's traffic: an event stream plus its connection window.

    ``attach_t``/``detach_t`` are virtual times; ``detach_t=None`` keeps
    the sensor connected to the end.  Events outside the connection
    window are never offered (the sensor isn't there to produce them).
    ``qos`` is the QoS class the sensor connects under; ``migrate``
    optionally re-tiers it mid-run at a virtual time --
    ``(t, new_qos)`` applies ``runtime.set_tier`` at the first arrival
    granule past ``t`` (the churn+tier-migration schedule the oracle
    gate exercises).  ``move`` optionally *slot*-migrates it live:
    ``(t, dst)`` applies ``runtime.migrate`` at the first arrival
    granule past ``t`` (``dst=None`` lets the engine pick the lowest
    free slot).
    """

    stream: syn.EventStream
    attach_t: float = 0.0
    detach_t: Optional[float] = None
    name: str = ""
    qos: QoSClass = DEFAULT_QOS
    migrate: Optional[tuple] = None   # (t, QoSClass) -- tier migration
    move: Optional[tuple] = None      # (t, dst_slot|None) -- slot migration


@dataclasses.dataclass
class ReplayReport:
    """What a replay did and how fast -- drops are first-class results."""

    n_steps: int
    n_sensors: int
    policy: str
    deadline_s: float
    wall_s: float
    # event accounting (exact, deterministic)
    offered: int
    accepted: int
    ingested: int
    dropped: int          # overload-policy drops (evicted or refused-in)
    refused: int          # block policy: events held back by backpressure
    discarded: int        # queued events lost to mid-run detach
    unoffered: int        # block policy: producer backlog never offered
    drop_rate: float
    # performance (wall clock; varies run to run)
    events_per_sec: float
    latency_p50_us: Optional[float]
    latency_p95_us: Optional[float]
    latency_p99_us: Optional[float]
    # queued events re-attributed by live slot migration (telemetry,
    # like deferrals -- never part of the conservation identity)
    migrated: int = 0
    # per-tier accounting + latency percentiles (QoS; exact counters,
    # wall-clock latencies) -- see StreamRuntime.tier_counters /
    # tier_latencies_us for the key meanings
    tiers: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # modeled energy (hw.energy_model metering): totals in uJ plus the
    # per-tier split -- see StreamRuntime.stats()["energy"]
    energy_uj: Dict[str, float] = dataclasses.field(default_factory=dict)
    tier_energy_uj: Dict[str, dict] = dataclasses.field(default_factory=dict)
    # the bitwise trail: per-step product digests + the full action log
    digests: List[str] = dataclasses.field(default_factory=list, repr=False)
    log: list = dataclasses.field(default_factory=list, repr=False)

    def summary(self) -> str:
        lat = "  ".join(
            f"p{p}={v / 1e3:.2f}ms" if v is not None else f"p{p}=n/a"
            for p, v in ((50, self.latency_p50_us),
                         (95, self.latency_p95_us),
                         (99, self.latency_p99_us))
        )
        lines = [
            f"replay: {self.n_steps} deadlines x {self.deadline_s * 1e3:.0f}ms"
            f" over {self.n_sensors} sensors ({self.policy})",
            f"  events: offered {self.offered}  ingested {self.ingested}"
            f"  dropped {self.dropped} ({self.drop_rate:.1%})"
            f"  discarded {self.discarded}  migrated {self.migrated}"
            f"  backlog {self.unoffered}",
            f"  throughput {self.events_per_sec / 1e6:.3f} Meps"
            f"  readout latency {lat}",
        ]
        for tier, row in sorted(self.tiers.items()):
            p99 = row.get("latency_p99_us")
            p99s = f"{p99 / 1e3:.2f}ms" if p99 is not None else "n/a"
            slo = row.get("slo_p99_us")
            slos = f"/{slo / 1e3:.0f}ms SLO" if slo is not None else ""
            energy = self.tier_energy_uj.get(tier)
            ej = (f"  energy {energy['total_uj']:.2f}uJ"
                  if energy is not None else "")
            lines.append(
                f"  tier {tier}: offered {row['offered']}"
                f"  ingested {row['ingested']}  dropped {row['dropped']}"
                f"  deferred {row['deferred']}  p99 {p99s}{slos}{ej}"
            )
        if self.energy_uj:
            per_ev = self.energy_uj.get("energy_per_event_nj")
            pe = f"  ({per_ev:.3f} nJ/event)" if per_ev else ""
            lines.append(
                f"  modeled energy: write "
                f"{self.energy_uj['energy_write_uj']:.2f}uJ  read "
                f"{self.energy_uj['energy_read_uj']:.2f}uJ  leak "
                f"{self.energy_uj['energy_leak_uj']:.2f}uJ{pe}"
            )
        return "\n".join(lines)


def replay(
    engine,
    feeds: Sequence[SensorFeed],
    cfg: StreamConfig = StreamConfig(),
    spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
    *,
    speed: float = 0.0,
    arrival_substeps: int = 4,
    t_end: Optional[float] = None,
) -> ReplayReport:
    """Drive ``feeds`` through a fresh ``StreamRuntime`` over ``engine``.

    Returns the report; its ``log`` feeds ``check_oracle``.  ``speed``
    paces the deadline grid against the wall clock (0 = no pacing);
    ``arrival_substeps`` is how many offer rounds happen per deadline
    (more rounds = finer-grained arrival, same totals).
    """
    if arrival_substeps < 1:
        raise ValueError(f"arrival_substeps must be >= 1, "
                         f"got {arrival_substeps}")
    runtime = StreamRuntime(engine, cfg, spec)
    d = cfg.deadline_s

    if t_end is None:
        t_end = 0.0
        for f in feeds:
            if f.stream.n:
                t_end = max(t_end, float(f.stream.t[-1]))
            if f.detach_t is not None:
                t_end = max(t_end, f.detach_t)
            t_end = max(t_end, f.attach_t)
    n_steps = int(np.floor(t_end / d)) + 1

    state = [
        {"ptr": 0, "sensor": None, "done": False, "migrated": False,
         "moved": False}
        for _ in feeds
    ]

    def churn(now: float) -> None:
        for f, st in zip(feeds, state):
            if (st["sensor"] is not None and f.detach_t is not None
                    and f.detach_t <= now):
                runtime.disconnect(st["sensor"])
                st["sensor"], st["done"] = None, True
            if (st["sensor"] is None and not st["done"]
                    and f.attach_t <= now):
                st["sensor"] = runtime.connect(f.qos)
            if (st["sensor"] is not None and not st["migrated"]
                    and f.migrate is not None and f.migrate[0] <= now):
                runtime.set_tier(st["sensor"], f.migrate[1])
                st["migrated"] = True
            if (st["sensor"] is not None and not st["moved"]
                    and f.move is not None and f.move[0] <= now):
                runtime.migrate(st["sensor"], f.move[1])
                st["moved"] = True

    def offer_until(now: float) -> None:
        for f, st in zip(feeds, state):
            if st["sensor"] is None:
                continue
            t = f.stream.t
            hi = int(np.searchsorted(t, np.float32(now), side="left"))
            if hi <= st["ptr"]:
                continue
            sl = slice(st["ptr"], hi)
            consumed = st["sensor"].offer(
                (f.stream.x[sl], f.stream.y[sl], t[sl], f.stream.p[sl])
            )
            st["ptr"] += consumed

    wall0 = time.perf_counter()
    for k in range(1, n_steps + 1):
        t_k = k * d
        for j in range(1, arrival_substeps + 1):
            g = (k - 1) * d + j * d / arrival_substeps
            churn(g - d / arrival_substeps)
            offer_until(g)
        if speed > 0:
            lag = wall0 + t_k / speed - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        runtime.step(t_k)
    runtime.flush()
    wall = time.perf_counter() - wall0

    st = runtime.stats()
    unoffered = sum(
        f.stream.n - s["ptr"] for f, s in zip(feeds, state)
        if s["sensor"] is not None or not s["done"]
    )
    # events actually handed over by producers (consumed by offer()); the
    # runtime's own "offered" counter is attempt-level, which double-counts
    # the block policy's re-offers of refused events
    offered = sum(s["ptr"] for s in state)
    digests = [e.digest for kind, e in runtime.log if kind == "step"]
    tiers: Dict[str, dict] = {
        tier: dict(row) for tier, row in runtime.tier_counters().items()
    }
    for tier, lat_row in runtime.tier_latencies_us().items():
        tiers.setdefault(tier, {}).update(lat_row)
    return ReplayReport(
        n_steps=runtime.n_steps, n_sensors=len(feeds), policy=cfg.policy,
        deadline_s=d, wall_s=wall,
        offered=offered, accepted=st["accepted"],
        ingested=st["ingested"], dropped=st["dropped"],
        refused=st["refused"], discarded=st["discarded"],
        unoffered=unoffered, migrated=st["migrated"],
        drop_rate=st["dropped"] / offered if offered else 0.0,
        events_per_sec=st["ingested"] / wall if wall > 0 else 0.0,
        latency_p50_us=st["latency_p50_us"],
        latency_p95_us=st["latency_p95_us"],
        latency_p99_us=st["latency_p99_us"],
        tiers=tiers,
        energy_uj={k: v for k, v in st["energy"].items() if k != "tiers"},
        tier_energy_uj=dict(st["energy"]["tiers"]),
        digests=digests, log=list(runtime.log),
    )


def oracle_digests(
    engine,
    log: Sequence,
    spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
) -> List[str]:
    """Synchronous oracle: replay a runtime's action log on a *fresh*
    engine -- plain ``push`` + ``read`` + host sync per step, no queues,
    no pipelining -- and return the per-step product digests.

    Slot assignment must reproduce exactly (attach order is part of the
    log), so each recorded chunk lands in the recorded slot.
    """
    h, w = engine.cfg.h, engine.cfg.w
    sessions: Dict[int, object] = {}
    out: List[str] = []
    for kind, entry in log:
        if kind == "attach":
            # entry is (slot, QoSClass); pre-QoS logs recorded bare slots
            slot, qos = entry if isinstance(entry, tuple) else (entry, None)
            s = engine.attach(qos=qos)
            if s.slot != slot:
                raise AssertionError(
                    f"oracle slot assignment diverged: got {s.slot}, "
                    f"log says {slot}")
            sessions[slot] = s
        elif kind == "set_tier":
            pass   # scheduling metadata: changes *when* work happens, not what
        elif kind == "detach":
            sessions.pop(entry).detach()
        elif kind == "grow":
            # entry is the new capacity; the oracle must land on it
            got = engine.grow(entry)
            if got != entry:
                raise AssertionError(f"oracle capacity diverged: grew to "
                                     f"{got}, log says {entry}")
        elif kind == "shrink":
            # entry is (new_capacity, moves); the oracle's compaction is
            # derived from its own bookkeeping and must reproduce the
            # recorded (src, dst) moves exactly
            capacity, moves = entry
            got = engine.shrink(capacity)
            if [tuple(m) for m in got] != [tuple(m) for m in moves]:
                raise AssertionError(f"oracle shrink compaction diverged: "
                                     f"{got} vs log {moves}")
            for src, dst in moves:
                if src in sessions:
                    sessions[dst] = sessions.pop(src)
        elif kind == "migrate":
            # the (src, dst) the runtime performed, replayed verbatim:
            # the least-loaded-shard choice is never re-derived
            src, dst = entry
            engine.migrate(src, dst)
            sessions[dst] = sessions.pop(src)
        elif kind != "step":
            raise ValueError(f"unknown action-log entry {kind!r}")
        else:
            rec: StepRecord = entry
            if rec.chunks is None:
                raise ValueError(
                    "action log has no chunk copies (record_chunks=False); "
                    "the oracle has nothing to replay"
                )
            if rec.chunks:
                items = []
                for slot, (x, y, t, p) in rec.chunks:
                    stream = syn.EventStream(
                        x=x, y=y, t=t, p=p,
                        is_signal=np.ones(len(x), bool), h=h, w=w,
                    )
                    items.append((slot, stream))
                engine.push(items)
            # read the specs the step recorded (QoS steps may serve
            # several); pre-QoS logs recorded none -> the caller's spec
            specs = rec.specs or (spec,)
            # analog-fidelity specs re-fold the recorded noise key (the
            # step index + the oracle's own attach-replayed slot epochs)
            # so the replay reproduces every per-cell draw bitwise
            products_list = [engine.read(sp, rec.t_read,
                                         noise_step=rec.noise_step)
                             for sp in specs]
            out.append(digest_step(products_list))   # copies, so syncs
    return out


def check_oracle(
    report: ReplayReport,
    make_engine: Callable[[], object],
    spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
) -> int:
    """Assert the replay's per-deadline products are bitwise-equal to the
    synchronous oracle's; returns the number of steps compared."""
    if len(report.digests) < report.n_steps:
        raise ValueError(
            f"action log holds {len(report.digests)} of {report.n_steps} "
            "steps (StreamConfig.max_record_steps trimmed it); the oracle "
            "cannot replay from t=0 -- raise the cap (or None) for "
            "oracle-gated replays"
        )
    want = oracle_digests(make_engine(), report.log, spec)
    if len(want) != len(report.digests):
        raise AssertionError(
            f"oracle replayed {len(want)} steps, runtime recorded "
            f"{len(report.digests)}")
    for i, (got, exp) in enumerate(zip(report.digests, want)):
        if got != exp:
            raise AssertionError(
                f"streamed products != synchronous oracle at deadline {i} "
                f"(t={report.deadline_s * (i + 1):.4f}s): pipelining/"
                "coalescing changed the bits")
    return len(want)


def mixed_scene_feeds(
    h: int,
    w: int,
    duration: float,
    n_sensors: int,
    seed: int = 0,
    *,
    noise_hz: float = 5.0,
    churn: bool = False,
    tiered: bool = False,
) -> List[SensorFeed]:
    """Mixed-rate synthetic traffic: the three scene families at their
    naturally different event rates (driving ≫ hotel_bar > glyph), one
    per sensor round-robin.  With ``churn=True`` every third sensor
    connects late and every fourth disconnects early -- the mid-run
    attach/detach pattern the replay harness exists to exercise.  With
    ``tiered=True`` the high-rate scenes (driving, hotel_bar) connect
    as ``telemetry`` and the sparse glyph sensors as ``gesture`` -- the
    paper's canonical priority split -- and, when churn is also on,
    every sensor with ``i % 5 == 1`` migrates to the *other* tier at
    mid-run (the churn+tier-migration schedule the oracle digest gate
    covers).
    """
    feeds: List[SensorFeed] = []
    for i in range(n_sensors):
        rng = np.random.default_rng((seed, i))
        kind = ("driving", "hotel_bar", "glyph")[i % 3]
        if kind == "driving":
            scene = syn.driving_scene(h, w, rng)
        elif kind == "hotel_bar":
            scene = syn.hotel_bar_scene(h, w, rng)
        else:
            scene = syn.moving_glyph_scene(h, w, i % 10, rng)
        stream = syn.dvs_from_intensity(
            scene, h, w, duration, rng, noise_hz=noise_hz, fps=500.0
        )
        attach_t = duration * 0.25 if churn and i % 3 == 0 and i else 0.0
        detach_t = duration * 0.75 if churn and i % 4 == 3 else None
        if attach_t:
            stream = stream.window(attach_t, np.inf)
        qos = DEFAULT_QOS
        migrate = None
        if tiered:
            qos = GESTURE_TIER if kind == "glyph" else TELEMETRY_TIER
            if churn and i % 5 == 1:
                other = (TELEMETRY_TIER if qos is GESTURE_TIER
                         else GESTURE_TIER)
                migrate = (duration * 0.5, other)
        feeds.append(SensorFeed(stream=stream, attach_t=attach_t,
                                detach_t=detach_t, name=f"{kind}-{i}",
                                qos=qos, migrate=migrate))
    return feeds


def fleet_scene_feeds(
    h: int,
    w: int,
    duration: float,
    n_sensors: int,
    seed: int = 0,
    *,
    noise_hz: float = 5.0,
    n_moves: int = 3,
) -> List[SensorFeed]:
    """Fleet churn traffic for the elastic + migration gate.

    Sensors attach in three staggered waves (t = 0, 0.3 and 0.45 of the
    duration) so an elastic runtime over a small pool grows at least
    twice; late-wave non-moving sensors detach at 0.7 duration so
    occupancy falls back under the shrink watermark (one auto-shrink
    with live-slot compaction).  The first ``n_moves`` sensors
    slot-migrate live at 0.6 duration (engine-picked destinations);
    sparse glyph sensors ride an **analog, head-bearing** gesture tier
    (analog_3d surface + stcf + denoise head), so at least one migration
    moves a slot with a non-zero noise generation and stage-1 head
    products.  Requires a ``mode="edram"`` engine.
    """
    if not 3 <= n_moves <= n_sensors:
        raise ValueError(f"n_moves must be in [3, n_sensors = {n_sensors}], "
                         f"got {n_moves}")
    analog_head = spec_mod.ReadoutSpec(
        surface=spec_mod.surface(fidelity=fidelity_mod.analog_3d()),
        stcf=spec_mod.stcf(
            decay=spec_mod.surface(fidelity=fidelity_mod.analog_3d())),
        labels=spec_mod.denoise(input="stcf"),
    )
    gesture = dataclasses.replace(GESTURE_TIER, spec=analog_head)
    feeds: List[SensorFeed] = []
    for i in range(n_sensors):
        rng = np.random.default_rng((seed, i))
        kind = ("driving", "hotel_bar", "glyph")[i % 3]
        if kind == "driving":
            scene = syn.driving_scene(h, w, rng)
        elif kind == "hotel_bar":
            scene = syn.hotel_bar_scene(h, w, rng)
        else:
            scene = syn.moving_glyph_scene(h, w, i % 10, rng)
        stream = syn.dvs_from_intensity(
            scene, h, w, duration, rng, noise_hz=noise_hz, fps=500.0
        )
        wave = i % 3
        attach_t = (0.0, duration * 0.3, duration * 0.45)[wave]
        detach_t = duration * 0.7 if wave == 2 and i >= n_moves else None
        if attach_t:
            stream = stream.window(attach_t, np.inf)
        qos = gesture if kind == "glyph" else TELEMETRY_TIER
        move = (duration * 0.6, None) if i < n_moves else None
        feeds.append(SensorFeed(stream=stream, attach_t=attach_t,
                                detach_t=detach_t, name=f"fleet-{kind}-{i}",
                                qos=qos, move=move))
    return feeds
