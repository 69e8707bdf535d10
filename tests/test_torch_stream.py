"""The port's streaming runtime and replay harness (``repro_torch.serve.
stream``, ``repro_torch.events.replay``) on the CPU.

Two kinds of test.  The reference's single-device runtime tests
(``tests/test_stream_runtime.py``), ported case for case onto the port's
CPU engine: everything runs under the virtual clock, so the assertions
are exact (drop counts, chunk sizes, bitwise surfaces, the port's own
oracle digests).  And the cross-package gates: on the same tiered,
churned, overloaded feeds with an analog gesture tier, the port's counters,
tier counters, step records and modeled energy equal the JAX runtime's
exactly, while digests are held against the port's own synchronous
oracle (float decays differ across packages by ULPs, so digests never
cross).  The reference's single-device fleet cases (elastic pools, live
migration, the shard budget at one shard) run on both packages side by
side: action logs, counters and tier counters (``migrated`` included)
equal across packages, each package's digests equal to its own oracle's.
The multi-device pool waits for its slice; there ``--mesh N`` must raise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.events import replay as rp
from repro_torch.events import synthetic as syn
from repro_torch.serve import fidelity as fm
from repro_torch.serve import spec as rs
from repro_torch.serve import stream
from repro_torch.serve.stream import StreamConfig, StreamRuntime
from repro_torch.serve.ts_engine import TSEngineConfig, TimeSurfaceEngine

H, W = 24, 32
CAP = 64


def make_cfg(n_slots=4):
    return TSEngineConfig(h=H, w=W, n_slots=n_slots, chunk_capacity=CAP,
                          block=(8, 16))


def make_engine(n_slots=4):
    return TimeSurfaceEngine(make_cfg(n_slots), device="cpu")


def cpu_engine(cfg):
    return lambda: TimeSurfaceEngine(cfg, device="cpu")


def events(rng, n, t_lo=0.0, t_hi=0.06):
    t = np.sort(t_lo + rng.random(n).astype(np.float32) * (t_hi - t_lo))
    return syn.EventStream(
        x=rng.integers(0, W, n).astype(np.int32),
        y=rng.integers(0, H, n).astype(np.int32),
        t=t.astype(np.float32),
        p=rng.integers(0, 2, n).astype(np.int32),
        is_signal=np.ones(n, bool), h=H, w=W,
    )


def surface_of(engine_events, t_read):
    """Fresh-engine oracle: push ``engine_events`` on slot 0, read."""
    eng = make_engine()
    cam = eng.attach()
    if engine_events.n:
        cam.push(engine_events)
    return np.asarray(eng.read(rs.SURFACE_SPEC, t_read)["surface"])


# ---------------------------------------------------------------------------
# coalescing + deadlines
# ---------------------------------------------------------------------------

def test_coalescing_boundaries():
    """A queue drains into ceil(n/capacity) chunks: full, full, remainder."""
    rt = StreamRuntime(make_engine(), StreamConfig(queue_capacity=1 << 12))
    cam = rt.connect()
    ev = events(np.random.default_rng(0), 2 * CAP + 5)
    assert cam.offer(ev) == 2 * CAP + 5
    rec = rt.step(0.06)
    assert rec.n_events == 2 * CAP + 5
    assert rec.n_chunks == 3
    sizes = [len(seg[0]) for _, seg in rec.chunks]
    assert sizes == [CAP, CAP, 5]
    assert all(slot == cam.slot for slot, _ in rec.chunks)
    got = rt.flush()["surface"]
    assert (np.asarray(got)[cam.slot] == surface_of(ev, 0.06)[0]).all()
    assert cam.queued == 0 and cam.ingested == 2 * CAP + 5


def test_deadline_alignment():
    """Each deadline's chunks hold exactly the events of its window."""
    rng = np.random.default_rng(1)
    stream = events(rng, 300, t_lo=0.0, t_hi=0.03)
    eng = make_engine()
    report = rp.replay(
        eng, [rp.SensorFeed(stream=stream)],
        StreamConfig(policy="block", queue_capacity=1 << 12,
                     deadline_s=0.01),
        arrival_substeps=4,
    )
    d = 0.01
    per_step = [e.n_events for kind, e in report.log if kind == "step"]
    want = [
        int(((stream.t >= np.float32((k - 1) * d))
             & (stream.t < np.float32(k * d))).sum())
        for k in range(1, len(per_step) + 1)
    ]
    assert per_step == want
    assert sum(per_step) == stream.n
    assert report.ingested == stream.n and report.dropped == 0


def test_step_reads_at_deadline_even_when_idle():
    """Deadlines with no traffic still produce a frame (and a digest)."""
    rt = StreamRuntime(make_engine(), StreamConfig())
    rt.connect()
    rec = rt.step(0.02)
    assert rec.n_events == 0 and rec.n_chunks == 0
    assert rt.flush() is not None
    assert rec.digest  # filled at sync


# ---------------------------------------------------------------------------
# overload policies: exact drop accounting
# ---------------------------------------------------------------------------

def test_policy_block_backpressure():
    rt = StreamRuntime(
        make_engine(), StreamConfig(policy="block", queue_capacity=10))
    cam = rt.connect()
    ev = events(np.random.default_rng(2), 25)
    assert cam.offer(ev) == 10          # only what fits is consumed
    assert cam.queued == 10 and cam.refused == 15 and cam.dropped == 0
    assert cam.offer(ev.take(slice(10, 25))) == 0   # full: nothing enters
    rt.step(0.06)
    assert cam.queued == 0
    assert cam.offer(ev.take(slice(10, 25))) == 10  # drained: room again
    rt.step(0.07)
    rt.flush()
    assert cam.ingested == 20 and cam.dropped == 0
    # the engine saw exactly the first 20 events, in order
    got = np.asarray(rt.engine.state.surfaces.n_events)[cam.slot]
    assert got == 20


def test_policy_drop_newest():
    rt = StreamRuntime(
        make_engine(), StreamConfig(policy="drop_newest", queue_capacity=10))
    cam = rt.connect()
    ev = events(np.random.default_rng(3), 25)
    assert cam.offer(ev) == 25          # everything consumed...
    assert cam.accepted == 10 and cam.dropped == 15   # ...overflow discarded
    rt.step(0.06)
    got = rt.flush()["surface"]
    want = surface_of(ev.take(slice(0, 10)), 0.06)    # the OLDEST survive
    assert (np.asarray(got)[cam.slot] == want[0]).all()


def test_policy_drop_oldest():
    rt = StreamRuntime(
        make_engine(), StreamConfig(policy="drop_oldest", queue_capacity=10))
    cam = rt.connect()
    ev = events(np.random.default_rng(4), 25)
    assert cam.offer(ev) == 25
    assert cam.accepted == 25 and cam.dropped == 15 and cam.queued == 10
    rt.step(0.06)
    got = rt.flush()["surface"]
    want = surface_of(ev.take(slice(15, 25)), 0.06)   # the NEWEST survive
    assert (np.asarray(got)[cam.slot] == want[0]).all()


def test_drop_oldest_eviction_spans_segments():
    """Eviction walks whole and partial queued segments correctly."""
    rt = StreamRuntime(
        make_engine(), StreamConfig(policy="drop_oldest", queue_capacity=8))
    cam = rt.connect()
    rng = np.random.default_rng(5)
    ev = events(rng, 12)
    for lo in (0, 3, 6, 9):             # four 3-event offers
        cam.offer(ev.take(slice(lo, lo + 3)))
    assert cam.queued == 8 and cam.dropped == 4
    rt.step(0.06)
    got = rt.flush()["surface"]
    want = surface_of(ev.take(slice(4, 12)), 0.06)    # last 8 survive
    assert (np.asarray(got)[cam.slot] == want[0]).all()


def test_counter_conservation():
    """accepted == ingested + dropped-evictions + discarded + queued."""
    rt = StreamRuntime(
        make_engine(), StreamConfig(policy="drop_oldest", queue_capacity=32))
    cams = [rt.connect() for _ in range(3)]
    rng = np.random.default_rng(6)
    for i, cam in enumerate(cams):
        cam.offer(events(rng, 50 + 20 * i))
    rt.step(0.06)
    cams[0].offer(events(rng, 40))
    rt.disconnect(cams[0])              # queued events -> discarded
    rt.step(0.07)
    rt.flush()
    c = rt.counters()
    assert c["accepted"] == (c["ingested"] + c["dropped"]
                             + c["discarded"] + c["queued"])
    assert c["discarded"] == 32         # full queue at disconnect


# ---------------------------------------------------------------------------
# churn + lifecycle
# ---------------------------------------------------------------------------

def test_churn_midrun_replay_oracle():
    feeds = rp.mixed_scene_feeds(H, W, 0.06, 4, seed=1, churn=True)
    assert any(f.attach_t > 0 for f in feeds)
    assert any(f.detach_t is not None for f in feeds)
    cfg = make_cfg()
    report = rp.replay(
        TimeSurfaceEngine(cfg, device="cpu"), feeds,
        StreamConfig(policy="drop_oldest", queue_capacity=256,
                     deadline_s=0.01),
    )
    n = rp.check_oracle(report, cpu_engine(cfg))
    assert n == report.n_steps > 0
    kinds = [k for k, _ in report.log]
    assert kinds.count("attach") == 4 and kinds.count("detach") == 1


def test_disconnect_frees_slot_and_dead_sensor_raises():
    rt = StreamRuntime(make_engine(n_slots=2), StreamConfig())
    a, b = rt.connect(), rt.connect()
    with pytest.raises(RuntimeError):
        rt.connect()                    # pool full
    slot_a = a.slot
    rt.disconnect(a)
    with pytest.raises(RuntimeError):
        a.offer(events(np.random.default_rng(0), 4))
    with pytest.raises(RuntimeError):
        rt.disconnect(a)
    c = rt.connect()                    # slot reused
    assert c.slot == slot_a
    rt.disconnect(b)
    rt.disconnect(c)


# ---------------------------------------------------------------------------
# pipelining + determinism + oracle
# ---------------------------------------------------------------------------

def _replay_once(pipeline_on: bool, policy="block"):
    feeds = rp.mixed_scene_feeds(H, W, 0.05, 3, seed=2)
    cfg = make_cfg()
    return rp.replay(
        TimeSurfaceEngine(cfg, device="cpu"), feeds,
        StreamConfig(policy=policy, queue_capacity=1 << 14,
                     deadline_s=0.01, pipeline=pipeline_on),
    )


def test_pipelined_bitwise_equals_synchronous():
    """Pipelining moves *when* syncs happen, never what is computed."""
    a = _replay_once(True)
    b = _replay_once(False)
    assert a.digests == b.digests
    assert (a.ingested, a.dropped, a.n_steps) == (
        b.ingested, b.dropped, b.n_steps)


def test_replay_deterministic():
    a = _replay_once(True, policy="drop_oldest")
    b = _replay_once(True, policy="drop_oldest")
    assert a.digests == b.digests
    assert (a.offered, a.accepted, a.ingested, a.dropped) == (
        b.offered, b.accepted, b.ingested, b.dropped)


def test_replay_report_fields():
    report = _replay_once(True)
    assert report.n_steps == len(report.digests) > 0
    assert report.events_per_sec > 0 and report.wall_s > 0
    assert report.latency_p50_us is not None
    assert report.latency_p50_us <= report.latency_p99_us
    assert report.drop_rate == 0.0      # block + huge queue
    assert "Meps" in report.summary()


def test_offer_copies_producer_buffers():
    """Producers may reuse/mutate their buffers right after offer()."""
    rt = StreamRuntime(make_engine(), StreamConfig())
    cam = rt.connect()
    ev = events(np.random.default_rng(10), 30)
    x, y, t, p = ev.x.copy(), ev.y.copy(), ev.t.copy(), ev.p.copy()
    cam.offer((x, y, t, p))
    x[:], y[:], t[:], p[:] = 0, 0, 9.9, 0    # producer reuses its buffer
    rec = rt.step(0.06)
    got = rt.flush()["surface"]
    assert (np.asarray(got)[cam.slot] == surface_of(ev, 0.06)[0]).all()
    # the action log must hold the original values too (oracle input)
    _, (lx, ly, lt, lp) = rec.chunks[0]
    np.testing.assert_array_equal(lt, ev.t)


def test_log_trimming_bounds_retention():
    """Beyond max_record_steps the oldest step entries are trimmed (and
    counted); a trimmed replay refuses the oracle gate with a clear
    error instead of silently diverging."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(max_record_steps=3, queue_capacity=1 << 12))
    cam = rt.connect()
    rng = np.random.default_rng(9)
    for k in range(6):
        cam.offer(events(rng, 10))
        rt.step(0.01 * (k + 1))
    rt.flush()
    steps = [e for kind, e in rt.log if kind == "step"]
    assert len(steps) == 3 and rt.log_trimmed_steps == 3
    assert rt.n_steps == 6 and rt.stats()["log_trimmed_steps"] == 3
    assert any(kind == "attach" for kind, _ in rt.log)   # lifecycle kept

    cfg = make_cfg()
    report = rp.replay(
        TimeSurfaceEngine(cfg, device="cpu"), rp.mixed_scene_feeds(H, W, 0.04, 2, seed=9),
        StreamConfig(queue_capacity=1 << 14, deadline_s=0.01,
                     max_record_steps=2),
    )
    with pytest.raises(ValueError, match="max_record_steps"):
        rp.check_oracle(report, cpu_engine(cfg))


def test_paced_replay_same_results():
    """Wall-clock pacing (speed > 0) slows the loop, never the results."""
    import time

    feeds = rp.mixed_scene_feeds(H, W, 0.04, 2, seed=8)
    cfg = make_cfg()
    scfg = StreamConfig(queue_capacity=1 << 14, deadline_s=0.01)
    fast = rp.replay(TimeSurfaceEngine(cfg, device="cpu"), feeds, scfg)
    t0 = time.perf_counter()
    paced = rp.replay(TimeSurfaceEngine(cfg, device="cpu"),
                      rp.mixed_scene_feeds(H, W, 0.04, 2, seed=8),
                      scfg, speed=2.0)   # 2x real time: >= ~20ms of pacing
    wall = time.perf_counter() - t0
    assert paced.digests == fast.digests
    assert (paced.ingested, paced.dropped) == (fast.ingested, fast.dropped)
    assert wall >= 0.04 / 2.0 * 0.5      # pacing actually slept


def test_oracle_needs_recorded_chunks():
    feeds = rp.mixed_scene_feeds(H, W, 0.03, 2, seed=3)
    cfg = make_cfg()
    report = rp.replay(
        TimeSurfaceEngine(cfg, device="cpu"), feeds,
        StreamConfig(queue_capacity=1 << 14, deadline_s=0.01,
                     record_chunks=False),
    )
    with pytest.raises(ValueError, match="record_chunks"):
        rp.check_oracle(report, cpu_engine(cfg))


def test_offer_accepts_aer_words_and_tuples():
    from repro_torch.events import aer

    rt = StreamRuntime(make_engine(), StreamConfig())
    cam = rt.connect()
    ev = events(np.random.default_rng(7), 20)
    assert cam.offer(aer.pack(ev)) == 20            # packed uint64 words
    assert cam.offer((ev.x, ev.y, ev.t, ev.p)) == 20  # raw arrays
    rec = rt.step(0.06)
    rt.flush()
    assert rec.n_events == 40


def test_composed_spec_stream():
    """The runtime serves composed specs; oracle gate covers every product."""
    spec = rs.ReadoutSpec(surface=rs.surface(), stcf=rs.stcf(),
                          count=rs.count(4))
    cfg = TSEngineConfig(h=H, w=W, n_slots=2, chunk_capacity=CAP,
                         block=(8, 16), specs=(spec,))
    feeds = rp.mixed_scene_feeds(H, W, 0.04, 2, seed=4)
    report = rp.replay(
        TimeSurfaceEngine(cfg, device="cpu"), feeds,
        StreamConfig(queue_capacity=1 << 14, deadline_s=0.01),
        spec,
    )
    rp.check_oracle(report, cpu_engine(cfg), spec)


# ---------------------------------------------------------------------------
# QoS: per-sensor deadline streams, EDF, tiers, admission, flow control
# ---------------------------------------------------------------------------

def _tier_identity(row):
    return (row["ingested"] + row["dropped"] + row["refused"]
            + row["discarded"] + row["deferred"])


def test_qos_per_sensor_periods():
    """A sensor's deadline stream is its own: a 2x-period sensor is
    served on every other runtime deadline, the default-period one on
    every deadline."""
    rt = StreamRuntime(make_engine(), StreamConfig(deadline_s=0.01))
    fast = rt.connect()
    slow = rt.connect(stream.QoSClass(tier="slow", period_s=0.02))
    rng = np.random.default_rng(7)
    served = {fast.slot: 0, slow.slot: 0}
    for k in range(1, 5):
        fast.offer(events(rng, 8, t_lo=(k - 1) * 0.01, t_hi=k * 0.01))
        slow.offer(events(rng, 8, t_lo=(k - 1) * 0.01, t_hi=k * 0.01))
        rec = rt.step(k * 0.01)
        for slot, _tier, _d in rec.order:
            served[slot] += 1
    rt.flush()
    assert served[fast.slot] == 4
    # first step always serves (initial deadline -inf), then the sensor's
    # own stream takes over: deadlines at 0.02 and 0.04 only
    assert served[slow.slot] == 3
    assert slow.queued == 0             # each service drains the backlog


def test_qos_edf_order_determinism():
    """The recorded schedule is EDF (deadline, priority, slot) — ties
    break by priority then slot, and two identical runs record the
    identical order."""
    def run():
        rt = StreamRuntime(make_engine(), StreamConfig(deadline_s=0.01))
        lo = rt.connect(stream.QoSClass(tier="lo", priority=2))
        hi = rt.connect(stream.QoSClass(tier="hi", priority=0))
        mid = rt.connect(stream.QoSClass(tier="mid", priority=1))
        rng = np.random.default_rng(8)
        for cam in (lo, hi, mid):
            cam.offer(events(rng, 16, t_hi=0.01))
        rec = rt.step(0.01)
        rt.flush()
        return rec.order, (lo.slot, hi.slot, mid.slot)

    order, (lo_s, hi_s, mid_s) = run()
    # all deadlines equal (-inf at first step): priority decides
    assert [s for s, _, _ in order] == [hi_s, mid_s, lo_s]
    assert [t for _, t, _ in order] == ["hi", "mid", "lo"]
    order2, _ = run()
    assert order == order2

    # distinct deadlines dominate priority: after the first step a
    # short-period low-priority sensor is due before a long-period
    # high-priority one
    rt = StreamRuntime(make_engine(), StreamConfig(deadline_s=0.005))
    slow_hi = rt.connect(stream.QoSClass(tier="a", priority=0, period_s=0.02))
    fast_lo = rt.connect(stream.QoSClass(tier="b", priority=2, period_s=0.005))
    rng = np.random.default_rng(9)
    rt.step(0.005)                       # both served (deadline -inf)
    for cam in (slow_hi, fast_lo):
        cam.offer(events(rng, 8, t_hi=0.02))
    rec = rt.step(0.02)                  # both due: 0.01 (b) < 0.02 (a)... no:
    rt.flush()
    # fast_lo's next deadline after t=0.005 is 0.01, slow_hi's is 0.02 —
    # at t=0.02 both are due but EDF puts the EARLIER deadline first
    # despite its lower priority
    assert [s for s, _, _ in rec.order] == [fast_lo.slot, slow_hi.slot]


def test_qos_overload_priority_preempts_and_defers():
    """Under a step chunk budget, priority preempts EDF: gesture is
    served, telemetry deferred (deadline unmoved, counted, listed)."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(deadline_s=0.01, queue_capacity=1 << 12,
                     step_chunk_budget=2),
    )
    tel = rt.connect(stream.TELEMETRY_TIER)
    ges = rt.connect(stream.GESTURE_TIER)
    rng = np.random.default_rng(10)
    tel.offer(events(rng, 2 * CAP, t_hi=0.01))   # needs 2 chunks
    ges.offer(events(rng, CAP, t_hi=0.01))       # needs 1 chunk
    rec = rt.step(0.01)
    rt.flush()
    assert rec.overload
    assert [t for _, t, _ in rec.order] == ["gesture"]
    assert rec.deferred == [(tel.slot, "telemetry", 2 * CAP)]
    assert tel.deferrals == 2 * CAP and tel.queued == 2 * CAP
    # telemetry's deadline did not advance: it leads the next EDF pass
    assert tel.next_deadline <= 0.01
    rec2 = rt.step(0.02)
    rt.flush()
    assert not rec2.overload
    assert tel.queued == 0 and tel.ingested == 2 * CAP
    tiers = rt.tier_counters()
    for row in tiers.values():
        assert row["offered"] == _tier_identity(row)


def test_qos_mixed_tier_overload_conservation():
    """Sustained 2x-overload with small telemetry queues: gesture is
    always served, telemetry absorbs the drops, and the per-tier
    conservation identity holds exactly at every step."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(policy="drop_oldest", queue_capacity=CAP,
                     deadline_s=0.01, step_chunk_budget=2),
    )
    tels = [rt.connect(stream.TELEMETRY_TIER) for _ in range(2)]
    ges = rt.connect(stream.GESTURE_TIER)
    rng = np.random.default_rng(11)
    for k in range(1, 9):
        lo, hi = (k - 1) * 0.01, k * 0.01
        for tel in tels:
            tel.offer(events(rng, 2 * CAP, t_lo=lo, t_hi=hi))
        ges.offer(events(rng, CAP // 2, t_lo=lo, t_hi=hi))
        rec = rt.step(hi)
        assert any(t == "gesture" for _, t, _ in rec.order)
        tiers = rt.tier_counters()
        for tier, row in tiers.items():
            assert row["offered"] == _tier_identity(row), (k, tier, row)
    rt.flush()
    tiers = rt.tier_counters()
    assert tiers["gesture"]["dropped"] == 0
    assert tiers["gesture"]["ingested"] == 8 * (CAP // 2)
    assert tiers["telemetry"]["dropped"] > 0
    assert tiers["telemetry"]["deferrals"] > 0


def test_qos_admission_control():
    """connect() refuses a declared rate that exceeds the remaining
    capacity; freeing a sensor re-opens the budget."""
    rt = StreamRuntime(
        make_engine(), StreamConfig(capacity_eps=10_000.0))
    a = rt.connect(stream.QoSClass(tier="a", rate_hint=6_000.0))
    with pytest.raises(stream.AdmissionError) as ei:
        rt.connect(stream.QoSClass(tier="b", rate_hint=5_000.0))
    assert "10000" in str(ei.value).replace(",", "")
    b = rt.connect(stream.QoSClass(tier="b", rate_hint=4_000.0))
    rt.disconnect(a)
    c = rt.connect(stream.QoSClass(tier="c", rate_hint=6_000.0))
    assert {s.qos.tier for s in rt.sensors.values()} == {"b", "c"}
    assert b.slot != c.slot


def test_qos_admission_uses_observed_drain_rate():
    """An under-declared producer still counts: admission demand is
    max(declared, observed EWMA), so a sensor that declared 0 but
    drains 32 events / 10ms blocks a declared rate that would fit on
    paper."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(deadline_s=0.01, capacity_eps=4_000.0),
    )
    liar = rt.connect(stream.QoSClass(tier="liar", rate_hint=0.0))
    rng = np.random.default_rng(12)
    for k in range(1, 4):
        liar.offer(events(rng, 32, t_lo=(k - 1) * 0.01, t_hi=k * 0.01))
        rt.step(k * 0.01)
    rt.flush()
    assert liar.drain_eps is not None and liar.drain_eps > 3_000.0
    with pytest.raises(stream.AdmissionError):
        rt.connect(stream.QoSClass(tier="b", rate_hint=1_000.0))


def test_offer_retry_after_flow_control():
    """OfferResult is an int (exact consumed count, back-compat) with a
    retry_after hint: 0 while there is room, positive and derived from
    the observed drain rate once the queue overflows."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(policy="block", queue_capacity=CAP, deadline_s=0.01),
    )
    cam = rt.connect()
    rng = np.random.default_rng(13)
    r = cam.offer(events(rng, CAP // 2, t_hi=0.01))
    assert r == CAP // 2 and isinstance(r, int)
    assert r.accepted == CAP // 2 and r.retry_after == 0.0
    # no drain observed yet: the hint falls back to the sensor period
    r = cam.offer(events(rng, CAP, t_hi=0.01))
    assert r == CAP // 2 and r.refused == CAP // 2
    assert r.retry_after == pytest.approx(0.01)
    rt.step(0.01)
    rt.flush()
    assert cam.drain_eps == pytest.approx(CAP / 0.01)
    # drain observed: the hint is backlog / drain rate
    r = cam.offer(events(rng, CAP + 10, t_lo=0.01, t_hi=0.02))
    assert r == CAP and r.refused == 10
    assert r.retry_after == pytest.approx(10 / cam.drain_eps)


def test_set_tier_migrates_queued_attribution():
    """Tier migration moves the queued (unserved) events' attribution
    to the new tier; served/dropped history stays with the old one."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(policy="drop_oldest", queue_capacity=CAP,
                     deadline_s=0.01),
    )
    cam = rt.connect(stream.TELEMETRY_TIER)
    rng = np.random.default_rng(14)
    cam.offer(events(rng, CAP + 16, t_hi=0.01))      # 16 evicted
    rt.step(0.01)                                     # CAP ingested
    rt.flush()
    cam.offer(events(rng, 24, t_lo=0.01, t_hi=0.02))  # queued at migration
    rt.set_tier(cam, stream.GESTURE_TIER)
    tiers = rt.tier_counters()
    assert tiers["telemetry"]["ingested"] == CAP
    assert tiers["telemetry"]["dropped"] == 16
    assert tiers["telemetry"]["deferred"] == 0
    assert tiers["gesture"]["offered"] == 24 == tiers["gesture"]["deferred"]
    for row in tiers.values():
        assert row["offered"] == _tier_identity(row)
    rt.step(0.02)
    rt.flush()
    tiers = rt.tier_counters()
    assert tiers["gesture"]["ingested"] == 24
    for row in tiers.values():
        assert row["offered"] == _tier_identity(row)
    # the log records the migration for the oracle
    kinds = [k for k, _ in rt.log]
    assert kinds.count("set_tier") == 1


def test_qos_churn_migration_replay_oracle():
    """The full QoS gauntlet replays bitwise through the synchronous
    oracle: tiered feeds, churn, mid-run tier migration, overload
    budget — pipelining/EDF/preemption may move when work happens,
    never what it computes."""
    feeds = rp.mixed_scene_feeds(H, W, 0.06, 6, seed=2, churn=True,
                                 tiered=True)
    assert any(f.migrate is not None for f in feeds)
    assert {f.qos.tier for f in feeds} == {"gesture", "telemetry"}
    cfg = make_cfg(n_slots=6)
    report = rp.replay(
        TimeSurfaceEngine(cfg, device="cpu"), feeds,
        StreamConfig(policy="drop_oldest", queue_capacity=256,
                     deadline_s=0.01, step_chunk_budget=3),
    )
    n = rp.check_oracle(report, cpu_engine(cfg))
    assert n == report.n_steps > 0
    kinds = [k for k, _ in report.log]
    assert kinds.count("set_tier") >= 1
    for tier, row in report.tiers.items():
        assert row["offered"] == _tier_identity(row), (tier, row)
    # determinism: the same feeds replay to the same digests
    report2 = rp.replay(
        TimeSurfaceEngine(cfg, device="cpu"),
        rp.mixed_scene_feeds(H, W, 0.06, 6, seed=2, churn=True,
                             tiered=True),
        StreamConfig(policy="drop_oldest", queue_capacity=256,
                     deadline_s=0.01, step_chunk_budget=3),
    )
    assert report.digests == report2.digests


# ---------------------------------------------------------------------------
# long-horizon timestamp precision (epoch rebasing)
# ---------------------------------------------------------------------------

def test_long_horizon_timestamps_bitwise():
    """Regression: a session starting at t0 = 3600 s reads out bit for
    bit what the same events read at t0 = 0.  Offsets are multiples of
    1/8192 s — exact in float64 at any t0 and exact in float32 near
    zero, but NOT representable in float32 at 3600 s (ulp there is
    1/4096 s) — so the pre-epoch code, which cast absolute stamps to
    float32 on offer, quantized them and diverged."""
    rng = np.random.default_rng(20)
    n = 96
    offs = np.sort(rng.integers(1, 800, n)) / 8192.0          # float64
    xs = rng.integers(0, W, n).astype(np.int32)
    ys = rng.integers(0, H, n).astype(np.int32)
    ps = rng.integers(0, 2, n).astype(np.int32)

    # the premise: some absolute stamps at 3600 s are not float32-exact
    abs_t = 3600.0 + offs
    assert (np.float64(np.float32(abs_t)) != abs_t).any()

    def run(t0):
        rt = StreamRuntime(make_engine(), StreamConfig())
        cam = rt.connect()
        cam.offer((xs, ys, t0 + offs, ps))
        rec = rt.step(t0 + 0.125)                 # dyadic: exact either way
        out = np.asarray(rt.flush()["surface"])
        return out, rec.digest, rt.t_epoch

    base, d0, e0 = run(0.0)
    far, d1, e1 = run(3600.0)
    assert e0 == 0.0 and e1 == 3600.0             # whole-second floor
    np.testing.assert_array_equal(far, base)
    assert d0 == d1 and d0


def test_epoch_floor_keeps_subsecond_sessions_at_zero():
    """A session whose first stamp is inside its first second pins epoch
    0 — engine-facing times are bitwise the pre-epoch absolute times."""
    rt = StreamRuntime(make_engine(), StreamConfig())
    cam = rt.connect()
    ev = events(np.random.default_rng(21), 40)
    assert ev.t[0] > 0                            # strictly inside (0, 1)
    cam.offer(ev)
    rec = rt.step(0.06)
    rt.flush()
    assert rt.t_epoch == 0.0 and rec.t_read == 0.06
    assert rt.stats()["t_epoch"] == 0.0
    # the log carries the (here: identical) rebased stamps the oracle eats
    _, (_, _, lt, _) = rec.chunks[0]
    np.testing.assert_array_equal(lt, ev.t)


def test_long_horizon_replay_oracle():
    """The action log records rebased times, so the replay oracle gates
    a 3600-s-old session without knowing about epochs."""
    rng = np.random.default_rng(22)
    n = 200
    offs = np.sort(rng.integers(1, 300, n)) / 8192.0
    stream_far = syn.EventStream(
        x=rng.integers(0, W, n).astype(np.int32),
        y=rng.integers(0, H, n).astype(np.int32),
        t=(3600.0 + offs).astype(np.float64),
        p=rng.integers(0, 2, n).astype(np.int32),
        is_signal=np.ones(n, bool), h=H, w=W,
    )
    cfg = make_cfg()
    rt = StreamRuntime(TimeSurfaceEngine(cfg, device="cpu"),
                       StreamConfig(deadline_s=0.01))
    cam = rt.connect()
    cam.offer((stream_far.x, stream_far.y, stream_far.t, stream_far.p))
    for k in range(1, 5):
        rt.step(3600.0 + k * 0.01 + 0.0625)
    rt.flush()
    digests = [e.digest for kind, e in rt.log if kind == "step"]
    # rebuild from the log exactly like events.replay's oracle does:
    # fresh engine, recorded chunks, recorded (rebased) read times
    oracle = TimeSurfaceEngine(cfg, device="cpu")
    cam2 = oracle.attach()
    for kind, e in rt.log:
        if kind != "step":
            continue
        for slot, (x, y, t, p) in e.chunks:
            assert slot == cam.slot
            cam2.push(syn.EventStream(
                x=x, y=y, t=t, p=p, is_signal=np.ones(len(x), bool),
                h=H, w=W))
        got = oracle.read(rt.spec, e.t_read)
        assert stream.digest_products(got) == digests.pop(0)


# ---------------------------------------------------------------------------
# device-resident ingest ring
# ---------------------------------------------------------------------------

def test_device_ring_bitwise_vs_host_staged():
    """The ring path (device_ring=True, the default) and the host-staged
    comparator produce identical per-deadline digests over mixed
    traffic, and the ring run passes the synchronous replay oracle."""
    cfg = make_cfg()

    def run(device_ring):
        return rp.replay(
            TimeSurfaceEngine(cfg, device="cpu"),
            rp.mixed_scene_feeds(H, W, 0.05, 4, seed=30),
            StreamConfig(policy="drop_oldest", queue_capacity=256,
                         deadline_s=0.01, device_ring=device_ring),
        )

    ring, host = run(True), run(False)
    assert ring.digests == host.digests
    assert (ring.ingested, ring.dropped) == (host.ingested, host.dropped)
    n = rp.check_oracle(ring, cpu_engine(cfg))
    assert n == ring.n_steps > 0


def test_push_staged_equals_push():
    """Direct engine-level gate: ``push_staged`` raw parts vs ``push``
    of the same events give the same surface bits, including partial
    chunks and multiple sensors per dispatch."""
    rng = np.random.default_rng(32)
    eng_a, eng_b = make_engine(), make_engine()
    cams_a = [eng_a.attach() for _ in range(2)]
    cams_b = [eng_b.attach() for _ in range(2)]
    evs = [events(rng, CAP + 17), events(rng, 23)]
    eng_a.push(list(zip(cams_a, evs)))
    items = []
    for cam, ev in zip(cams_b, evs):
        for lo in range(0, ev.n, CAP):
            part = tuple(a[lo:lo + CAP] for a in (ev.x, ev.y, ev.t, ev.p))
            items.append((cam.slot, part))
    eng_b.push_staged(items)
    for t_read in (0.06, 0.08):
        a = eng_a.read(rs.SURFACE_SPEC, t_read)
        b = eng_b.read(rs.SURFACE_SPEC, t_read)
        np.testing.assert_array_equal(np.asarray(b["surface"]),
                                      np.asarray(a["surface"]))


def test_push_staged_validates_parts():
    eng = make_engine()
    cam = eng.attach()
    ev = events(np.random.default_rng(33), CAP + 1)
    part = (ev.x, ev.y, ev.t, ev.p)
    with pytest.raises(ValueError, match="chunk capacity"):
        eng.push_staged([(cam.slot, part)])
    with pytest.raises(ValueError, match="not acquired"):
        eng.push_staged([(3, tuple(a[:4] for a in part))])
    eng.push_staged([])                           # explicit no-op


def test_ingest_ring_rotation_and_zero_fill():
    """The ring alternates staging sets per padded batch size and
    re-zeroes on acquire, so a stale row from two steps ago can never
    leak into a later, smaller dispatch."""
    from repro_torch.serve.ts_engine import IngestRing

    ring = IngestRing(capacity=8, device="cpu", depth=2)
    a = ring.acquire(2)
    IngestRing.fill_row(a, 1, 3, (np.array([5], np.int32),) * 4)
    b = ring.acquire(2)
    assert b is not a                             # double buffered
    assert ring.acquire(2) is a                   # rotation wraps
    assert a["sids"][1] == 0 and not a["valid"].any()   # re-zeroed
    # distinct padded sizes keep distinct sets
    c = ring.acquire(4)
    assert c["x"].shape == (4, 8) and a["x"].shape == (2, 8)
    with pytest.raises(ValueError, match="depth"):
        IngestRing(capacity=8, device="cpu", depth=1)


def test_stream_runtime_ring_off_matches_on():
    """StreamRuntime honors device_ring=False (host-staged comparator)
    and both modes drain/account identically."""
    def run(device_ring):
        rt = StreamRuntime(
            make_engine(),
            StreamConfig(queue_capacity=1 << 12, device_ring=device_ring))
        cam = rt.connect()
        cam.offer(events(np.random.default_rng(34), 2 * CAP + 9))
        rec = rt.step(0.06)
        out = np.asarray(rt.flush()["surface"])
        return out, rec.digest, cam.ingested

    on, off = run(True), run(False)
    np.testing.assert_array_equal(on[0], off[0])
    assert on[1] == off[1] and on[2] == off[2] == 2 * CAP + 9


# ---------------------------------------------------------------------------
# flow-control edges
# ---------------------------------------------------------------------------

def test_retry_after_before_any_drain_falls_back_to_period():
    """drain_eps unset (no deadline has drained yet) vs observed: the
    hint falls back to the sensor's own period, not the runtime's."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(policy="block", queue_capacity=8, deadline_s=0.01))
    cam = rt.connect(stream.QoSClass(tier="slow", period_s=0.04))
    assert cam.drain_eps is None
    r = cam.offer(events(np.random.default_rng(40), 12))
    assert r == 8 and r.refused == 4
    assert r.retry_after == pytest.approx(0.04)   # period, drain unknown


def test_idle_deadlines_do_not_fabricate_drain_rate():
    """Steps that drain nothing leave the EWMA unset — an idle sensor
    must not observe a zero rate (which would blow the hint up)."""
    rt = StreamRuntime(make_engine(), StreamConfig(deadline_s=0.01))
    cam = rt.connect()
    for k in range(1, 4):
        rt.step(k * 0.01)                         # served, zero drained
    rt.flush()
    assert cam.drain_eps is None
    assert cam.offer((np.array([], np.int32),) * 4).retry_after == 0.0


def test_offer_empty_and_result_semantics():
    """OfferResult int/truthiness: a short block-policy offer is falsy
    exactly when nothing was consumed; drop_newest consumes (truthily)
    even when everything drops."""
    rt = StreamRuntime(
        make_engine(), StreamConfig(policy="block", queue_capacity=4))
    cam = rt.connect()
    empty = (np.array([], np.int32),) * 4
    r = cam.offer(empty)
    assert r == 0 and not r and r.retry_after == 0.0
    ev = events(np.random.default_rng(41), 4)
    full = cam.offer(ev)
    assert full and full == 4 and full + 1 == 5   # plain int arithmetic
    again = cam.offer(ev)
    assert not again and again.refused == 4       # blocked: falsy
    assert again.retry_after > 0.0

    rt2 = StreamRuntime(
        make_engine(), StreamConfig(policy="drop_newest", queue_capacity=4))
    cam2 = rt2.connect()
    cam2.offer(ev)
    r2 = cam2.offer(ev)                           # queue full: all dropped
    assert r2 == 4 and bool(r2)                   # consumed, hence truthy
    assert r2.accepted == 0 and r2.dropped == 4
    assert cam2.offer(empty) == 0


def test_ewma_spans_deferred_steps():
    """A sensor deferred by overload keeps its EWMA window open: when it
    finally drains, the instantaneous rate is measured over the full
    interval since its last service, not one period — so deferral slows
    the observed rate instead of hiding it."""
    rt = StreamRuntime(
        make_engine(),
        StreamConfig(deadline_s=0.01, queue_capacity=1 << 12,
                     step_chunk_budget=1))
    tel = rt.connect(stream.TELEMETRY_TIER)
    ges = rt.connect(stream.GESTURE_TIER)
    rng = np.random.default_rng(42)
    rt.step(0.01)                                 # both served empty
    assert tel.drain_eps is None
    tel.offer(events(rng, CAP, t_lo=0.01, t_hi=0.02))
    ges.offer(events(rng, CAP, t_lo=0.01, t_hi=0.02))
    rec = rt.step(0.02)                           # budget 1: tel defers
    assert rec.overload and tel.deferrals == CAP
    assert tel.drain_eps is None                  # no drain, no update
    rt.step(0.03)                                 # tel finally drains
    rt.flush()
    # CAP events over the 0.01 -> 0.03 window, not over one period
    assert tel.drain_eps == pytest.approx(CAP / 0.02)
    tel.offer(events(rng, CAP // 2, t_lo=0.03, t_hi=0.04))
    rt.step(0.04)
    rt.flush()
    inst = (CAP // 2) / 0.01
    want = 0.3 * inst + 0.7 * (CAP / 0.02)        # the EWMA folds in
    assert tel.drain_eps == pytest.approx(want)


def test_qos_multi_spec_step_reads():
    """Sensors carrying their own ReadoutSpec get it served in the same
    step (one fused dispatch per unique spec), bit-identical to plain
    reads, and the oracle digests cover every spec."""
    count_spec = rs.ReadoutSpec(surface=rs.surface(), count=rs.count(4))
    cfg = TSEngineConfig(h=H, w=W, n_slots=4, chunk_capacity=CAP,
                         block=(8, 16), specs=(count_spec,))
    rt = StreamRuntime(TimeSurfaceEngine(cfg, device="cpu"), StreamConfig(deadline_s=0.01))
    plain = rt.connect()
    counted = rt.connect(stream.QoSClass(tier="counted", spec=count_spec))
    rng = np.random.default_rng(15)
    for cam in (plain, counted):
        cam.offer(events(rng, 32, t_hi=0.01))
    rec = rt.step(0.01)
    rt.flush()
    assert rec.specs == (rt.spec, count_spec)
    want = rt.engine.read(count_spec, 0.01)
    got = rt.engine.read_many((rt.spec, count_spec, count_spec), 0.01)
    assert len(got) == 2                      # deduped
    for name in want:
        assert (np.asarray(got[count_spec][name])
                == np.asarray(want[name])).all()




# ---------------------------------------------------------------------------
# per-tier model serving (the reference's classify-tier gate, one device)
# ---------------------------------------------------------------------------

def test_stream_classify_tier_end_to_end():
    """A gesture tier carrying a Classify-bearing spec streams logits:
    digest-chained and replayed bitwise by the oracle, and bitwise the
    standalone frontend + ``cnn_apply`` over the same served surfaces."""
    from repro_torch.models import cnn
    from repro_torch.models.frontends import ts_stack_frontend
    from repro_torch.serve import heads as heads_mod

    head = rs.classify(n_classes=4, width=8)
    head_spec = rs.ReadoutSpec(surface=rs.surface(), logits=head)
    feeds = rp.mixed_scene_feeds(H, W, 0.04, 3, seed=21, tiered=True)
    for f in feeds:
        if f.qos.tier == "gesture":
            f.qos = dataclasses.replace(f.qos, spec=head_spec)
    cfg = make_cfg()
    scfg = StreamConfig(policy="drop_oldest", queue_capacity=256,
                        deadline_s=0.01)
    eng = TimeSurfaceEngine(cfg, device="cpu")
    report = rp.replay(eng, feeds, scfg)
    n = rp.check_oracle(report, cpu_engine(cfg))
    assert n == report.n_steps > 0
    out = eng.read(head_spec, report.n_steps * scfg.deadline_s)
    params = heads_mod.resolve_head_params(head, cfg, "cpu")
    want = cnn.cnn_apply(params, ts_stack_frontend([out["surface"]]))
    assert torch.equal(out["logits"], want)


# ---------------------------------------------------------------------------
# the device mesh waits for the multi-device slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [["--mesh", "2"]])
def test_stream_cli_fleet_flags_raise(flag):
    from repro_torch.launch import serve as launch_serve

    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        launch_serve.main(["stream", "--hw", "8x8", "--device", "cpu",
                           *flag])


# ---------------------------------------------------------------------------
# fleet elasticity + live migration on one device, beside the reference
# ---------------------------------------------------------------------------

class _Pkg:
    """One package's engine / stream / replay API (the JAX engine on its
    ``ref`` backend, the port on the CPU), so a scenario runs on both."""

    def __init__(self, name):
        if name == "jax":
            from repro.events import replay as mrp
            from repro.serve import fidelity as mfm
            from repro.serve import heads as mheads
            from repro.serve import spec as mrs
            from repro.serve import stream as mstream
            from repro.serve import ts_engine as meng
            self.cfg_kw, self.eng_kw = dict(backend="ref"), {}
        else:
            from repro_torch.serve import heads as mheads
            from repro_torch.serve import ts_engine as meng
            mrp, mfm, mrs, mstream = rp, fm, rs, stream
            self.cfg_kw, self.eng_kw = {}, dict(device="cpu")
        self.name, self.rp, self.fm, self.heads = name, mrp, mfm, mheads
        self.rs, self.stream, self.eng = mrs, mstream, meng

    def cfg(self, **kw):
        base = dict(h=H, w=W, chunk_capacity=CAP, block=(8, 16))
        return self.eng.TSEngineConfig(**{**base, **kw}, **self.cfg_kw)

    def engine(self, cfg):
        return self.eng.TimeSurfaceEngine(cfg, **self.eng_kw)

    def runtime(self, cfg, **scfg):
        return self.stream.StreamRuntime(self.engine(cfg),
                                         self.stream.StreamConfig(**scfg))


def _both(scenario):
    """``scenario(pkg)`` on the reference, then on the port."""
    return [scenario(_Pkg(name)) for name in ("jax", "torch")]


def _ev(rng, n, t_lo=0.0, t_hi=0.06):
    e = events(rng, n, t_lo, t_hi)
    return e.x, e.y, e.t, e.p


def _log_view(log):
    """A package-neutral view of an action log: QoS classes by tier,
    step records by their schedule, flags and chunk contents."""
    out = []
    for kind, e in log:
        if kind in ("attach", "set_tier"):
            out.append((kind, e[0], e[1].tier))
        elif kind == "shrink":
            out.append((kind, e[0], [tuple(m) for m in e[1]]))
        elif kind == "step":
            out.append((kind, e.t_read, e.n_events, e.n_chunks, e.order,
                        e.deferred, e.overload, e.noise_step, e.barrier,
                        [(slot, [np.asarray(a).tolist() for a in part])
                         for slot, part in e.chunks]))
        else:
            out.append((kind, e))
    return out


def _assert_same_runtime(j, t):
    assert _log_view(t.log) == _log_view(j.log)
    assert t.counters() == j.counters()
    assert t.tier_counters() == j.tier_counters()


def _assert_own_oracle(m, rt, cfg):
    """A runtime's digests equal its own package's synchronous oracle's
    on a fresh engine (pipelining never changes a bit)."""
    rt.flush()
    got = [e.digest for k, e in rt.log if k == "step"]
    assert got and all(got)
    assert m.rp.oracle_digests(m.engine(cfg), rt.log) == got


def test_elastic_grow_at_exact_bucket_boundary():
    """connect() grows exactly when the next admission would cross the
    watermark -- at the bucket boundary, not one early -- and the live
    surface bits survive the copy into the wider pool; ``max_slots`` caps
    growth.  Logs, counters and capacities equal across packages."""
    def scenario(m):
        cfg = m.cfg(n_slots=2, slot_bucket=2)
        rt = m.runtime(cfg, elastic=True, deadline_s=0.01)
        eng = rt.engine
        a = rt.connect()
        rt.connect()                     # pool exactly full: no grow yet
        assert eng.capacity == 2 and [k for k, _ in rt.log] == ["attach"] * 2
        a.offer(_ev(np.random.default_rng(60), 30))
        rt.step(0.06)
        rt.flush()
        before = np.asarray(
            eng.read(m.rs.SURFACE_SPEC, 0.06)["surface"])[a.slot].copy()
        c = rt.connect()                 # boundary crossed: one bucket
        assert eng.capacity == 4 and c.slot == 2
        assert [e for k, e in rt.log if k == "grow"] == [4]
        after = np.asarray(eng.read(m.rs.SURFACE_SPEC, 0.06)["surface"])
        np.testing.assert_array_equal(after[a.slot], before)
        rt.step(0.07)
        _assert_own_oracle(m, rt, cfg)
        rt2 = m.runtime(m.cfg(n_slots=2, slot_bucket=2), elastic=True,
                        max_slots=4)
        for _ in range(4):
            rt2.connect()
        with pytest.raises(RuntimeError):
            rt2.connect()
        assert rt2.engine.capacity == 4
        return rt, rt2

    (j, j2), (t, t2) = _both(scenario)
    _assert_same_runtime(j, t)
    _assert_same_runtime(j2, t2)


def _register_head(m, key, head, cfg, arrays):
    """Register the same head weights in either package's registry."""
    if m.name == "torch":
        from repro_torch import convert
        m.heads.register_head_params(key, convert.head_params_from_numpy(
            arrays, head, cfg, "cpu"))
        return
    import jax.numpy as jnp
    tree: dict = {}
    for path, a in arrays.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    m.heads.register_head_params(key, tree)


def test_elastic_shrink_compacts_head_bearing_tail():
    """The shrink watermark releases a bucket with a head-bearing tier
    sensor resident in the released tail: its slot compacts downward and
    the surface and the stage-1 logits keep their bits (both packages
    serve the same registered weights)."""
    from repro_torch import convert
    from repro_torch.serve import heads as theads

    head = rs.classify(n_classes=4, width=8, weights="fleet-head")
    arrays = convert.head_params_to_numpy(theads.resolve_head_params(
        dataclasses.replace(head, weights="default"), make_cfg(), "cpu"))

    def scenario(m):
        cfg = m.cfg(n_slots=2, slot_bucket=2)
        mhead = m.rs.classify(n_classes=4, width=8, weights="fleet-head")
        _register_head(m, "fleet-head", mhead, cfg, arrays)
        head_spec = m.rs.ReadoutSpec(surface=m.rs.surface(), logits=mhead)
        rt = m.runtime(cfg, policy="drop_oldest", queue_capacity=256,
                       deadline_s=0.01, elastic=True, shrink_watermark=0.9)
        a, b = rt.connect(), rt.connect()
        ges = rt.connect(dataclasses.replace(m.stream.GESTURE_TIER,
                                             spec=head_spec))
        assert rt.engine.capacity == 4 and ges.slot == 2   # in the tail
        ges.offer(_ev(np.random.default_rng(61), 50, t_hi=0.01))
        rt.step(0.01)
        rt.flush()
        out = rt.engine.read(head_spec, 0.01)
        surf = np.asarray(out["surface"])[ges.slot].copy()
        logits = np.asarray(out["logits"])[ges.slot].copy()
        rt.disconnect(a)
        rt.disconnect(b)
        rt.step(0.02)                    # occupancy 1 <= 0.9 * 2: shrink
        assert [e for k, e in rt.log if k == "shrink"] == [(2, [(2, 0)])]
        assert rt.engine.capacity == 2
        assert ges.slot == 0 and rt.sensors[0] is ges
        out2 = rt.engine.read(head_spec, 0.01)
        np.testing.assert_array_equal(np.asarray(out2["surface"])[0], surf)
        np.testing.assert_array_equal(np.asarray(out2["logits"])[0], logits)
        _assert_own_oracle(m, rt, cfg)
        m.heads.clear_registry()
        return rt

    _assert_same_runtime(*_both(scenario))


def test_migrate_preserves_deferred_deadline_and_analog_noise():
    """migrate() moves a sensor with a deferred deadline (queue intact,
    deadline unmoved, queued events counted in ``migrated``) and a slot
    whose analog noise generation is not the first: the generation value
    travels with the state, so the analog read at the destination is
    bitwise the source's."""
    def scenario(m):
        analog = m.rs.ReadoutSpec(surface=m.rs.surface(
            fidelity=m.fm.analog_3d()))
        cfg = m.cfg(n_slots=4, slot_bucket=2, mode="edram")
        rt = m.runtime(cfg, policy="drop_oldest", queue_capacity=1 << 12,
                       deadline_s=0.01, step_chunk_budget=1, elastic=True)
        rt.disconnect(rt.connect())      # bump slot 0's generation
        ges = rt.connect(dataclasses.replace(m.stream.GESTURE_TIER,
                                             spec=analog))
        tel = rt.connect(m.stream.TELEMETRY_TIER)
        rng = np.random.default_rng(62)
        ges.offer(_ev(rng, CAP, t_hi=0.01))
        tel.offer(_ev(rng, CAP, t_hi=0.01))
        rec = rt.step(0.01)              # budget 1: telemetry defers
        rt.flush()
        assert rec.overload and tel.deferrals == CAP and tel.queued == CAP
        assert tel.next_deadline <= 0.01
        gen = int(np.asarray(rt.engine.state.generation)[ges.slot])
        assert gen > 1
        noise = np.asarray(rt.engine.read(analog, 0.01, noise_step=0)
                           ["surface"])[ges.slot].copy()
        src_g, src_t = ges.slot, tel.slot
        dst_g, dst_t = rt.migrate(ges), rt.migrate(tel)
        assert dst_g != src_g and dst_t != src_t
        assert ges.slot == dst_g and rt.sensors[dst_g] is ges
        assert tel.queued == CAP and tel.next_deadline <= 0.01
        assert tel.migrated == CAP and ges.migrated == 0
        assert int(np.asarray(rt.engine.state.generation)[dst_g]) == gen
        np.testing.assert_array_equal(
            np.asarray(rt.engine.read(analog, 0.01, noise_step=0)
                       ["surface"])[dst_g], noise)
        rt.step(0.02)                    # the deferred queue drains at dst
        rt.flush()
        assert tel.queued == 0 and tel.ingested == CAP
        assert [k for k, _ in rt.log].count("migrate") == 2
        for row in rt.tier_counters().values():
            assert row["offered"] == _tier_identity(row)
        assert rt.tier_counters()["telemetry"]["migrated"] == CAP
        _assert_own_oracle(m, rt, cfg)
        return rt

    _assert_same_runtime(*_both(scenario))


def test_migrate_then_set_tier_ordering():
    """A set_tier right after migrate() logs in order and names the
    sensor's *new* slot; the queued attribution moves tiers while the
    ``migrated`` count stays with the tier that owned the queue."""
    def scenario(m):
        cfg = m.cfg(n_slots=4, slot_bucket=4)
        rt = m.runtime(cfg, policy="drop_oldest", queue_capacity=256,
                       deadline_s=0.01, elastic=True)
        cam = rt.connect(m.stream.TELEMETRY_TIER)
        cam.offer(_ev(np.random.default_rng(63), 24, t_hi=0.01))
        src = cam.slot
        dst = rt.migrate(cam)
        rt.set_tier(cam, m.stream.GESTURE_TIER)
        tail = [(k, e) for k, e in rt.log if k in ("migrate", "set_tier")]
        assert tail[0] == ("migrate", (src, dst))
        assert tail[1][0] == "set_tier" and tail[1][1][0] == dst
        tiers = rt.tier_counters()
        assert tiers["telemetry"]["migrated"] == 24
        assert (tiers["gesture"]["offered"], tiers["telemetry"]["offered"]) \
            == (24, 0)
        rt.step(0.01)
        rt.flush()
        tiers = rt.tier_counters()
        assert tiers["gesture"]["ingested"] == 24
        for row in tiers.values():
            assert row["offered"] == _tier_identity(row)
        _assert_own_oracle(m, rt, cfg)
        return rt

    _assert_same_runtime(*_both(scenario))


def test_shard_budget_and_barrier_single_shard():
    """``shard_budget`` on a single-device engine caps the one shard:
    telemetry defers behind gesture on regular steps, and every Nth
    deadline is a barrier -- the budget lifts, everyone drains, and the
    shard's virtual clock re-syncs to the deadline."""
    def scenario(m):
        cfg = m.cfg(n_slots=4)
        rt = m.runtime(cfg, deadline_s=0.01, queue_capacity=1 << 12,
                       shard_budget=1, shard_barrier_every=3)
        tel = rt.connect(m.stream.TELEMETRY_TIER)
        ges = rt.connect(m.stream.GESTURE_TIER)
        rng = np.random.default_rng(64)
        recs = []
        for k in range(1, 7):
            lo, hi = (k - 1) * 0.01, k * 0.01
            tel.offer(_ev(rng, CAP, t_lo=lo, t_hi=hi))
            ges.offer(_ev(rng, CAP, t_lo=lo, t_hi=hi))
            recs.append(rt.step(hi))
        rt.flush()
        assert [r.barrier for r in recs] == [False, False, True] * 2
        for r in recs:
            served = {t for _, t, _ in r.order}
            if r.barrier:
                assert served == {"gesture", "telemetry"}
            else:
                assert served == {"gesture"} and r.overload
        assert tel.queued == 0
        assert rt.stats()["shard_clocks"] == {0: pytest.approx(0.06)}
        for row in rt.tier_counters().values():
            assert row["offered"] == _tier_identity(row)
        _assert_own_oracle(m, rt, cfg)
        return rt

    _assert_same_runtime(*_both(scenario))


def test_fleet_churn_elastic_migration_replay_oracle():
    """The fleet gate on one device: attach waves grow the pool >= 2x,
    three sensors live-migrate mid-run (one on the analog, head-bearing
    gesture tier), late detaches trigger one compacting shrink -- and the
    whole schedule replays bitwise through each package's synchronous
    oracle, with exact per-tier conservation and ``migrated``
    attribution; reports and logs equal across packages."""
    def scenario(m):
        cfg = m.cfg(n_slots=3, slot_bucket=3, chunk_capacity=1 << 10,
                    mode="edram")
        scfg = m.stream.StreamConfig(
            policy="drop_oldest", deadline_s=0.005, elastic=True,
            shrink_watermark=0.9, step_chunk_budget=6, pipeline=True)
        feeds = m.rp.fleet_scene_feeds(H, W, 0.06, 9, seed=3, noise_hz=20.0)
        report = m.rp.replay(m.engine(cfg), feeds, scfg, arrival_substeps=2)
        assert m.rp.check_oracle(report, lambda: m.engine(cfg)) \
            == report.n_steps > 0
        kinds = [k for k, _ in report.log]
        assert kinds.count("grow") >= 2 and kinds.count("shrink") == 1
        assert kinds.count("migrate") == 3 and report.migrated > 0
        assert [m_ for k, e in report.log if k == "shrink" for m_ in e[1]]
        for row in report.tiers.values():
            assert row["offered"] == _tier_identity(row)
        assert sum(r["migrated"] for r in report.tiers.values()) \
            == report.migrated
        assert report.tiers["gesture"]["migrated"] > 0   # the analog mover
        return report

    want, got = _both(scenario)
    for k in ("n_steps", "offered", "accepted", "ingested", "dropped",
              "refused", "discarded", "unoffered", "migrated"):
        assert getattr(got, k) == getattr(want, k), k
    assert _strip_latency(got.tiers) == _strip_latency(want.tiers)
    assert _log_view(got.log) == _log_view(want.log)


def test_differential_stream_migrate():
    """The reference's differential walk (``stream_migrate``): a sensor
    with device state and a live queue migrates, its queue drains at the
    new slot on the next deadline, the vacated slot reads all-zero, and a
    second migration ping-pongs back through the freed slot.  SAE and
    counts bitwise across packages, surfaces within 2 ULP, logs and
    counters equal."""
    def scenario(m):
        spec = m.rs.ReadoutSpec(surface=m.rs.surface(), count=m.rs.count(4))
        cfg = m.cfg(n_slots=2, mode="edram", specs=(spec,))
        rt = m.runtime(cfg, policy="drop_oldest", queue_capacity=1 << 12,
                       deadline_s=0.01)
        rng = np.random.default_rng(5)
        cam = rt.connect()
        cam.offer(_ev(rng, CAP, t_hi=0.03))
        rt.step(0.03)
        cam.offer(_ev(rng, CAP // 2, t_lo=0.03, t_hi=0.05))
        queued, surfaces = cam.queued, []
        assert rt.migrate(cam) == 1 and cam.migrated == queued
        rt.step(0.05)
        assert cam.queued == 0 and cam.ingested == CAP + CAP // 2
        surfaces.append(np.asarray(rt.flush()["surface"]).copy())
        assert not surfaces[-1][0].any()          # the vacated slot
        assert rt.migrate(cam) == 0               # ping-pong back
        rt.step(0.08)
        surfaces.append(np.asarray(rt.flush()["surface"]).copy())
        assert not surfaces[-1][1].any()
        _assert_own_oracle(m, rt, cfg)
        st = rt.engine.state
        return rt, surfaces, np.asarray(st.surfaces.sae), np.asarray(st.counts)

    (j, js, jsae, jc), (t, ts_, tsae, tc) = _both(scenario)
    _assert_same_runtime(j, t)
    np.testing.assert_array_equal(tsae.view(np.int32), jsae.view(np.int32))
    np.testing.assert_array_equal(tc, jc)
    from repro_torch.kernels import ref as tref
    for a, b in zip(ts_, js):
        assert int(tref.ulp_distance(torch.from_numpy(a),
                                     torch.from_numpy(b)).max()) <= 2


@pytest.mark.parametrize("kw", [
    dict(max_slots=0), dict(grow_watermark=0.0), dict(grow_watermark=1.5),
    dict(shrink_watermark=-0.1), dict(shrink_watermark=1.1),
    dict(shard_budget=0), dict(shard_barrier_every=-1),
])
def test_fleet_knob_checks_match_reference(kw):
    """The port's StreamConfig rejects a fleet knob exactly where the
    reference's asserts fail."""
    from repro.serve import stream as jstream

    with pytest.raises(AssertionError):
        jstream.StreamConfig(**kw)
    with pytest.raises(ValueError, match=next(iter(kw))):
        StreamConfig(**kw)


def test_slot_bucket_check_matches_reference():
    from repro.serve import ts_engine as jeng

    with pytest.raises(AssertionError):
        jeng.TSEngineConfig(slot_bucket=0)
    with pytest.raises(ValueError, match="slot_bucket"):
        TSEngineConfig(slot_bucket=0)
    assert TSEngineConfig(n_slots=5).slot_bucket is None


@pytest.mark.parametrize("flag", [["--elastic"], ["--migrate-demo"],
                                  ["--shard-budget", "2"],
                                  ["--barrier-every", "4"]])
def test_stream_cli_fleet_flags_run(flag, capsys):
    """The fleet flags drive the stream CLI on the CPU to its oracle gate;
    the elastic runs print the fleet log."""
    from repro_torch.launch import serve as launch_serve

    launch_serve.main(["stream", "--hw", "24x32", "--sensors", "4",
                       "--duration", "0.03", "--deadline", "0.005",
                       "--chunk", "512", "--device", "cpu", *flag])
    out = capsys.readouterr().out
    assert "bitwise oracle gate: OK" in out
    assert ("fleet ops: grow->" in out) == (flag[0] in ("--elastic",
                                                        "--migrate-demo"))
    if flag == ["--migrate-demo"]:
        assert out.count(" move@") == 3 and "migrate " in out


# ---------------------------------------------------------------------------
# the cross-package gate: the port's runtime against the JAX runtime
# ---------------------------------------------------------------------------

XH, XW = 32, 48
#: (name, StreamConfig kwargs): the reference fidelity test's overload
#: mix, and a block-policy run with a tighter budget and small queues
X_CASES = [
    ("drop_oldest-budget3", dict(policy="drop_oldest", queue_capacity=1 << 12,
                                 deadline_s=0.005, step_chunk_budget=3)),
    ("block-budget1-queue1500", dict(policy="block", queue_capacity=1500,
                                     deadline_s=0.005, step_chunk_budget=1)),
]


def _x_feeds(rpm, rsm, fmm):
    """Tiered, churned mixed-scene traffic (one tier migration) whose
    gesture tier serves an analog_3d surface + STCF + denoise head."""
    head = rsm.ReadoutSpec(
        surface=rsm.surface(fidelity=fmm.analog_3d()),
        stcf=rsm.stcf(decay=rsm.surface(fidelity=fmm.analog_3d())),
        labels=rsm.denoise(input="stcf"))
    feeds = rpm.mixed_scene_feeds(XH, XW, 0.06, 5, seed=7, noise_hz=20.0,
                                  churn=True, tiered=True)
    return [dataclasses.replace(f, qos=dataclasses.replace(f.qos, spec=head))
            if f.qos.tier == "gesture" else f for f in feeds]


def _x_cfg(mod, **kw):
    spec = mod.spec.ReadoutSpec(surface=mod.spec.surface())
    return mod.ts_engine.TSEngineConfig(h=XH, w=XW, n_slots=6,
                                        chunk_capacity=1 << 11, mode="edram",
                                        specs=(spec,), **kw), spec


def _strip_latency(tiers):
    return {t: {k: v for k, v in row.items() if "latency" not in k}
            for t, row in tiers.items()}


@pytest.fixture(scope="module")
def x_reference():
    """The JAX runtime on each case's feeds (its ``ref`` backend), run
    once per module."""
    import jax  # noqa: F401  (CPU platform is set by the environment)
    from repro.events import replay as jrp
    from repro.serve import fidelity as jfm
    from repro.serve import spec as jrs
    from repro.serve import stream as jstream
    from repro.serve import ts_engine as jeng

    class J:
        spec, ts_engine = jrs, jeng
    out = {}
    for name, kw in X_CASES:
        cfg, spec = _x_cfg(J, backend="ref")
        out[name] = jrp.replay(jeng.TimeSurfaceEngine(cfg),
                               _x_feeds(jrp, jrs, jfm),
                               jstream.StreamConfig(**kw), spec,
                               arrival_substeps=2)
    return out


def _x_port(kw, **over):
    from repro_torch.serve import ts_engine as teng

    class T:
        spec, ts_engine = rs, teng
    cfg, spec = _x_cfg(T)
    report = rp.replay(TimeSurfaceEngine(cfg, device="cpu"),
                       _x_feeds(rp, rs, fm),
                       StreamConfig(**{**kw, **over}), spec,
                       arrival_substeps=2)
    return report, cfg, spec


@pytest.mark.parametrize("name, kw", X_CASES, ids=[c[0] for c in X_CASES])
def test_tiered_analog_stream_matches_reference(x_reference, name, kw):
    """Same feeds, same config: the port's counters, tier counters,
    action log (attach / set_tier / detach order, every step's schedule,
    deferrals, overload flag, read time, noise step and chunk contents)
    and modeled energy equal the JAX runtime's exactly."""
    want = x_reference[name]
    got, _, _ = _x_port(kw)
    for k in ("n_steps", "offered", "accepted", "ingested", "dropped",
              "refused", "discarded", "unoffered", "migrated"):
        assert getattr(got, k) == getattr(want, k), k
    assert _strip_latency(got.tiers) == _strip_latency(want.tiers)
    assert got.energy_uj == want.energy_uj
    assert got.tier_energy_uj == want.tier_energy_uj
    assert [k for k, _ in got.log] == [k for k, _ in want.log]
    steps = [(g, w) for (k, g), (_, w) in zip(got.log, want.log)
             if k == "step"]
    assert any(w.overload for _, w in steps)
    assert {"set_tier", "detach"} <= {k for k, _ in want.log}
    for g, w in steps:
        assert (g.t_read, g.n_events, g.n_chunks, g.order, g.deferred,
                g.overload, g.noise_step) == (
            w.t_read, w.n_events, w.n_chunks, w.order, w.deferred,
            w.overload, w.noise_step)
        assert len(g.chunks) == len(w.chunks)
        for (gs, gpart), (ws, wpart) in zip(g.chunks, w.chunks):
            assert gs == ws
            for a, b in zip(gpart, wpart):
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name, kw", X_CASES, ids=[c[0] for c in X_CASES])
def test_tiered_analog_stream_oracle_ring_and_pipeline(name, kw):
    """On the same traffic the port's digests replay bitwise through its
    own synchronous oracle (analog noise included), and neither the ring
    nor the pipeline changes a bit: ring == host-staged push, pipelined
    == synchronous."""
    base, cfg, spec = _x_port(kw)
    assert rp.check_oracle(base, cpu_engine(cfg), spec) == base.n_steps > 0
    host, _, _ = _x_port(kw, device_ring=False)
    sync, _, _ = _x_port(kw, pipeline=False)
    assert host.digests == base.digests == sync.digests
    assert all(base.digests)
