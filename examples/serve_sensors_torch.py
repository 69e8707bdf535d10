"""Multi-sensor streaming demo on the PyTorch port: four event cameras
share one engine.  The port's counterpart of ``examples/serve_sensors.py``:
the same sessions, windows, specs, heads and replays, and the same
printed lines, on the CUDA device unless ``--device`` names another.

Each camera holds a ``SensorSession``, and every window deadline serves
one composed ``ReadoutSpec`` -- decayed surface + comparator mask + event
count -- through ``serve_step``: events reach the engine in two
half-window bursts, the first read is a dense fill, and the second
re-reads only the dirty tiles the late burst touched.  Mid-run, sensor 1
disconnects (``detach``) and a new camera reuses its slot.  A model
section serves stage-1 heads (CNN class logits, STCF denoise labels) off
the same state, bitwise equal to the standalone head.  Two last sections
replay the scene mix as continuous traffic through the ``StreamRuntime``
(churn, then QoS tiers under an overloaded step budget) and gate each
bitwise against a synchronous oracle.

    PYTHONPATH=src python examples/serve_sensors_torch.py
    PYTHONPATH=src python examples/serve_sensors_torch.py --mesh 2
    PYTHONPATH=src python examples/serve_sensors_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.events import aer, datasets
from repro_torch.events import replay as rp
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import cnn
from repro_torch.models.frontends import ts_stack_frontend
from repro_torch.serve import heads as heads_mod
from repro_torch.serve import spec as rs
from repro_torch.serve.stream import StreamConfig
from repro_torch.serve.ts_engine import TSEngineConfig, TimeSurfaceEngine

H, W = 64, 86
WINDOW_S = 0.02
DURATION = 0.2
REPORT_COUNTERS = ("n_steps", "offered", "accepted", "ingested", "dropped",
                   "refused", "discarded", "unoffered", "migrated")
TIER_COUNTERS = ("offered", "ingested", "dropped", "refused", "discarded",
                 "deferred")


def window(s, lo: float, hi: float) -> np.ndarray:
    return aer.pack(s.window(lo, hi))


def counters(report: rp.ReplayReport) -> dict:
    """A replay's exact event accounting, overall and per tier."""
    out = {k: getattr(report, k) for k in REPORT_COUNTERS}
    out["tiers"] = {tier: {k: row[k] for k in TIER_COUNTERS}
                    for tier, row in sorted(report.tiers.items())}
    return out


def main(argv=None) -> dict:
    """Returns what the run served: per-window ``occupancy`` and
    ``active`` pixels per camera, the final ``n_events`` per camera, the
    last window's ``frame`` and the ``model`` products (on the CPU), the
    cameras' ``logits`` and ``keep`` rates, and each replay's
    ``counters``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the slot pool over N shards, cycling over "
                    "the visible cards (or over --device)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = make_host_mesh(args.mesh, device=args.device) if args.mesh else None

    def engine() -> TimeSurfaceEngine:
        return TimeSurfaceEngine(cfg, device=None if mesh else device,
                                 mesh=mesh)

    FRAME = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           count=rs.count(4))
    cfg = TSEngineConfig(h=H, w=W, n_slots=4, chunk_capacity=4096,
                         mode="edram", specs=(FRAME,))
    eng = engine()
    if mesh is not None:
        print(f"slot pool sharded over {mesh.shape} "
              f"({eng.n_slots_padded} slots incl. padding) -- "
              f"{mesh.placement()}")

    kinds = ["driving", "driving", "hotel_bar", "hotel_bar"]
    streams = [datasets.dnd21_like(k, h=H, w=W, duration=DURATION, seed=i)
               for i, k in enumerate(kinds)]
    cams = [eng.attach() for _ in streams]
    print(f"{len(streams)} sensors on slots {[c.slot for c in cams]}: "
          f"{[s.n for s in streams]} events")

    occupancy, active_px = [], []
    n_win = int(round(DURATION / WINDOW_S))
    for wi in range(n_win):
        lo, hi = wi * WINDOW_S, (wi + 1) * WINDOW_S

        if wi == n_win // 2:  # sensor 1 disconnects; a new one takes the slot
            cams[1].detach()
            cams[1] = eng.attach()
            streams[1] = datasets.dnd21_like("hotel_bar", h=H, w=W,
                                             duration=DURATION, seed=99)
            print(f"window {wi}: sensor 1 swapped (slot {cams[1].slot} "
                  f"reused, generation {cams[1].generation})")

        # two half-window bursts, both rendered at the window deadline:
        # burst 1 refills the cache densely (t_now moved), burst 2 only
        # re-reads the tiles it dirtied
        mid = lo + WINDOW_S / 2
        for b_lo, b_hi in ((lo, mid), (mid, hi)):
            items = [(cam, window(s, b_lo, b_hi))
                     for cam, s in zip(cams, streams)]
            frame = eng.serve_step(items, FRAME, hi)
        occ = frame["mask"].cpu().numpy().mean(axis=(1, 2, 3))
        active = (frame["count"].cpu().numpy() > 0).sum(axis=(1, 2))
        occupancy.append([float(occ[c.slot]) for c in cams])
        active_px.append([int(active[c.slot]) for c in cams])
        print(f"t={hi*1e3:5.0f} ms  occupancy per slot: "
              + "  ".join(f"{occ[c.slot]:.3f}" for c in cams)
              + "   active px: "
              + " ".join(f"{active[c.slot]:5d}" for c in cams))

    stats = eng.stats()
    n_events = [stats["n_events"][c.slot] for c in cams]
    print("final events per slot:", n_events)

    # -- stage-1 model heads off the same state ------------------------------
    # the CNN classifier consumes the surface product and the denoise head
    # thresholds the STCF support map; the heads run on exactly the
    # tensors stage 0 served, so the logits are bitwise the standalone head
    head = rs.classify(n_classes=4, width=16)
    MODEL = rs.ReadoutSpec(surface=rs.surface(), stcf=rs.stcf(),
                           logits=head, labels=rs.denoise())
    out = eng.read(MODEL, DURATION)
    lg = out["logits"].cpu().numpy()
    labels = out["labels"].cpu().numpy()
    print("\nmodel products (classify + denoise fused with the surface):")
    keep = []
    for c in cams:
        keep.append(float(labels[c.slot].mean()))
        print(f"  slot {c.slot}: class {int(lg[c.slot].argmax())}, "
              f"logits {np.array2string(lg[c.slot], precision=2)}, "
              f"denoise keep {keep[-1]:.3f}")
    params = heads_mod.resolve_head_params(head, cfg, eng.device)
    want = cnn.cnn_apply(params, ts_stack_frontend([out["surface"]]))
    same = bool((lg == want.cpu().numpy()).all())
    print(f"  fused logits bitwise equal standalone cnn_apply: {same}")
    assert same

    # -- the same traffic as *continuous* streaming ---------------------------
    # bounded ingress queues, deadline-coalesced chunks, pipelined
    # dispatch, and a bitwise synchronous-oracle gate over the replay
    print("\nstreaming replay (drop_oldest, churn):")
    feeds = rp.mixed_scene_feeds(H, W, DURATION, 4, seed=5, churn=True)
    scfg = StreamConfig(policy="drop_oldest", queue_capacity=4096,
                        deadline_s=WINDOW_S)
    report = rp.replay(engine(), feeds, scfg, rs.SURFACE_SPEC)
    print(report.summary())
    churn = counters(report)
    n = rp.check_oracle(report, engine, rs.SURFACE_SPEC)
    print(f"bitwise oracle gate: OK over {n} deadlines")

    # -- QoS: priority tiers under an overloaded step budget ------------------
    # glyph sensors connect as the `gesture` tier (priority 0, 250 ms p99
    # SLO, CNN logits every deadline, digest-chained into the oracle gate)
    # and the rest as `telemetry`; the chunk budget covers only gesture's
    # demand, so priority preempts EDF and telemetry's queues absorb the
    # deferrals and drops, the per-tier counters conserving exactly
    print("\nQoS tiers (gesture preempts telemetry, step budget 8):")
    feeds = rp.mixed_scene_feeds(H, W, DURATION, 4, seed=5, tiered=True)
    gesture_spec = rs.ReadoutSpec(surface=rs.surface(), logits=head)
    for f in feeds:
        if f.qos.tier == "gesture":
            f.qos = dataclasses.replace(f.qos, spec=gesture_spec)
    scfg = StreamConfig(policy="drop_oldest", queue_capacity=1 << 15,
                        deadline_s=WINDOW_S, step_chunk_budget=8)
    # warmup on a throwaway engine, so the latency percentiles below
    # measure scheduling, not first-call set-up
    rp.replay(engine(), feeds, scfg, rs.SURFACE_SPEC)
    report = rp.replay(engine(), feeds, scfg, rs.SURFACE_SPEC)
    print(report.summary())
    for tier, row in sorted(report.tiers.items()):
        assert row["offered"] == (
            row["ingested"] + row["dropped"] + row["refused"]
            + row["discarded"] + row["deferred"]
        ), f"per-tier conservation broken for {tier}"
    print("per-tier conservation: exact")
    qos = counters(report)
    n = rp.check_oracle(report, engine, rs.SURFACE_SPEC)
    print(f"bitwise oracle gate: OK over {n} deadlines")
    return dict(occupancy=occupancy, active=active_px, n_events=n_events,
                frame={k: v.cpu() for k, v in frame.items()},
                model={k: v.cpu() for k, v in out.items()},
                logits=torch.from_numpy(lg[[c.slot for c in cams]]),
                keep=keep, counters={"churn": churn, "qos": qos})


if __name__ == "__main__":
    main()
