"""Serving launcher of the port: ``tokens``, ``sensors``, ``stream`` and
``sweep``.

  * ``tokens``  -- batched LM prefill + greedy decode on an arch config,
                   with weights drawn from ``prng.PRNGKey(0)``, the
                   reference's key;
  * ``sensors`` -- the multi-sensor time-surface engine: seeded
                   DND21-like AER streams in, surfaces, comparator masks,
                   STCF support and counts out; ``--classify C`` adds the
                   stage-1 heads (C-class CNN logits over the surface,
                   STCF denoise labels) to the same spec;
  * ``stream``  -- the real-time runtime: mixed-rate scene traffic replayed
                   through bounded ingress queues with deadline-coalesced,
                   pipelined dispatch; reports throughput, p50/p95/p99
                   readout latency and drops, then gates the whole replay
                   bitwise against the synchronous oracle.  ``--elastic``
                   starts the pool at one bucket and grows / shrinks it
                   with the traffic; ``--migrate-demo`` replays the fleet
                   churn traffic (attach waves, a batch detach, live slot
                   migrations) and prints the fleet log;
  * ``sweep``   -- accuracy against energy: digital and analog-fidelity
                   serving (ideal / analog_3d / analog_2d) across a cmem x
                   retention grid on mixed-scene traffic; writes the
                   frontier as JSON and markdown and prints the verdicts.

    PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
        --arch mamba2-2.7b --requests 4 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
        --arch mamba2-2.7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve sensors \\
        --sensors 4 --hw 240x320 --classify 10
    PYTHONPATH=src python -m repro_torch.launch.serve sensors \\
        --hw 48x64 --duration 0.05 --classify 3 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve stream --sensors 6 \\
        --tiers --budget 5 --deadline 0.005 --queue 8192 --churn
    PYTHONPATH=src python -m repro_torch.launch.serve stream --migrate-demo \\
        --hw 48x64 --duration 0.06 --deadline 0.005
    PYTHONPATH=src python -m repro_torch.launch.serve sweep --hw 24x32 \\
        --sensors 2 --duration 0.02 --chunk 512 --cmem 20 --retention 24 \\
        --classes 2 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve sensors --mesh 2 \\
        --hw 48x64 --duration 0.05 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve stream --mesh 2 \\
        --sensors 8 --shard-budget 2 --barrier-every 4

Every mode runs on the CUDA device unless ``--device`` names another.
``--mesh N`` (``sensors``, ``stream``) splits the slot pool into N
shards over every visible card, cycling over the cards when N exceeds
them (two shards on one card hold tensors of their own), or over N CPU
shards with ``--device cpu``; the run prints each shard's device and
the padded pool when padding was needed.  The reference's ``--backend``
has no counterpart: the tensors' device picks the kernels.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.events import aer, datasets
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.serve import spec as rs
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.ts_engine import TSEngineConfig, TimeSurfaceEngine


def run_tokens(args) -> None:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), device)
    engine = ServeEngine(cfg, params, max_len=args.max_len, device=device)

    rng = np.random.default_rng(0)
    reqs = [
        Request(rng.integers(0, cfg.vocab, rng.integers(4, 24)).astype(np.int32),
                max_new_tokens=args.new_tokens)
        for _ in range(args.requests)
    ]
    name = _device_name(device)
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(r.n_decoded for r in results)
    for i, r in enumerate(results):
        print(f"req {i}: prefill {r.n_prefill:3d} -> {r.tokens[:8]}...")
    print(f"{total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s batched on {name}, {device})")


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")


def _sync(devices) -> None:
    for device in dict.fromkeys(devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _mesh(args):
    """The ``--mesh N`` mesh (None without the flag), its placement
    printed."""
    if not args.mesh:
        return None
    mesh = make_host_mesh(args.mesh, device=args.device)
    print(f"mesh: {mesh.shape} -- {mesh.placement()}")
    return mesh


def _engine(cfg, device, mesh):
    """The engine over ``mesh`` (or on ``device``), with the padded pool
    printed where the shard count forced padding."""
    eng = TimeSurfaceEngine(cfg, device=device, mesh=mesh)
    if eng.n_slots_padded != cfg.n_slots:
        print(f"slot pool padded {cfg.n_slots} -> {eng.n_slots_padded} "
              f"for {mesh.size} shards")
    return eng


def run_sensors(args) -> None:
    try:
        h, w = (int(v) for v in args.hw.split("x"))
    except ValueError:
        raise SystemExit(
            f"--hw must be HxW (e.g. 240x320), got {args.hw!r}") from None
    device = resolve_device(args.device)
    mesh = _mesh(args)
    products = dict(surface=rs.surface(), mask=rs.mask(), stcf=rs.stcf(),
                    count=rs.count(4))
    if args.classify:
        products["logits"] = rs.classify(n_classes=args.classify, width=16)
        products["labels"] = rs.denoise()
    spec = rs.ReadoutSpec(**products)
    cfg = TSEngineConfig(h=h, w=w, n_slots=args.slots,
                         chunk_capacity=args.chunk, mode=args.mode,
                         specs=(spec,))
    eng = _engine(cfg, device, mesh)
    device = eng.device
    name = _device_name(device)

    kinds = ("hotel_bar", "driving")
    streams = [datasets.dnd21_like(kinds[i % 2], h=h, w=w,
                                   duration=args.duration, seed=i)
               for i in range(args.sensors)]
    cams = [eng.attach() for _ in streams]
    words = [aer.pack(s) for s in streams]
    for i, (cam, s) in enumerate(zip(cams, streams)):
        print(f"sensor {i}: slot {cam.slot}, {s.n} events "
              f"({kinds[i % 2]}-like)")

    t0 = time.perf_counter()
    eng.push(list(zip(cams, words)))
    out = eng.read(spec, args.duration)
    _sync(eng.shard_devices)
    dt = time.perf_counter() - t0
    n_total = sum(len(wd) for wd in words)
    print(f"push+read[{'+'.join(spec.names)}] {n_total} events over "
          f"{args.sensors} sensors in {dt * 1e3:.1f} ms "
          f"({n_total / dt / 1e6:.2f} M events/s on {name}, {device})")

    if args.bursts > 1:
        # the same sensors reconnect and stream their events in bursts, all
        # read at one frame deadline through the dirty-tile cache
        for cam in cams:
            cam.detach()
        cams = [eng.attach() for _ in streams]
        edges = np.linspace(0.0, args.duration, args.bursts + 1)
        for bi, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
            items = [(cam, aer.pack(s.window(lo, hi)))
                     for cam, s in zip(cams, streams)]
            t0 = time.perf_counter()
            surf = eng.serve_step(items, rs.SURFACE_SPEC,
                                  args.duration)["surface"]
            _sync(eng.shard_devices)
            print(f"fused burst {bi}: {sum(len(wd) for _, wd in items)} "
                  f"events in {(time.perf_counter() - t0) * 1e3:.1f} ms "
                  f"({'dense fill' if bi == 0 else 'incremental'})")
        dense = eng.read(rs.SURFACE_SPEC, args.duration)["surface"]
        same = torch.equal(surf.view(torch.int32), dense.view(torch.int32))
        print(f"fused surface bit-identical to dense readout: {same}")
        if not same:
            raise SystemExit("fused serve_step != dense read")
        out = eng.read(spec, args.duration)

    stats = eng.stats()
    unit = " V" if args.mode == "edram" else ""
    for i, cam in enumerate(cams):
        view = {k: v[cam.slot] for k, v in out.items()}
        print(f"sensor {i}: surface max {float(view['surface'].max()):.3f}"
              f"{unit}, window occupancy "
              f"{float(view['mask'].float().mean()):.4f}, active pixels "
              f"{int((view['count'] > 0).sum())}, events ingested "
              f"{stats['n_events'][cam.slot]}")
        if "logits" in spec:
            lg = view["logits"].cpu()
            print(f"          logits argmax {int(lg.argmax())} "
                  f"({np.array2string(lg.numpy(), precision=3)}), denoise "
                  f"keep rate {float(view['labels'].float().mean()):.4f}")


def _hw(arg: str):
    try:
        h, w = (int(v) for v in arg.split("x"))
    except ValueError:
        raise SystemExit(
            f"--hw must be HxW (e.g. 240x320), got {arg!r}") from None
    return h, w


def run_stream(args) -> None:
    import dataclasses

    from repro_torch.events import replay as rp
    from repro_torch.serve.stream import StreamConfig

    h, w = _hw(args.hw)
    device = resolve_device(args.device)
    mesh = _mesh(args)
    elastic = args.elastic or args.migrate_demo
    n_slots = max(args.slots, args.sensors)
    slot_bucket = None
    if elastic:
        # start small on purpose: the elastic policy grows the pool in
        # buckets as the attach waves arrive
        slot_bucket = n_slots = max(2, args.sensors // 3)
    cfg = TSEngineConfig(h=h, w=w, n_slots=n_slots,
                         chunk_capacity=args.chunk, mode=args.mode,
                         slot_bucket=slot_bucket)
    scfg = StreamConfig(policy=args.policy, queue_capacity=args.queue,
                        deadline_s=args.deadline,
                        step_chunk_budget=args.budget or None,
                        elastic=elastic,
                        shrink_watermark=0.9 if elastic else 0.0,
                        shard_budget=args.shard_budget or None,
                        shard_barrier_every=args.barrier_every)
    if args.migrate_demo:
        if args.mode != "edram":
            raise SystemExit("--migrate-demo needs --mode edram (the "
                             "gesture tier serves analog-fidelity specs)")
        # attach waves + a batch detach + live slot migrations, one on an
        # analog head-bearing tier: the fleet traffic
        feeds = rp.fleet_scene_feeds(h, w, args.duration, args.sensors,
                                     seed=args.seed)
    else:
        feeds = rp.mixed_scene_feeds(h, w, args.duration, args.sensors,
                                     seed=args.seed, churn=args.churn,
                                     tiered=args.tiers)
    spec = rs.SURFACE_SPEC
    if args.classify:
        head_spec = rs.ReadoutSpec(
            surface=rs.surface(),
            logits=rs.classify(n_classes=args.classify, width=16))
        if args.tiers:
            # per-tier model serving: the gesture tier carries the
            # head-bearing spec; telemetry keeps the plain surface
            for f in feeds:
                if f.qos.tier == "gesture":
                    f.qos = dataclasses.replace(f.qos, spec=head_spec)
        else:
            spec = head_spec
    for i, f in enumerate(feeds):
        detach = f"{f.detach_t * 1e3:.0f}ms" if f.detach_t else "end"
        tier = f" [{f.qos.tier} p{f.qos.priority}]" if args.tiers else ""
        mig = (f" ->{f.migrate[1].tier}@{f.migrate[0] * 1e3:.0f}ms"
               if f.migrate else "")
        mov = f" move@{f.move[0] * 1e3:.0f}ms" if f.move else ""
        print(f"feed {i}: {f.name:>12s} {f.stream.n:7d} events, "
              f"attach {f.attach_t * 1e3:.0f}ms -> {detach}{tier}{mig}{mov}")

    def make_engine():
        return TimeSurfaceEngine(cfg, device=device, mesh=mesh)

    if args.speed == 0:
        # a throwaway engine on the same traffic first, so the latency
        # percentiles measure steady state, not first-touch costs (paced
        # runs skip it: they want the honest cold-start timeline)
        rp.replay(make_engine(), feeds, scfg, spec,
                  arrival_substeps=args.substeps)
    eng = _engine(cfg, device, mesh)
    report = rp.replay(eng, feeds, scfg, spec, speed=args.speed,
                       arrival_substeps=args.substeps)
    where = device if mesh is None else mesh.placement()
    print(f"stream on {_device_name(eng.device)} ({where}):")
    print(report.summary())
    if elastic:
        fleet = [(k, e) for k, e in report.log
                 if k in ("grow", "shrink", "migrate")]
        desc = ", ".join(
            f"grow->{e}" if k == "grow"
            else f"shrink->{e[0]} moves={e[1]}" if k == "shrink"
            else f"migrate {e[0]}->{e[1]}"
            for k, e in fleet)
        print(f"fleet ops: {desc or 'none'}")
        print(f"final capacity {eng.capacity} "
              f"(padded {eng.n_slots_padded}), "
              f"migrated events {report.migrated}")
    if args.classify:
        # the engine retains the final deadline's state: sample the
        # served logits (per-tier spec under --tiers, default otherwise)
        out = eng.read(head_spec, report.n_steps * scfg.deadline_s)
        lg = out["logits"].cpu().numpy()
        print("classify logits argmax per slot: "
              f"{lg.argmax(axis=-1).tolist()}")
    if args.tiers:
        print(f"{'tier':>10s} {'offered':>9s} {'ingested':>9s} "
              f"{'dropped':>9s} {'deferred':>9s} {'p99':>10s} "
              f"{'SLO':>8s}  verdict")
        for tier, row in sorted(report.tiers.items()):
            p99 = row.get("latency_p99_us")
            slo = row.get("slo_p99_us")
            p99s = f"{p99 / 1e3:.2f}ms" if p99 is not None else "n/a"
            slos = f"{slo / 1e3:.0f}ms" if slo is not None else "none"
            ok = (p99 is not None and slo is not None and p99 <= slo)
            verdict = "within SLO" if ok else "CHECK"
            print(f"{tier:>10s} {row['offered']:9d} {row['ingested']:9d} "
                  f"{row['dropped']:9d} {row['deferred']:9d} "
                  f"{p99s:>10s} {slos:>8s}  {verdict}")
    if not args.no_oracle:
        n = rp.check_oracle(report, make_engine, spec)
        print(f"bitwise oracle gate: OK over {n} deadlines "
              "(head logits digest-chained)" if args.classify else
              f"bitwise oracle gate: OK over {n} deadlines")


def _sweep_spec(fid, n_classes):
    """The sweep's serving contract: analog-decayed surface + STCF
    denoise labels + CNN logits in one spec."""
    return rs.ReadoutSpec(
        surface=rs.surface(fidelity=fid),
        stcf=rs.stcf(decay=rs.surface(fidelity=fid)),
        labels=rs.denoise(input="stcf"),
        logits=rs.classify(n_classes=n_classes, width=16),
    )


def _pareto(rows):
    """Rows not dominated on (energy/event lower, agreement higher)."""
    front = []
    for r in rows:
        dominated = any(
            o is not r
            and o["energy_per_event_nj"] <= r["energy_per_event_nj"]
            and o["denoise_agreement"] >= r["denoise_agreement"]
            and (o["energy_per_event_nj"] < r["energy_per_event_nj"]
                 or o["denoise_agreement"] > r["denoise_agreement"])
            for o in rows
        )
        if not dominated:
            front.append(r)
    return sorted(front, key=lambda r: r["energy_per_event_nj"])


def run_sweep(args) -> dict:
    """Run the grid; write ``sweep.json`` and ``sweep.md`` under
    ``args.out``; print one row per run and the verdict line.  Returns
    the JSON document."""
    import json
    import pathlib

    from repro_torch.events import replay as rp
    from repro_torch.serve import fidelity as fm
    from repro_torch.serve.stream import StreamConfig

    h, w = _hw(args.hw)
    device = resolve_device(args.device)
    cmems = [float(v) * 1e-15 for v in args.cmem.split(",")]
    windows = [float(v) * 1e-3 for v in args.retention.split(",")]
    fid_for = {"ideal": None, "analog_3d": fm.analog_3d(),
               "analog_2d": fm.analog_2d()}
    scfg = StreamConfig(policy="drop_oldest", queue_capacity=1 << 13,
                        deadline_s=args.deadline, pipeline=True)

    rows = []
    for cmem in cmems:
        for tw in windows:
            ref = None  # the grid point's digital run
            for mode, fid in fid_for.items():
                spec = _sweep_spec(fid, args.classes)
                cfg = TSEngineConfig(
                    h=h, w=w, n_slots=args.sensors + 2,
                    chunk_capacity=args.chunk, mode="edram",
                    cmem_f=cmem, tau_tw=tw, specs=(spec,),
                )
                eng = TimeSurfaceEngine(cfg, device=device)
                # identical traffic per mode: ingest is fidelity-blind, so
                # the SAE state matches and the readouts are comparable
                feeds = rp.mixed_scene_feeds(h, w, args.duration,
                                             args.sensors, seed=args.seed)
                report = rp.replay(eng, feeds, scfg, spec,
                                   arrival_substeps=2)
                out = eng.read(spec, report.n_steps * scfg.deadline_s,
                               noise_step=report.n_steps)
                lab = out["labels"].cpu().numpy()
                lg = out["logits"].cpu().numpy()
                act = torch.isfinite(eng.state.surfaces.sae).cpu().numpy()
                while act.ndim > lab.ndim:   # fold polarity planes
                    act = act.any(axis=1)
                live = act.reshape(act.shape[0], -1).any(axis=1)
                if ref is None:
                    ref = (lab, lg)
                agree = (float((lab[act] == ref[0][act]).mean())
                         if act.any() else 1.0)
                drift = float(np.abs(lg - ref[1]).max())
                am = (float((lg[live].argmax(-1)
                             == ref[1][live].argmax(-1)).mean())
                      if live.any() else 1.0)
                nj = report.energy_uj.get("energy_per_event_nj") or 0.0
                rows.append(dict(
                    cmem_ff=cmem * 1e15, retention_ms=tw * 1e3, mode=mode,
                    denoise_agreement=agree, logit_max_drift=drift,
                    argmax_agreement=am, energy_per_event_nj=nj,
                    ingested=report.ingested,
                ))
                print(f"cmem {cmem*1e15:5.1f}fF  tw {tw*1e3:5.1f}ms  "
                      f"{mode:>9s}: denoise agree {agree:.4f}  "
                      f"logit drift {drift:.4f}  argmax {am:.3f}  "
                      f"{nj:.4f} nJ/event")
    # energy ratio vs the same grid point's digital run
    ideal_nj = {(r["cmem_ff"], r["retention_ms"]): r["energy_per_event_nj"]
                for r in rows if r["mode"] == "ideal"}
    for r in rows:
        base = ideal_nj[(r["cmem_ff"], r["retention_ms"])]
        r["energy_ratio_vs_ideal"] = (
            base / r["energy_per_event_nj"] if r["energy_per_event_nj"]
            else float("inf"))

    a3 = [r for r in rows if r["mode"] == "analog_3d"]
    a2 = [r for r in rows if r["mode"] == "analog_2d"]
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    verdicts = {
        "analog_3d_within_tol": all(
            r["denoise_agreement"] >= 1.0 - args.tol for r in a3),
        "analog_3d_energy_factor": min(
            r["energy_ratio_vs_ideal"] for r in a3),
        "analog_3d_energy_ok": all(
            r["energy_ratio_vs_ideal"] >= args.energy_factor for r in a3),
        "analog_2d_worse_than_3d": (
            mean([r["denoise_agreement"] for r in a2])
            < mean([r["denoise_agreement"] for r in a3])),
    }
    front = _pareto(rows)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    doc = dict(hw=args.hw, duration=args.duration, sensors=args.sensors,
               seed=args.seed, device=f"{_device_name(device)} ({device})",
               rows=rows, verdicts=verdicts,
               frontier=[dict(r) for r in front])
    (out_dir / "sweep.json").write_text(json.dumps(doc, indent=2) + "\n")
    hdr = ("| cmem (fF) | retention (ms) | mode | denoise agree | "
           "logit drift | argmax agree | nJ/event | vs digital |\n"
           "|---|---|---|---|---|---|---|---|\n")
    fmt = ("| {cmem_ff:.1f} | {retention_ms:.1f} | {mode} | "
           "{denoise_agreement:.4f} | {logit_max_drift:.4f} | "
           "{argmax_agreement:.3f} | {energy_per_event_nj:.4f} | "
           "{energy_ratio_vs_ideal:.0f}x |\n")
    md = ["# Accuracy-vs-energy sweep\n\n",
          f"`{args.hw}`, {args.sensors} sensors, {args.duration}s "
          f"mixed-scene traffic, seed {args.seed}, on "
          f"{_device_name(device)} ({device}).\n\n", hdr]
    md += [fmt.format(**r) for r in rows]
    md += ["\n## Frontier (Pareto: lower energy, higher accuracy)\n\n", hdr]
    md += [fmt.format(**r) for r in front]
    md += ["\n## Verdicts\n\n"]
    md += [f"- analog_3d denoise within {args.tol:.0%} of digital: "
           f"**{verdicts['analog_3d_within_tol']}**\n",
           f"- analog_3d energy/event >= {args.energy_factor:.0f}x lower "
           f"than digital: **{verdicts['analog_3d_energy_ok']}** "
           f"(min {verdicts['analog_3d_energy_factor']:.0f}x)\n",
           f"- analog_2d measurably worse (half-select): "
           f"**{verdicts['analog_2d_worse_than_3d']}**\n"]
    (out_dir / "sweep.md").write_text("".join(md))
    print(f"wrote {out_dir / 'sweep.json'} and {out_dir / 'sweep.md'}")
    print(f"verdicts: analog_3d within {args.tol:.0%}: "
          f"{verdicts['analog_3d_within_tol']}  |  energy >= "
          f"{args.energy_factor:.0f}x: {verdicts['analog_3d_energy_ok']} "
          f"(min {verdicts['analog_3d_energy_factor']:.0f}x)  |  "
          f"analog_2d worse: {verdicts['analog_2d_worse_than_3d']}")
    return doc


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)
    tok = sub.add_parser("tokens", help="batched LM prefill + greedy decode")
    tok.add_argument("--arch", required=True)
    tok.add_argument("--reduced", action="store_true",
                     help="the arch's smoke-test-sized config")
    tok.add_argument("--requests", type=int, default=4)
    tok.add_argument("--new-tokens", type=int, default=16)
    tok.add_argument("--max-len", type=int, default=128)
    tok.add_argument("--device", default=None,
                     help="torch device (default: the CUDA device)")
    sp = sub.add_parser("sensors", help="multi-sensor time-surface serving")
    sp.add_argument("--sensors", type=int, default=4)
    sp.add_argument("--slots", type=int, default=8)
    sp.add_argument("--hw", default="120x160", help="HxW, e.g. 240x320")
    sp.add_argument("--duration", type=float, default=0.2)
    sp.add_argument("--chunk", type=int, default=4096)
    sp.add_argument("--mode", choices=("edram", "ideal"), default="edram")
    sp.add_argument("--classify", type=int, default=0, metavar="C",
                    help="serve the stage-1 heads in the same spec: C-class "
                         "CNN logits over the surface plus STCF denoise "
                         "labels (0 disables)")
    sp.add_argument("--bursts", type=int, default=4, metavar="B",
                    help="stream each sensor in B bursts through the cached "
                         "serve_step at one frame deadline (0/1 disables)")
    sp.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the slot pool over N shards: every visible "
                         "card, cycling when N exceeds them, or N CPU "
                         "shards with --device cpu (0 = no mesh)")
    sp.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")

    st = sub.add_parser("stream", help="real-time streaming runtime replay")
    st.add_argument("--sensors", type=int, default=4)
    st.add_argument("--slots", type=int, default=8)
    st.add_argument("--hw", default="120x160", help="HxW, e.g. 240x320")
    st.add_argument("--duration", type=float, default=0.1,
                    help="virtual seconds of traffic to replay")
    st.add_argument("--deadline", type=float, default=0.01, metavar="S",
                    help="readout deadline / microbatch flush period")
    st.add_argument("--policy", choices=("block", "drop_oldest",
                                         "drop_newest"),
                    default="block", help="ingress-queue overload policy")
    st.add_argument("--queue", type=int, default=1 << 15,
                    help="per-sensor ingress queue capacity (events)")
    st.add_argument("--speed", type=float, default=0.0,
                    help="pacing vs real time (0 = as fast as possible)")
    st.add_argument("--substeps", type=int, default=4,
                    help="arrival granules per deadline")
    st.add_argument("--churn", action="store_true",
                    help="mid-run sensor attach/detach")
    st.add_argument("--tiers", action="store_true",
                    help="QoS demo: glyph feeds connect as the gesture "
                         "tier, the rest as telemetry (with --churn some "
                         "migrate mid-run); prints the per-tier SLO table")
    st.add_argument("--budget", type=int, default=0, metavar="N",
                    help="step chunk budget: >0 caps engine chunks per "
                         "deadline so overload triggers priority "
                         "preemption (0 = unlimited)")
    st.add_argument("--chunk", type=int, default=4096)
    st.add_argument("--mode", choices=("edram", "ideal"), default="edram")
    st.add_argument("--classify", type=int, default=0, metavar="C",
                    help="stream C-class CNN logits: with --tiers the "
                         "gesture tier carries the head-bearing spec, "
                         "otherwise every deadline serves it (0 disables)")
    st.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the slot pool over N shards: every visible "
                         "card, cycling when N exceeds them, or N CPU "
                         "shards with --device cpu (0 = no mesh)")
    st.add_argument("--elastic", action="store_true",
                    help="elastic slot pool: start at one bucket of "
                         "max(2, sensors // 3) slots and let connect() grow "
                         "it (auto-shrink when occupancy falls)")
    st.add_argument("--migrate-demo", action="store_true",
                    help="fleet demo (implies --elastic): staggered attach "
                         "waves grow the pool, a batch detach shrinks it "
                         "with live-slot compaction, and three sensors "
                         "slot-migrate live (one on an analog head-bearing "
                         "tier), all bitwise through the replay oracle")
    st.add_argument("--shard-budget", type=int, default=0, metavar="N",
                    help=">0 caps engine chunks per pool shard per deadline "
                         "(one shard without --mesh), priority claims a hot "
                         "shard first (0 = unlimited)")
    st.add_argument("--barrier-every", type=int, default=0, metavar="K",
                    help=">0 makes every Kth deadline a barrier step: shard "
                         "budgets lift and the shard clocks re-sync "
                         "(0 disables)")
    st.add_argument("--seed", type=int, default=0)
    st.add_argument("--no-oracle", action="store_true",
                    help="skip the synchronous bitwise oracle gate")
    st.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")

    sw = sub.add_parser("sweep", help="accuracy-vs-energy fidelity sweep")
    sw.add_argument("--hw", default="48x64", help="HxW, e.g. 120x160")
    sw.add_argument("--sensors", type=int, default=4)
    sw.add_argument("--duration", type=float, default=0.06,
                    help="virtual seconds of traffic per run")
    sw.add_argument("--deadline", type=float, default=0.005)
    sw.add_argument("--chunk", type=int, default=2048)
    sw.add_argument("--cmem", default="10,20", metavar="FF,FF",
                    help="comma-separated cell capacitances in fF")
    sw.add_argument("--retention", default="12,24", metavar="MS,MS",
                    help="comma-separated STCF retention windows in ms")
    sw.add_argument("--classes", type=int, default=4,
                    help="CNN head classes for the logit-drift probe")
    sw.add_argument("--tol", type=float, default=0.02,
                    help="denoise-agreement tolerance for the analog_3d "
                         "verdict (paper: within 2%% of digital)")
    sw.add_argument("--energy-factor", type=float, default=10.0,
                    help="required digital/analog energy-per-event ratio")
    sw.add_argument("--out", default="artifacts",
                    help="directory for sweep.json / sweep.md")
    sw.add_argument("--seed", type=int, default=0)
    sw.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    {"tokens": run_tokens, "sensors": run_sensors, "stream": run_stream,
     "sweep": run_sweep}[args.command](args)


if __name__ == "__main__":
    main()
