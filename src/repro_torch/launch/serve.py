"""Serving launcher of the port: the ``tokens`` and ``sensors`` modes.

  * ``tokens``  -- batched LM prefill + greedy decode on an arch config,
                   with weights drawn from a seeded ``torch.Generator``;
  * ``sensors`` -- the multi-sensor time-surface engine: seeded
                   DND21-like AER streams in, surfaces, comparator masks,
                   STCF support and counts out; ``--classify C`` adds the
                   stage-1 heads (C-class CNN logits over the surface,
                   STCF denoise labels) to the same spec.

    PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
        --arch mamba2-2.7b --requests 4 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
        --arch mamba2-2.7b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve sensors \\
        --sensors 4 --hw 240x320 --classify 10
    PYTHONPATH=src python -m repro_torch.launch.serve sensors \\
        --hw 48x64 --duration 0.05 --classify 3 --device cpu

It runs on the CUDA device unless ``--device`` names another.  Not
ported yet (ROADMAP.md, queue 1): the reference's ``stream`` and
``sweep`` modes, and ``sensors --mesh`` (the device mesh).  The
reference's ``--backend`` has no counterpart: the tensors' device picks
the kernels.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.events import aer, datasets
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
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(T.param_defs(cfg), gen, device)
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_sensors(args) -> None:
    try:
        h, w = (int(v) for v in args.hw.split("x"))
    except ValueError:
        raise SystemExit(
            f"--hw must be HxW (e.g. 240x320), got {args.hw!r}") from None
    device = resolve_device(args.device)
    products = dict(surface=rs.surface(), mask=rs.mask(), stcf=rs.stcf(),
                    count=rs.count(4))
    if args.classify:
        products["logits"] = rs.classify(n_classes=args.classify, width=16)
        products["labels"] = rs.denoise()
    spec = rs.ReadoutSpec(**products)
    cfg = TSEngineConfig(h=h, w=w, n_slots=args.slots,
                         chunk_capacity=args.chunk, mode=args.mode,
                         specs=(spec,))
    eng = TimeSurfaceEngine(cfg, device=device)
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
    _sync(device)
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
            _sync(device)
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
    sp.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    (run_tokens if args.command == "tokens" else run_sensors)(args)


if __name__ == "__main__":
    main()
