"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1> [--out DIR]

from the root of a checkout.  Everything is found by name (``load``):
the cell in ``BENCHMARK.json``, its ``workloads/<cell>.json`` and
``configs/<config>.json``, the loop the workload names, the reference
of its configuration and one reader a metric.  ``--trace 0`` prints the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics, with the
profiled call's ``busy_s``, ``window_s`` and ``breakdown``.  The last
line of standard output is the result; the card's state (``nvidia-smi``,
read once the window has closed, so that it costs set-up nothing) is
printed on an earlier line and, with the whole run, written to
``DIR/<cell>.seed<n>.trace<t>.json`` (default ``bench-out/perfbench``).

Exits with another code than 0, printing no result, when no card (or
fewer than the cell asks for) is visible, when the program is not in
this checkout, and when the process holds ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import cardstate, load  # noqa: E402

#: top-level module names that the process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(SystemExit):
    """A run that prints no result: the message goes to standard error."""

    def __init__(self, code: int, msg: str):
        print(f"perfbench: {msg}", file=sys.stderr)
        super().__init__(code)


def seconds_since_start() -> float:
    """Seconds since this process started, from ``/proc`` (both readings
    count from boot, to 10 ms)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, and no JAX pulled in by a library."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def import_program(root: Path = ROOT):
    src = root / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    try:
        import repro_torch
    except ImportError as e:
        raise Refused(5, f"the program is not in this checkout: {e}")
    where = Path(repro_torch.__file__).resolve()
    if src.resolve() not in where.parents:
        raise Refused(5, f"repro_torch comes from {where}, not from {src}")
    return repro_torch


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", default=str(ROOT / "bench-out" / "perfbench"))
    return p.parse_args(argv)


def limits_check(numbers: dict, limits: dict) -> dict:
    """Each number the workload gives a limit, beside its limit, and
    ``altered``, which is exact (limit 0)."""
    return {k: {"value": numbers[k], "limit": lim}
            for k, lim in dict(limits, altered=0).items()}


def verdict(numbers: dict, limits: dict, failed: int = 0):
    """``(checks, correct)``: ``correct`` when no request failed, some
    served token was compared and every number is within its limit."""
    checks = limits_check(numbers, limits)
    correct = (failed == 0 and numbers["tokens"] > 0
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    return checks, bool(correct)


def main(argv=None, device=None, shrink=None, fault=None, wl_patch=None):
    """One run; returns the result dict (also printed).  ``device``,
    ``shrink`` and ``fault`` are for the CPU tests: a device skips the
    look for a card, ``shrink`` replaces configuration keys in both the
    program and the reference, ``fault`` breaks the timed path and
    ``wl_patch`` replaces workload keys (smaller batches)."""
    args = parse(argv)
    bench = load.benchmark()
    entry = load.cell(bench, args.workload)
    wl = dict(load.workload(args.workload), **(wl_patch or {}))
    cfg = load.config(entry["config"])
    if wl["config"] != entry["config"]:
        raise Refused(6, f"{args.workload}: the workload file names "
                      f"{wl['config']}, BENCHMARK.json {entry['config']}")
    import torch

    if device is None:
        chips = int(entry["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise Refused(3, f"{args.workload} needs {chips} CUDA card(s); "
                          f"{n} visible")
        device = torch.device("cuda", 0)
        kind, platform = torch.cuda.get_device_name(device), "gpu"
    else:
        device = torch.device(device)
        kind, platform, chips = device.type, device.type, 1
    import_program()
    drv = load.loop(wl["loop"])
    cell = drv.Cell(wl, cfg, args.seed, device, shrink=shrink, fault=fault)
    cell.setup(trace=bool(args.trace))
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    try:
        setup_s = seconds_since_start()
    except (OSError, ValueError, IndexError):
        setup_s = None
    ctx = cell.window(args.seconds)
    ctx["setup_s"] = setup_s
    card = cardstate.read() if on_card else None
    peak = max(setup_peak, ctx["peak_bytes"])
    cell.close()
    numbers = cell.check()
    metrics = {}
    for m in load.metrics_of(bench, args.workload, bool(args.trace)):
        v = load.metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": platform, "kind": kind, "count": chips,
           "memory_peak_bytes": int(peak)}
    t = ctx.get("trace")
    if args.trace and t:
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
    checks, correct = verdict(numbers, wl["limits"], ctx["failed"])
    result = {"correct": correct, "attempted": ctx["attempted"],
              "failed": ctx["failed"], "metrics": metrics, "device": dev}
    if args.trace and t:
        from perfbench import trace as TR

        result["breakdown"] = TR.breakdown(t)
    result["checks"] = checks
    found = forbidden_modules()
    if found:
        raise Refused(4, f"the process holds {found} after the window")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    record = dict(result, card=card,
                  args=vars(args), compared=numbers,
                  serve_s=[r["t1"] - r["t0"] for r in ctx["records"]],
                  window_s=ctx["window_s"], setup_s=setup_s,
                  scans=len(ctx.get("scans") or ()),
                  kernels=sorted((t or {}).get("by_kernel", {}).items(),
                                 key=lambda kv: -kv[1])[:40])
    (out / f"{args.workload}.seed{args.seed}.trace{args.trace}.json"
     ).write_text(json.dumps(record, indent=1))
    print(json.dumps({"card": card}), flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check compared {numbers['requests']} requests, "
          f"{numbers['tokens']} served tokens", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    cache_env()
    main()
