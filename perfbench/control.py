"""The readings that the limits of ``correct`` are set from.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 ... \\
        [--batches N] [--out FILE]

For each seed, in one process: the cell's weights and engine from the
seed, ``N`` batches of the cell's own traffic served (every row's logits
kept; by default as many requests as a run of ``run_seconds`` compares),
the engine dropped, then the float32 reference and the control over the
same prompts and served tokens.  The control is the reference in the
program's place one precision below the configuration's: every weight
product's operands in float8 e4m3 (``reference/common.py``).  Prints
one JSON line a seed: the program's ``gap``, ``gap_mean``,
``rel_err``, ``rel_err_p75``, ``altered`` (its sound readings: their
largest is the lower reading) and the control's ``ctl_`` readings of the
same (their smallest is the upper); then both sides judged as a run
judges them (``run.verdict``) at the limits in the cell's workload file:
``correct`` and ``ctl_correct``, each number beside its limit.  Exits
with 1 when the control comes out correct on any seed, or the program
not correct.  Runs on the card only.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import load, run  # noqa: E402

#: requests a run compares, about: 3 sampled rows of each of ~15 batches
COMPARED = 45
#: the numbers read on both the program and the control
NUMBERS = ("gap", "gap_mean", "rel_err", "rel_err_p75")


def judged(r: dict, limits: dict) -> dict:
    """One seed's readings with both sides judged at ``limits``.  The
    control serves the token it ranks first, so it alters none."""
    ctl = {k[4:]: v for k, v in r.items() if k.startswith("ctl_")}
    ctl.update(altered=0, tokens=r["tokens"])
    checks, ok = run.verdict(r, limits)
    ctl_checks, ctl_ok = run.verdict(ctl, limits)
    return dict(r, correct=ok, ctl_correct=ctl_ok, checks=checks,
                ctl_checks=ctl_checks)


def readings(wl: dict, cfg: dict, seed: int, batches: int, device,
             shrink=None) -> dict:
    """One seed's readings of the program and of the control."""
    import torch

    drv = load.loop(wl["loop"])
    t0 = time.perf_counter()
    cell = drv.Cell(wl, cfg, seed, device, shrink=shrink)
    cell.setup(trace=False, capture_rows=0)
    cell.serve_batches(batches)
    t1 = time.perf_counter()
    cell.close()
    out = cell.check(fp8_control=True)
    out.update(seed=seed, batches=batches, serve_s=t1 - t0,
               check_s=time.perf_counter() - t1)
    del cell
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--batches", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise run.Refused(3, "the control runs on the card; none is visible")
    run.import_program()
    wl = load.workload(args.workload)
    cfg = load.config(wl["config"])
    n = args.batches or math.ceil(COMPARED / wl["batch"])
    rows = []
    for seed in args.seeds:
        r = judged(readings(wl, cfg, seed, n, torch.device("cuda", 0)),
                   wl["limits"])
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {
        "workload": args.workload, "seeds": len(rows),
        "lower": {k: max(r[k] for r in rows) for k in NUMBERS},
        "upper": {k: min(r["ctl_" + k] for r in rows) for k in NUMBERS},
        "altered": sum(r["altered"] for r in rows),
        "limits": wl["limits"],
        "program_correct": sum(r["correct"] for r in rows),
        "control_correct": sum(r["ctl_correct"] for r in rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}, indent=1))
    lower = dict(summary["lower"], altered=summary["altered"])
    upper = dict(summary["upper"], altered=0)
    for k, lim in dict(wl["limits"], altered=0).items():
        print(f"check {k}: program up to {lower[k]!r}, control from "
              f"{upper[k]!r}, limit {lim!r}", file=sys.stderr)
    if summary["control_correct"] or summary["program_correct"] < len(rows):
        raise SystemExit(1)


if __name__ == "__main__":
    run.cache_env()
    main()
