"""Aggregate the port's dry-run and roofline JSON (``launch.dryrun`` /
``launch.roofline`` ``--out``) into two markdown tables.

The port of ``repro.launch.report``.  The dry-run table's columns follow
the port's record keys: no XLA live or temp bytes (eager PyTorch has no
buffer assignment), the bytes accessed beside the FLOPs, and the
capacity model against one H100's 80 GB in place of the v5e's 16 GB.

    PYTHONPATH=src python -m repro_torch.launch.report \
        --dryrun dryrun_torch_results --roofline roofline_torch_results
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

GIB = 1024**3


def _load(d: str) -> List[Dict]:
    out = []
    for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(fn) as f:
            out.append(json.load(f))
    return out


def dryrun_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | GFLOP/dev | GB/dev | coll GB/dev "
        "| capacity GiB | fits 80 GB |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"].startswith("skipped"):
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} "
                "| — | — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | | | | | |")
            continue
        cap = r["capacity_model"]["total"] / GIB
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok "
            f"| {r['flops_per_device']/1e9:.0f} "
            f"| {r['bytes_per_device']/1e9:.2f} "
            f"| {r['collective_bytes_per_device']/1e9:.2f} "
            f"| {cap:.1f} | {'Y' if r['fits_80GB'] else 'N'} |")
    return "\n".join(lines)


def roofline_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | compute ms | memory ms | collective ms | bottleneck "
        "| MODEL/counted | roofline % |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"].startswith("skipped"):
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                         f"{r['status']} | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | |")
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['compute_s']*1e3:.2f} | {r['memory_s']*1e3:.2f} "
            f"| {r['collective_s']*1e3:.2f} | {r['bottleneck']} "
            f"| {r['model_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']*100:.1f} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="dryrun_torch_results")
    ap.add_argument("--roofline", default="roofline_torch_results")
    args = ap.parse_args()
    if os.path.isdir(args.dryrun):
        print("## Dry-run table\n")
        print(dryrun_table(_load(args.dryrun)))
        print()
    if os.path.isdir(args.roofline):
        print("## Roofline table\n")
        print(roofline_table(_load(args.roofline)))


if __name__ == "__main__":
    main()
