"""Three-term roofline analysis from the dry run's counts, against one
NVIDIA H100 SXM (``hw.constants.H100_SXM``).

Per (arch x shape x mesh):

    compute    = FLOPs_dev / peak bf16 FLOP/s of a card      [s]
    memory     = bytes_dev / HBM bytes/s of a card           [s]
    collective = coll_bytes_dev / one NVLink's bytes/s       [s]

The port of ``repro.launch.roofline``.  The counts are one rank's, from
``launch.dryrun``'s counted step on meta tensors, so the terms divide by
one card's peaks.  The reference corrects XLA's counts, which take a
``lax.scan`` body once, with per-layer-kind probes (``corrected_costs``).
The port's step is eager: every layer and microbatch runs and is counted,
so the direct count is exact, and ``run_cell`` uses it.  The probes are
kept as they are, and agree with it: their FLOPs equal the direct count
for every cell, and their bytes and collectives do too for prefill and
for a decode of uniform layers.  A train probe of one microbatch also
counts the once-a-step optimizer update and data-rank sums once per
microbatch, and a probe of one layer kind decodes through
``decode_step_scan`` where mixed layers run ``decode_step``, so their
bytes differ by a few per cent.

Two caveats of the bound: the port's float32 contractions (attention's
QK and PV products, the unembedding, the SSD's contractions) run off the
tensor cores at 67 TFLOP/s, not 989, so the compute term is optimistic
for them; and one NVLink's rate is optimistic for an axis whose ranks
sit on other hosts.  ``roofline_fraction`` keeps the reference's
definition: useful FLOPs (``model_flops``) at the bf16 peak over the
bound.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.roofline --all --out roofline_torch_results
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import warnings
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.hw.constants import H100_SXM
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh


# ----------------------------------------------------------------------------
# Probe configs: n layers of a single kind
# ----------------------------------------------------------------------------

def probe_config(cfg: ModelConfig, kind: str, n_layers: int) -> ModelConfig:
    """A config with ``n_layers`` layers, all of layer-kind ``kind``."""
    over: Dict[str, Any] = dict(
        n_layers=n_layers, n_microbatches=1, scan_layers=False,
    )
    if cfg.family == "hybrid":
        over["global_attn_layers"] = (
            tuple(range(n_layers)) if kind == "hybrid_global" else ()
        )
    else:
        over["attn_pattern"] = (kind,)
    return dataclasses.replace(cfg, **over)


def probe_shape(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[ShapeSpec, int]:
    """(probe shape, multiplier): train probes use one microbatch."""
    if shape.kind == "train" and cfg.n_microbatches > 1:
        nm = cfg.n_microbatches
        return dataclasses.replace(
            shape, global_batch=shape.global_batch // nm
        ), nm
    return shape, 1


def _costs(a: Dict[str, Any]) -> Dict[str, float]:
    return {"flops": a["flops_per_device"], "bytes": a["bytes_per_device"],
            "coll": a["collective_bytes_per_device"]}


def _probe_cost(cfg, shape, mesh) -> Dict[str, float]:
    counts, _ = D.lower_cell(cfg, shape, mesh)
    return _costs(D.analyze(counts))


def corrected_costs(
    cfg: ModelConfig, shape: ShapeSpec, mesh,
) -> Dict[str, float]:
    """Per-device totals from per-layer-kind probes:
    ``mult * (E + sum_k n_k * D_k)``, ``D_k`` = cost(2 layers of kind k)
    - cost(1), ``E`` = cost(1 layer of the first kind) - its ``D``."""
    pshape, mult = probe_shape(cfg, shape)
    kinds = cfg.layer_kinds()
    kind_counts: Dict[str, int] = {}
    for k in kinds:
        kind_counts[k] = kind_counts.get(k, 0) + 1

    deltas: Dict[str, Dict[str, float]] = {}
    base: Optional[Dict[str, float]] = None
    for k in kind_counts:
        c1 = _probe_cost(probe_config(cfg, k, 1), pshape, mesh)
        c2 = _probe_cost(probe_config(cfg, k, 2), pshape, mesh)
        deltas[k] = {m: c2[m] - c1[m] for m in c1}
        if base is None:
            base = {m: c1[m] - deltas[k][m] for m in c1}  # embed+head+loss

    total = dict(base)
    for k, n in kind_counts.items():
        for m in total:
            total[m] += n * deltas[k][m]
    return {m: mult * v for m, v in total.items()}


# ----------------------------------------------------------------------------
# Model FLOPs (the "useful work" yardstick)
# ----------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """6*N*D (train) / 2*N*B (decode) / 2*N*D (prefill), active params."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: per step


# ----------------------------------------------------------------------------
# Roofline terms
# ----------------------------------------------------------------------------

def roofline_terms(
    flops_dev: float, bytes_dev: float, coll_dev: float, n_chips: int,
) -> Dict[str, float]:
    hw = H100_SXM
    t_comp = flops_dev / hw.peak_flops_bf16
    t_mem = bytes_dev / hw.hbm_bandwidth
    t_coll = coll_dev / hw.link_bandwidth
    dom = max(("compute", t_comp), ("memory", t_mem), ("collective", t_coll),
              key=lambda kv: kv[1])
    return {
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "bottleneck": dom[0], "step_time_lb_s": dom[1],
    }


def roofline_fraction(mf: float, n_chips: int, step_time_s: float) -> float:
    """Useful FLOPs a card at the bf16 peak over ``step_time_s`` (the
    bound, or a measured step)."""
    t_useful = mf / n_chips / H100_SXM.peak_flops_bf16
    return t_useful / step_time_s if step_time_s else 0.0


def _load_dryrun(arch: str, shape_name: str, multi_pod: bool,
                 dryrun_dir: Optional[str]) -> Optional[Dict[str, Any]]:
    if not dryrun_dir:
        return None
    fn = os.path.join(dryrun_dir,
                      f"{arch}__{shape_name}__{'mp' if multi_pod else 'sp'}.json")
    if not os.path.exists(fn):
        return None
    with open(fn) as f:
        rec = json.load(f)
    return rec if rec.get("status") == "ok" else None


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             with_probes: bool = True,
             dryrun_dir: Optional[str] = None) -> Dict[str, Any]:
    """One cell's roofline from the direct count (reused from a dry
    run's ``--out`` directory when it has the cell); ``with_probes``
    also records ``corrected_costs`` as ``probe_costs`` beside it."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = D.shape_applicable(cfg, shape)
    n_chips = 512 if multi_pod else 256
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec["status"] = reason
        return rec
    try:
        with D.fake_world(n_chips), warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
            main = _load_dryrun(arch, shape_name, multi_pod, dryrun_dir)
            if main is None:
                counts, _ = D.lower_cell(cfg, shape, mesh)
                main = D.analyze(counts)
            rec["collective_schedule"] = main["collectives"]
            rec["kernels"] = main["kernels"]    # the meta routes' charges
            costs = _costs(main)
            rec["corrected"] = True    # the eager count is exact
            if with_probes:
                rec["probe_costs"] = corrected_costs(cfg, shape, mesh)
            rec.update({f"{k}_per_device": v for k, v in costs.items()})
            rec.update(roofline_terms(costs["flops"], costs["bytes"],
                                      costs["coll"], n_chips))
            mf = model_flops(cfg, shape)
            rec["model_flops"] = mf
            total = costs["flops"] * n_chips
            rec["model_flops_ratio"] = mf / total if total else 0.0
            rec["roofline_fraction"] = roofline_fraction(
                mf, n_chips, rec["step_time_lb_s"])
            rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001
        rec["status"] = f"error: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--dryrun-dir", default=None,
                    help="reuse the counts of a dryrun --out directory")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = ARCH_NAMES if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    for a in archs:
        for s in shapes:
            t0 = time.time()
            rec = run_cell(a, s, args.multi_pod, not args.no_probes,
                           dryrun_dir=args.dryrun_dir)
            rec["wall_s"] = time.time() - t0
            if rec["status"] == "ok":
                print(f"{a} x {s} [{rec['mesh']}]: comp={rec['compute_s']*1e3:.2f}ms "
                      f"mem={rec['memory_s']*1e3:.2f}ms coll={rec['collective_s']*1e3:.2f}ms "
                      f"-> {rec['bottleneck']}; MF-ratio={rec['model_flops_ratio']:.2f} "
                      f"roofline={rec['roofline_fraction']*100:.1f}%", flush=True)
            else:
                print(f"{a} x {s}: {rec['status']}", flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                fn = f"{a}__{s}__{'mp' if args.multi_pod else 'sp'}.json"
                with open(os.path.join(args.out, fn), "w") as f:
                    json.dump(rec, f, indent=1, default=str)


if __name__ == "__main__":
    main()
