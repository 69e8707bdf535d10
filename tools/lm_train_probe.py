#!/usr/bin/env python3
"""Measure what the smoke's LM training phase (phase 11) cannot show on
its own: where a full-width step's device time goes by PyTorch op, and
whether the exact-zero gradients of its card-against-CPU check are
exact or cancellations.

    python3 tools/lm_train_probe.py by-op    # card: one traced step
    python3 tools/lm_train_probe.py zeros    # card and CPU: (b)'s zeros

``by-op``: mamba2-2.7b at full width and depth through the port's
``Trainer``, as phase 11 (a) runs it (``TokenPipeline(vocab, 8, 2048,
seed=0)``, one warm-up step); then one step under ``torch.profiler``
with the host's activity and the device's, and the device time by
``aten::`` op, the kernels' count and the seconds the profiler's tables
took.  Phase 11 traces the device alone, which names kernels, not ops.

``zeros``: phase 11 (b)'s step (the full-width model at 2 layers in
float32, ``PRNGKey(1)``, batch 2 x 300 in 2 microbatches) once on the
card and on the CPU at PyTorch's thread count, at 1 and at 3 threads.
For each leaf, the cells exactly 0 in the first CPU run that any other
run makes nonzero, with their values in every run: a 0 that moves with
the thread count is a cancellation, not an exact zero.

The card's name and power limit are printed first.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.events.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models import module as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import loop  # noqa: E402


def by_op(dev, top: int) -> None:
    cfg = get_config(cs.LM_ARCH)
    tr = loop.Trainer(cfg, loop.TrainerConfig(), device=dev)
    pipe = TokenPipeline(cfg.vocab, cs.TRAIN_BATCH, cs.TRAIN_SEQ, seed=0)
    tr.train(pipe, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = cs.profiled(lambda: tr.train(pipe, 1))
    tables_s = time.perf_counter() - t0 - r["wall_ms"] / 1e3
    print(f"one step traced with host and device: {r['wall_ms']:.1f} ms "
          f"profiled, device kernels {r['device_ms']:.1f} ms, "
          f"{r['launches']} kernels; the tables took {tables_s:.1f} s")
    for k, v in sorted(r["ops"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {k:40s} {v:10.3f} ms  {100 * v / r['device_ms']:6.2f} %")
    scan = {k: v for k, v in r["kernels"].items() if "decay_scan" in k}
    print(f"decay_scan kernels (ms): {scan}")


def zeros(dev, show: int) -> None:
    layers, batch, seq = cs.TRAIN_CHECK
    cfg = dataclasses.replace(get_config(cs.LM_ARCH), n_layers=layers,
                              dtype="float32", n_microbatches=2)
    card = M.init_params(T.param_defs(cfg), prng.PRNGKey(1), dev)
    cpu = M.unflatten({k: v.cpu() for k, v in M.flatten(card).items()})
    tokens, labels = (torch.from_numpy(v) for v in
                      next(TokenPipeline(cfg.vocab, batch, seq, seed=1)))
    fn = loop.make_grad_fn(cfg)
    runs = {}
    threads = torch.get_num_threads()
    for th in (threads, 1, 3):
        torch.set_num_threads(th)
        g, _ = fn(cpu, tokens, labels)
        runs[f"cpu {th} threads"] = M.flatten(g)
    torch.set_num_threads(threads)
    g, _ = fn(card, tokens.to(dev), labels.to(dev))
    runs["card"] = {k: v.cpu() for k, v in M.flatten(g).items()}
    base = runs[f"cpu {threads} threads"]
    n_zero = n_moved = 0
    for k, w in base.items():
        z = w == 0
        moved = torch.zeros_like(z)
        for r in runs.values():
            moved |= z & (r[k] != 0)
        n_zero += int(z.sum())
        n_moved += int(moved.sum())
        if moved.any():
            idx = moved.nonzero()[:show].tolist()
            print(f"{k}: {int(z.sum())} zeros, {int(moved.sum())} nonzero "
                  f"in another run; leaf max {float(w.abs().max()):.4g}")
            for i in idx:
                vals = {name: float(r[k][tuple(i)]) for name, r in runs.items()}
                print(f"  {tuple(i)}: {vals}")
    print(f"{n_zero} cells exactly 0 on the CPU at {threads} threads, "
          f"{n_moved} of them nonzero in another run")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("by-op", "zeros"))
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--show", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.what == "by-op":
        by_op(dev, args.top)
    else:
        zeros(dev, args.show)
    return 0


if __name__ == "__main__":
    sys.exit(main())
