#!/usr/bin/env python3
"""Measure the numerics and speed of the reconstruction protocol's
training step on one card: which convolution implementation keeps the
reference's gradients, what it costs, and how far one run's held-out
SSIM can move.

    python3 tools/train_probe.py convs           # card vs CPU, per layer
    python3 tools/train_probe.py step-time       # 180x240 step, 4 ways
    python3 tools/train_probe.py spread --conv direct --runs 20
    python3 tools/train_probe.py spread --device cpu --runs 10 --threads 4

The convolution settings compared (``MODES``, TF32 off in each): cuDNN
at its heuristics, with ``deterministic``, with ``benchmark``, and
cuDNN off (PyTorch's direct convolution, which ``train.grad`` runs when
asked for ``direct``).  ``convs``: the protocol's first batch
(``repro_torch.train.recon``, 48x48, batch 16, ``PRNGKey(0)`` weights)
through the UNet on the CPU, each convolution's input, weight and output
gradient recorded; then each convolution again on the card each way,
against the CPU: the cells exactly 0 on the CPU that the card makes
nonzero in the output, the data gradient and the weight gradient, and
each one's largest error over its largest CPU value.  Then step 1's
gradients each way (and at PyTorch's defaults, TF32 in the backward)
against the CPU's, for the reconstruction UNet and for the
classification CNN on the smoke's phase 10 (c) batch: the worst leaves
and the exact-zero leaf cells the card breaks.  ``step-time``: ms per
training step (host clock ending in a synchronize, median of 20 after 3
warm-up steps) at 180x240, batch 16, on 2 ``davis_like`` scenes, each
way, in turns.  ``spread``: the held-out SSIM of ``--runs`` 80-step runs
of the 48x48 protocol on ``--device`` (``recon.jitter``'s weights for
run m) with ``--conv``'s settings on the card, run 0 twice to show
whether a run repeats; ``--threads`` fixes the CPU's thread count
(default: PyTorch's).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.models import module as M  # noqa: E402
from repro_torch.models.cnn import float32_math  # noqa: E402
from repro_torch.train import recon  # noqa: E402
from repro_torch.train.grad import value_and_grad  # noqa: E402

LAYERS = ("enc1.c1", "enc1.c2", "enc2.c1", "enc2.c2", "enc3.c1", "enc3.c2",
          "dec2.c1", "dec2.c2", "dec1.c1", "dec1.c2", "out")


def _to(tree, dev):
    return M.unflatten({k: v.to(dev) for k, v in M.flatten(tree).items()})


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


#: the convolution settings compared, all with TF32 off
MODES = {"cudnn": dict(enabled=True),
         "deterministic": dict(enabled=True, deterministic=True),
         "benchmark": dict(enabled=True, benchmark=True),
         "direct": dict(enabled=False)}


def _conv_flags(mode: str, tf32: bool = False):
    return torch.backends.cudnn.flags(allow_tf32=tf32, **MODES[mode])


def _zeros(got, ref) -> str:
    """Cells exactly 0 on the CPU but not on the card, and their largest
    magnitude."""
    zero = ref == 0
    bad = got[zero] != 0
    big = float(got[zero].abs().max()) if bool(bad.any()) else 0.0
    return f"{int(bad.sum())}/{int(zero.sum())} ({big:.1e})"


def convs(dev) -> None:
    pairs = recon.make_pairs(device="cpu")
    params, _, _ = recon.init(80, 12, "cpu")
    idx = recon.batches(pairs.n_train, 1, 16)[0]
    xb, yb = pairs.x[idx], pairs.y[idx]
    rec, conv2d = [], F.conv2d

    def spy(x, w, *a, **k):
        y = conv2d(x, w, *a, **k)
        y.retain_grad()
        rec.append((x.detach(), w.detach(), a, k, y))
        return y

    F.conv2d = spy
    leaves = M.unflatten({k: v.detach().requires_grad_(True)
                          for k, v in M.flatten(params).items()})
    with float32_math():
        recon.l1_loss(leaves, xb, yb).backward()
    F.conv2d = conv2d

    def run(x, w, a, k, g, d):
        x = x.to(d).requires_grad_(True)
        w = w.to(d).requires_grad_(True)
        y = conv2d(x, w, *a, **k)
        dx, dw = torch.autograd.grad(y, [x, w], g.to(d))
        return y.detach().cpu(), dx.cpu(), dw.cpu()

    print("per convolution, card vs CPU: exact CPU zeros the card breaks "
          "(forward / dgrad / wgrad), then each one's largest error over "
          "its largest CPU value")
    for name, (x, w, a, k, y) in zip(LAYERS, rec):
        ref = run(x, w, a, k, y.grad, "cpu")
        for mode in MODES:
            with _conv_flags(mode):
                got = run(x, w, a, k, y.grad, dev)
            print(f"{name:8s} {mode:13s} in {tuple(x.shape)} w "
                  f"{tuple(w.shape)}: zeros broken "
                  f"{' / '.join(_zeros(g, r) for g, r in zip(got, ref))}; "
                  f"errors {_rel(got[0], ref[0]):.2e} / "
                  f"{_rel(got[1], ref[1]):.2e} / {_rel(got[2], ref[2]):.2e}",
                  flush=True)
    step_grads("recon", recon.l1_loss, params, (xb, yb), dev)
    step_grads("classify", *_cls_case(), dev)


def _cls_case():
    """The classification protocol's weights and first batch (the smoke's
    phase 10 (c) data)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import prng
    from repro_torch.models.cnn import cnn_apply, cnn_defs

    x, y = chip_smoke.cls_frames(torch.device("cpu"))
    params = M.init_params(cnn_defs(1, chip_smoke.CLS_CLASSES, width=16),
                           prng.PRNGKey(7), "cpu")
    idx = torch.from_numpy(np.random.default_rng(0).choice(
        len(x), chip_smoke.CLS_BATCH))
    loss = lambda p, xb, yb: F.cross_entropy(cnn_apply(p, xb), yb)
    return loss, params, (x[idx], y[idx])


def step_grads(what, loss, params, batch, dev) -> None:
    """Step 1's gradients each way against the CPU's: the worst leaves'
    errors over their largest CPU value, and the leaf cells exactly 0 on
    the CPU that the card makes nonzero (Adam turns such a cell into a
    step of up to the learning rate)."""
    _, g_cpu = value_and_grad(loss)(params, *batch)
    g_cpu = M.flatten(g_cpu)

    def plain(p, *args):
        """Autograd with no float32 rule around the backward."""
        p = M.unflatten({k: v.detach().requires_grad_(True)
                         for k, v in M.flatten(p).items()})
        value = loss(p, *args)
        leaves = list(M.flatten(p).values())
        return value, M.unflatten(dict(zip(M.flatten(p), torch.autograd.grad(
            value, leaves))))

    runs = [(m, value_and_grad(loss), m, False) for m in MODES]
    runs.append(("cudnn, TF32 in the backward (PyTorch's defaults)", plain,
                 "cudnn", True))
    for label, fn, mode, tf32 in runs:
        with _conv_flags(mode, tf32):
            _, g = fn(_to(params, dev), *(t.to(dev) for t in batch))
        g = {k: v.cpu() for k, v in M.flatten(g).items()}
        worst = sorted(((_rel(g[k], v), k) for k, v in g_cpu.items()),
                       reverse=True)
        broken = {k: _zeros(g[k], v) for k, v in g_cpu.items()
                  if bool(((v == 0) & (g[k] != 0)).any())}
        print(f"{what} step-1 gradients, {label}: worst leaves "
              f"{[(k, f'{e:.2e}') for e, k in worst[:3]]}; zero cells "
              f"broken {broken or 'none'} of "
              f"{sum(int((v == 0).sum()) for v in g_cpu.values())}",
              flush=True)


def step_time(dev) -> None:
    pairs = recon.make_pairs(180, 240, 2, 0.4, seed=9, device=dev)
    params, opt, state = recon.init(300, 12, dev)
    loss_grad = value_and_grad(recon.l1_loss)
    idx = [i.to(dev) for i in recon.batches(pairs.n_train, 23, 16)]
    for mode in list(MODES) + list(MODES)[::-1]:
        with _conv_flags(mode):
            ms = []
            for i, j in enumerate(idx):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, g = loss_grad(params, pairs.x[j], pairs.y[j])
                opt.update(g, state, params, i)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        print(f"180x240 step, {mode}: p50 {np.percentile(ms[3:], 50):.3f} ms",
              flush=True)


def spread(dev, runs: int, mode: str) -> None:
    pairs = recon.make_pairs(device=dev)
    out = []
    with _conv_flags(mode):
        for m in [0] + list(range(runs)):
            t0 = time.perf_counter()
            out.append(recon.run(80, dev, m=m, pairs=pairs,
                                 direct=mode == "direct")["ssim"])
            print(f"run {m}: held-out SSIM {out[-1]:.4f} "
                  f"({time.perf_counter() - t0:.2f} s)", flush=True)
    print(f"run 0 repeats bitwise: {out[0] == out[1]}")
    out = out[1:]
    print(f"{dev} ({mode + ', ' if dev.type == 'cuda' else ''}"
          f"{torch.get_num_threads()} CPU threads): median "
          f"{np.median(out):.4f}, mean {np.mean(out):.4f}, std "
          f"{np.std(out):.4f}, range {min(out):.4f}-{max(out):.4f}, "
          f"{sum(v < 0.32 for v in out)} of {len(out)} below 0.32")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("convs", "step-time", "spread"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--conv", choices=tuple(MODES), default="cudnn",
                    help="spread: the card's convolution settings")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("train_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.what != "spread" and dev.type != "cuda":
        print(f"train_probe: {args.what} runs on the card", file=sys.stderr)
        return 2
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.what == "convs":
        convs(dev)
    elif args.what == "step-time":
        step_time(dev)
    else:
        spread(dev, args.runs, args.conv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
