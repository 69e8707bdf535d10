"""The port's training entry point: the reference's ``launch.train`` CLI.

    python -m repro_torch.launch.train --arch mamba2-2.7b --reduced \\
        --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/run1
    python -m repro_torch.launch.train --arch qwen3-8b --reduced \\
        --steps 3 --device cpu
    python -m repro_torch.launch.train --arch kimi-k2-1t-a32b --reduced \\
        --steps 3 --device cpu

``--arch`` takes the port's registry: every LM architecture of the
reference's (the ssm, dense, hybrid and MoE families, and the vlm /
audio backbones), whose ``fsdp=True`` changes nothing without a mesh, as
in the reference.  An expert config's ``lb_loss`` and ``z_loss`` enter
the loss and the metrics; kimi-k2 and grok-1 train with Adafactor and a
bf16 gradient accumulator, as their configs say.

Runs on the CUDA device unless ``--device`` names another (``--device
cpu`` runs the plain PyTorch versions on the CPU).  ``--platform`` maps
onto the device as in ``launch.serve`` (``gpu``: the CUDA device, ``cpu``:
``--device cpu``; ``tpu`` and a platform that contradicts ``--device``
are refused).  ``--production-mesh`` is refused: the port trains on one
device (model sharding is ROADMAP.md, queue 1).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.events.pipeline import TokenPipeline
from repro_torch.train.loop import Trainer, TrainerConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", default=None,
                    choices=[None, "int8", "topk"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="refused: the port trains on one device")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--platform", choices=("cpu", "gpu", "tpu"), default=None,
                    help="the reference's platform pin, as a device: gpu "
                         "runs on the CUDA device, cpu as --device cpu; "
                         "tpu is refused")
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.error("--production-mesh is refused: repro_torch trains on one "
                 "device (model sharding is ROADMAP.md, queue 1)")
    if args.platform == "tpu":
        ap.error("--platform tpu is refused: the port runs on the CUDA "
                 "device or the CPU")
    if args.platform is not None:
        want = "cuda" if args.platform == "gpu" else "cpu"
        if args.device is not None and torch.device(args.device).type != want:
            ap.error(f"--platform {args.platform} contradicts --device "
                     f"{args.device}")
        if want == "cpu":
            args.device = "cpu"

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, lr=args.lr,
        grad_compression=args.grad_compression,
        decay_steps=max(args.steps, 100),
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    pipe = TokenPipeline(cfg.vocab, args.batch, args.seq, seed=0)
    if args.resume and trainer.maybe_restore(pipe):
        print(f"resumed from step {trainer.step}")

    out = trainer.train(pipe, args.steps, pipeline=pipe,
                        install_preemption_handler=True)
    hist = out["history"]
    print(f"{cfg.name} on {trainer.device}: {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, batch {args.batch} x {args.seq} tokens")
    for h in hist[:: max(1, len(hist) // 10)]:
        flag = " [straggler]" if h["straggler"] else ""
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"{h['dt']*1e3:7.1f} ms{flag}")
    print(f"final step {out['final_step']}, "
          f"loss {hist[-1]['loss']:.4f} (start {hist[0]['loss']:.4f})")


if __name__ == "__main__":
    main()
