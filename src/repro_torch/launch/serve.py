"""Serving launcher of the port: the ``tokens`` mode.

Batched LM prefill + greedy decode on an arch config, with weights drawn
from a seeded ``torch.Generator``:

    PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
        --arch mamba2-2.7b --requests 4 --new-tokens 16
    PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
        --arch mamba2-2.7b --reduced --device cpu

It runs on the CUDA device unless ``--device`` names another.  The
reference's ``sensors``, ``stream`` and ``sweep`` modes are not ported
yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


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
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(r.n_decoded for r in results)
    for i, r in enumerate(results):
        print(f"req {i}: prefill {r.n_prefill:3d} -> {r.tokens[:8]}...")
    print(f"{total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s batched on {name}, {device})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    tok = sub.add_parser("tokens", help="batched LM prefill + greedy decode")
    tok.add_argument("--arch", required=True)
    tok.add_argument("--reduced", action="store_true",
                     help="the arch's smoke-test-sized config")
    tok.add_argument("--requests", type=int, default=4)
    tok.add_argument("--new-tokens", type=int, default=16)
    tok.add_argument("--max-len", type=int, default=128)
    tok.add_argument("--device", default=None,
                     help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    run_tokens(args)


if __name__ == "__main__":
    main()
