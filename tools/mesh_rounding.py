#!/usr/bin/env python3
"""How far the LM trainer over a mesh lands from the one-device trainer,
in bfloat16 and in float32 activations, on the CPU.

    PYTHONPATH=src python3 tools/mesh_rounding.py [--dtype bfloat16 float32]

Four gloo ranks (a ``file://`` store in a temporary directory) train
``qwen3-8b``'s family at d_model 256, 2 layers, 8 microbatches, FSDP,
32 x 64 tokens a step, 2 steps at the trainer's default lr, over the
(4, 1) and (2, 2) meshes; one process trains the same model on one
device.  For each leaf it prints the worst parameter error and the worst
error of AdamW's first moment (the clipped gradients), each as a share
of the one-device leaf's max, and how many cells leave rtol 1e-4, atol
1e-4 x max|leaf|.  It needs no card and no JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

WORLD, BATCH, SEQ, STEPS, TOL = 4, 32, 64, 2, 1e-4
MESHES = ((4, 1), (2, 2))


def config(dtype: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("qwen3-8b").reduced(), fsdp=True, n_microbatches=8,
        dtype=dtype, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=768, vocab=2048)


def train(cfg, **where):
    from repro_torch.events.pipeline import TokenPipeline
    from repro_torch.train.loop import Trainer, TrainerConfig

    tr = Trainer(cfg, TrainerConfig(), **where)
    tr.train(TokenPipeline(cfg.vocab, BATCH, SEQ, seed=0), STEPS)
    return tr


def rank(r: int, store: str, out: str, dtype: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as M

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=WORLD)
    for shape in MESHES:
        tr = train(config(dtype), mesh=make_test_mesh(shape, device="cpu"))
        trees = ((tr.params, tr.shards),
                 (tr.opt_state["m"], tr.shards))
        full = [{k: SH.gather_full(x, pl) for (k, x), pl in zip(
            M.flatten(t).items(), M.flatten(s).values())} for t, s in trees]
        if r == 0:
            torch.save(full, os.path.join(out, f"{shape[0]}x{shape[1]}.pt"))
    dist.destroy_process_group()


def report(dtype: str) -> None:
    from repro_torch.models import module as M

    out = tempfile.mkdtemp(prefix="mesh_rounding_")
    mp.spawn(rank, (os.path.join(out, "store"), out, dtype), nprocs=WORLD)
    torch.set_num_threads(1)
    one = train(config(dtype), device="cpu")
    want_p = {k: v.detach() for k, v in M.flatten(one.params).items()}
    want_m = {k: v.detach() for k, v in M.flatten(one.opt_state["m"]).items()}
    for shape in MESHES:
        got_p, got_m = torch.load(os.path.join(out, f"{shape[0]}x{shape[1]}.pt"))
        print(f"{dtype}, mesh {shape} against one device:")
        for k, w in want_p.items():
            scale = float(w.abs().max())
            bad = ~torch.isclose(got_p[k], w, rtol=TOL, atol=TOL * scale)
            err_p = float((got_p[k] - w).abs().max()) / scale
            wm = want_m[k]
            err_m = float((got_m[k] - wm).abs().max() / wm.abs().max())
            print(f"  {k:22s} leaf {err_p:.3e} of its max ({int(bad.sum())} "
                  f"of {w.numel()} cells outside the band); first moment "
                  f"{err_m:.3e} of its max")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", nargs="+", default=["bfloat16", "float32"],
                    choices=["bfloat16", "float32"])
    for dtype in ap.parse_args().dtype:
        report(dtype)


if __name__ == "__main__":
    main()
