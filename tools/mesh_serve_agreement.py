#!/usr/bin/env python3
"""How often greedy tokens served over a mesh equal one device's, for a
deep hybrid model, in float32 and in bfloat16 activations, on the CPU.

    PYTHONPATH=src python3 tools/mesh_serve_agreement.py

Four gloo ranks (a ``file://`` store in a temporary directory) serve
``hymba-1.5b``'s family at ``reduced()`` widths with 32 layers (global
layers 0, 15 and 31 as the full config has them), 5 query heads (so a
model axis of 2 leaves them whole, as it leaves hymba's 25) and a window
of 8 under prompts of 17-24 tokens (the rings roll), through
``ServeEngine`` over a (2, 2) mesh; one process serves the same requests
on one device.  Two weight draws: ``PRNGKey(0)`` as the reference's
initialiser gives them (a 3-D leaf's fan-in is its heads dim, so the
attention logits are ~100 and the softmax is one-hot), and the same with
the attention projections scaled to their true fan-in.  For each dtype
and draw it prints the share of the 32 greedy tokens that agree and each
request's first differing step.  It needs no card and no JAX.
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

WORLD, MESH, NEW, MAX_LEN = 4, (2, 2), 8, 40
PROMPTS = (20, 24, 17, 22)


def config(dtype: str):
    from repro_torch.configs import get_config

    return get_config("hymba-1.5b").reduced(
        n_layers=32, global_attn_layers=(0, 15, 31), n_heads=5,
        n_kv_heads=1, window=8, dtype=dtype)


def requests(cfg):
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(0)
    return [Request(rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=NEW) for n in PROMPTS]


def weights(cfg, true_fan_in: bool):
    """``PRNGKey(0)``'s draw, the attention projections optionally scaled
    from the heads dim to their true fan-in."""
    from repro_torch.core import prng
    from repro_torch.models import module as M
    from repro_torch.models import transformer as T

    params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), "cpu")
    if true_fan_in:
        attn = params["layers"]["attn"]
        for w, ref_fan, fan in (
                ("wq", cfg.n_heads, cfg.d_model),
                ("wk", cfg.n_kv_heads, cfg.d_model),
                ("wv", cfg.n_kv_heads, cfg.d_model),
                ("wo", cfg.head_dim, cfg.n_heads * cfg.head_dim)):
            attn[w].mul_((ref_fan / fan) ** 0.5)
    return params


def rank(r: int, store: str) -> None:
    import torch.distributed as dist

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import module as M
    from repro_torch.serve.engine import ServeEngine

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r,
                            world_size=WORLD)
    mesh = make_test_mesh(MESH, device="cpu")
    for dtype in ("float32", "bfloat16"):
        for fan in (True, False):
            cfg = config(dtype)
            full = weights(cfg, fan)
            pls = M.flatten(SH.placements(cfg, mesh))
            blocks = M.unflatten({k: SH.shard_leaf(v, pls[k])
                                  for k, v in M.flatten(full).items()})
            got = ServeEngine(cfg, blocks, max_len=MAX_LEN, mesh=mesh).serve(
                requests(cfg))
            if r:
                continue
            want = ServeEngine(cfg, full, max_len=MAX_LEN,
                               device="cpu").serve(requests(cfg))
            g = np.stack([x.tokens for x in got])
            w = np.stack([x.tokens for x in want])
            first = [int(np.argmax(a != b)) if (a != b).any() else None
                     for a, b in zip(g, w)]
            print(f"{dtype:9s} {'true fan-in' if fan else 'PRNGKey(0)'}: "
                  f"{100 * float((g == w).mean()):.1f} % of {g.size} tokens "
                  f"equal; first differing step by request {first}",
                  flush=True)
    dist.destroy_process_group()


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(rank, (os.path.join(d, "store"),), nprocs=WORLD)


if __name__ == "__main__":
    main()
