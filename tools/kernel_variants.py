#!/usr/bin/env python3
"""Time variants of the ``stcf_support`` and ``chunk_scatter`` CUDA
sources against each other on one card, in turns, on the inputs of
``chip_smoke.py``'s kernel phase.

    python3 tools/kernel_variants.py \\
        --stcf src/repro_torch/kernels/csrc/stcf.cu:kBandRows=48 \\
        --stcf other/stcf.cu \\
        --scatter src/repro_torch/kernels/csrc/ts_fused.cu \\
        --scatter other/ts_fused.cu

Each ``--stcf`` / ``--scatter`` names a source file with the C entry
points of ``csrc/stcf.cu`` / ``csrc/ts_fused.cu``, optionally followed by
``:NAME=VALUE,...`` overrides of its ``constexpr int NAME = ...;``
constants (a band height, a batch, a thread count).  Each variant is
compiled with the port's ``nvcc`` flags into a library of its own, checked
against the plain PyTorch version (both support forms at r = 3; all five
scatter outputs bitwise), and timed with ``chip_smoke.Timer`` (median over
launches, L2 flushed before each) in the order given and then in reverse,
so every variant runs early and late.  Inputs: the smoke's engine (64
slots of 2 x 240 x 320) after 9 deadlines of its seeded scenes; the
support read of its SAE at t = 0.1 s; the scatter of its next 10 ms push
and of the smoke's duplicate-heavy push.  Runs on the card only.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def build(spec: str, out_dir: Path, names):
    """Compile one variant ``PATH[:NAME=VALUE,...]``; returns its ctypes
    library with ``names``' signatures set."""
    from repro_torch.kernels import _lib

    path, _, over = spec.partition(":")
    text = Path(path).read_text()
    for kv in filter(None, over.split(",")):
        name, value = kv.split("=")
        text, n = re.subn(rf"\b{name} = \d+;", f"{name} = {value};", text)
        if n != 1:
            raise ValueError(f"{spec}: {name} is not one constexpr of {path}")
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec).strip("_")
    cu = out_dir / f"{tag}.cu"
    cu.write_text(text)
    so = out_dir / f"{tag}.so"
    r = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC),
                        "-shared", str(cu), "-o", str(so)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {spec}:\n{r.stdout}{r.stderr}")
    regs = sorted({ln.split(":")[-1].strip()
                   for ln in (r.stdout + r.stderr).splitlines() if "Used" in ln})
    print(f"build {spec}: {regs}", flush=True)
    lib = ctypes.CDLL(str(so))
    for name in names:
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib


def call(lib, name, *args):
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")


def in_turns(timer, fns: dict, **kw) -> dict:
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(timer(fns[k], 30, **kw))
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stcf", action="append", default=[])
    ap.add_argument("--scatter", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import time_surface as ts
    from repro_torch.events import aer, datasets
    from repro_torch.kernels import ref
    from repro_torch.kernels.ts_decay import ts_decay_cuda
    from repro_torch.serve import spec as rs
    from repro_torch.serve import ts_engine as eng

    dev = torch.device("cuda", 0)
    out_dir = ROOT / "build" / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    words = cs.make_scenes(datasets, aer)
    cfg = eng.TSEngineConfig(h=cs.H, w=cs.W, polarities=cs.P, n_slots=cs.S,
                             chunk_capacity=cs.CAP, mode="edram",
                             specs=(rs.ReadoutSpec(count=rs.count(4)),))
    engine = eng.TimeSurfaceEngine(cfg)
    for _ in range(cs.S):
        engine.attach()
    for b in range(2 * cs.DEADLINES - 2):
        engine.push([(k, words[k % cs.N_SCENES][b]) for k in range(cs.S)])
    base = engine.state
    timer = cs.Timer(dev)

    if args.stcf:
        sae, t_now = base.surfaces.sae, 0.1
        params, v_tw = cfg.decay_params(), cfg.v_tw()
        _, m = ts_decay_cuda(sae, t_now, params, v_tw)
        want = ref.stcf_support_ref(m, cs.RADIUS)
        planes = sae.numel() // (cs.H * cs.W)
        fns = {}
        for spec in args.stcf:
            lib = build(spec, out_dir, ("stcf_support_fused",
                                        "stcf_support_mask"))

            def fused(_, lib=lib):
                out = torch.empty(sae.shape, dtype=torch.int32, device=dev)
                call(lib, "stcf_support_fused", sae.data_ptr(), out.data_ptr(),
                     planes, cs.H, cs.W, cs.RADIUS, 0, t_now,
                     *(float(x) for x in params), float(v_tw))
                return out

            def mask(_, lib=lib):
                out = torch.empty(sae.shape, dtype=torch.int32, device=dev)
                call(lib, "stcf_support_mask", m.data_ptr(), out.data_ptr(),
                     planes, cs.H, cs.W, cs.RADIUS, 0)
                return out

            ok = torch.equal(fused(None), want) and torch.equal(mask(None),
                                                                want)
            print(f"stcf {spec}: both forms == plain version: {ok}",
                  flush=True)
            fns[spec] = (fused, mask)
        for i, form in enumerate(("fused", "mask form")):
            times = in_turns(timer, {k: v[i] for k, v in fns.items()})
            for k, t in times.items():
                print(f"stcf_support {form} {k}: {np.mean(t):.4f} ms "
                      f"(turns {[round(x, 4) for x in t]})", flush=True)

    if args.scatter:
        sids, fields = engine._collect(
            [(k, np.concatenate(words[k % cs.N_SCENES][2:4]))
             for k in range(cs.S)])
        pushes = {
            "10 ms push": (torch.from_numpy(sids).to(dev),
                           ts.EventBatch(*(torch.from_numpy(f).to(dev)
                                           for f in fields))),
            "duplicate-heavy": cs.duplicate_heavy_push(dev, cs.S, cs.P),
        }

        def fresh(_=None):
            return (base.surfaces.sae.clone(), base.cache.dirty.clone(),
                    base.counts.clone(), base.surfaces.t_last.clone(),
                    base.surfaces.n_events.clone())

        libs = {spec: build(spec, out_dir, ("chunk_scatter",))
                for spec in args.scatter}
        for label, (s_ids, ev) in pushes.items():
            want = fresh()
            ref.chunk_scatter_ref(want[0], s_ids, ev, want[1], cfg.block,
                                  *want[2:])
            fns = {}
            for spec, lib in libs.items():
                def run(st, lib=lib, s_ids=s_ids, ev=ev):
                    b, n = ev.x.shape
                    ptr = lambda t: None if t is None else t.data_ptr()
                    call(lib, "chunk_scatter", st[0].data_ptr(), cs.S, cs.P,
                         cs.H, cs.W, s_ids.data_ptr(), ev.x.data_ptr(),
                         ev.y.data_ptr(), ev.p.data_ptr(), ev.t.data_ptr(),
                         ev.valid.data_ptr(), b, n, ptr(st[1]),
                         cfg.block[0], cfg.block[1], ptr(st[2]), ptr(st[3]),
                         ptr(st[4]))

                st = fresh()
                run(st)
                ok = all(cs.same(a, b) for a, b in zip(st, want))
                print(f"chunk_scatter {spec} on the {label}: five outputs "
                      f"== plain version: {ok}", flush=True)
                fns[spec] = run
            for k, t in in_turns(timer, fns, setup=fresh).items():
                print(f"chunk_scatter {label} {k}: {np.mean(t):.4f} ms "
                      f"(turns {[round(x, 4) for x in t]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
