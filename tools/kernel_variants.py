#!/usr/bin/env python3
"""Time variants of the ``ts_decay``, ``stcf_support`` and
``chunk_scatter`` CUDA sources against each other on one card, in turns,
on the inputs of ``chip_smoke.py``'s kernel phase.

    python3 tools/kernel_variants.py \\
        --decay build/parent/src/repro_torch/kernels/csrc/ts_decay.cu \\
        --decay src/repro_torch/kernels/csrc/ts_decay.cu:arith=copy \\
        --decay src/repro_torch/kernels/csrc/ts_decay.cu:arith=ieee \\
        --stcf src/repro_torch/kernels/csrc/stcf.cu:kBandRows=48 \\
        --scatter src/repro_torch/kernels/csrc/ts_fused.cu

Each ``--decay`` / ``--stcf`` / ``--scatter`` names a source file with the
C entry points of ``csrc/ts_decay.cu`` / ``csrc/stcf.cu`` /
``csrc/ts_fused.cu``, optionally followed by ``:NAME=VALUE,...``
overrides of its ``constexpr int NAME = ...;`` constants (a band height,
a batch, loads in flight).  A ``--decay`` variant also takes
``arith=copy`` (every ``decay_cell`` and ``decay_cell_ieee`` call returns
its input: the same loads and stores with no arithmetic, the bandwidth
ceiling of that pattern), ``arith=ieee`` (every ``decay_cell`` call
becomes ``decay_cell_ieee``: two ``__fdiv_rn`` a cell, the first
version's arithmetic) and ``group=N`` (the plane form's leading planes
per block, instead of ``planes_launch``'s).  Headers are taken from the
source's own directory, so the parent tree's ``ts_decay.cu`` builds with
its own ``decay.cuh``.  Each variant is compiled with the port's
``nvcc`` flags into a library of its own, checked against the plain
PyTorch version (decay values bitwise, both support forms at r = 3, all
five scatter outputs bitwise), and timed with ``chip_smoke.Timer``
(median over launches, L2 flushed before each) in the order given and
then in reverse, so every variant runs early and late.  For each
``--decay`` variant it also prints each kernel's SASS instruction count
and that of its longest loop, from ``cuobjdump -sass``.  Inputs: the
smoke's engine (64 slots of 2 x 240 x 320) after 9 deadlines of its
seeded scenes; the decay read of its SAE (uniform, with the comparator,
and with (H, W) parameter planes of a seeded 5 % tau spread) and the
support read at t = 0.1 s; the scatter of its next 10 ms push and of the
smoke's duplicate-heavy push.  Runs on the card only.
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
        if name == "arith":
            text = decay_arith(text, value)
            continue
        if name == "group":   # a launch argument, read by decay_variants
            continue
        text, n = re.subn(rf"\b{name} = \d+;", f"{name} = {value};", text)
        if n != 1:
            raise ValueError(f"{spec}: {name} is not one constexpr of {path}")
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec).strip("_")
    cu = out_dir / f"{tag}.cu"
    cu.write_text(text)
    so = out_dir / f"{tag}.so"
    r = subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I",
                        str(Path(path).resolve().parent),
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
    lib.so_path = so
    return lib


def decay_arith(text: str, arith: str) -> str:
    """``arith=copy`` / ``arith=ieee`` of a ``ts_decay.cu`` variant."""
    if arith == "ieee":
        return re.sub(r"\bdecay_cell\(", "decay_cell_ieee(", text)
    if arith != "copy":
        raise ValueError(f"arith={arith}: expected copy or ieee")
    text = re.sub(r"\bdecay_cell(_ieee)?\(", "decay_copy(", text)
    return text.replace(
        '#include "decay.cuh"\n', '#include "decay.cuh"\n\n'
        "template <typename... A>\n__device__ __forceinline__ float "
        "decay_copy(float s, A&&...) { return s; }\n", 1)


def sass_report(so: Path) -> list:
    """(kernel, SASS instructions, instructions of its longest loop,
    MUFU / FCHK / CALL in that loop) for every kernel of a library, from
    ``cuobjdump -sass``: a loop is the span from a backward branch's
    target to the branch."""
    from repro_torch.kernels import _lib

    tool = Path(_lib._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True).stdout
    out, name, ins, labels = [], None, [], {}

    def close():
        if name is None:
            return
        loop = (0, 0)
        for at, (addr, op) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?(?:0x([0-9a-f]+)|`\((\.L_x_\d+)\))", op)
            if not m:
                continue
            target = int(m.group(1), 16) if m.group(1) else labels.get(
                m.group(2), addr + 1)
            if target <= addr:
                start = next(i for i, (a, _) in enumerate(ins) if a >= target)
                loop = max(loop, (at - start + 1, start))
        body = [op for _, op in ins[loop[1]:loop[1] + loop[0]]]
        kinds = {k: sum(bool(re.search(rf"\b{k}\b", op)) for op in body)
                 for k in ("MUFU", "FCHK", "CALL")}
        out.append((name, len(ins), loop[0], kinds))

    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, ins, labels = line.split("Function :")[1].strip(), [], {}
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab and name is not None:
            labels[lab.group(1)] = ins[-1][0] + 16 if ins else 0
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name is not None:
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    close()
    return out


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
    ap.add_argument("--decay", action="append", default=[])
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

    if args.decay:
        decay_variants(args.decay, out_dir, timer, base.surfaces.sae,
                       cfg.decay_params(), cfg.v_tw(), dev)

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


def decay_variants(specs, out_dir, timer, sae, params, v_tw, dev):
    """Build, check, time and disassemble the ``--decay`` variants."""
    from repro_torch.core import edram
    from repro_torch.kernels import _lib, ref
    from repro_torch.kernels.ts_decay import planes_launch

    t_now = 0.1
    cells = sae.numel()
    g = torch.Generator(device=dev).manual_seed(4)
    eps = 1.0 + 0.05 * torch.randn((2, cs.H, cs.W), generator=g, device=dev)
    full = lambda x: torch.full((cs.H, cs.W), float(x), device=dev)
    planes = edram.DecayParams(full(params.a1), float(params.tau1) / eps[0],
                               full(params.a2), float(params.tau2) / eps[1],
                               full(params.b))
    want = ref.ts_decay_ref(sae, t_now, params, v_tw)
    want_p = ref.ts_decay_ref(sae, t_now, planes)
    shape = planes_launch(cells // (cs.H * cs.W), cs.H * cs.W, True)
    fns = {}
    for spec in specs:
        lib = build(spec, out_dir, ("ts_decay_uniform",))
        # the first version's plane entry takes (n, plane) and no shape
        new_iface = "int grid_x" in Path(spec.partition(":")[0]).read_text()
        lib.ts_decay_planes.argtypes = (
            _lib._SIGNATURES["ts_decay_planes"] if new_iface else
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
            + [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p])
        lib.ts_decay_planes.restype = ctypes.c_int

        def uniform(_, lib=lib, with_mask=False):
            out = torch.empty_like(sae)
            mask = (torch.empty(sae.shape, dtype=torch.bool, device=dev)
                    if with_mask else None)
            call(lib, "ts_decay_uniform", sae.data_ptr(), out.data_ptr(),
                 None if mask is None else mask.data_ptr(), cells, t_now,
                 *(float(x) for x in params), float(v_tw))
            return out, mask

        over = dict(kv.split("=") for kv in spec.partition(":")[2].split(",")
                    if kv)
        lead = cells // (cs.H * cs.W)
        grp = int(over.get("group", shape.group))
        tail = ((int(shape.vec4), grp, shape.grid[0], -(-lead // grp))
                if new_iface else ())

        def plane_form(_, lib=lib, new_iface=new_iface, tail=tail):
            out = torch.empty_like(sae)
            plane = cs.H * cs.W
            call(lib, "ts_decay_planes", sae.data_ptr(), out.data_ptr(), None,
                 lead if new_iface else cells, plane, t_now,
                 *(x.data_ptr() for x in planes), 0.0, *tail)
            return out

        v, _ = uniform(None)
        _, m = uniform(None, with_mask=True)
        print(f"ts_decay {spec}: uniform == plain version bitwise: "
              f"{cs.same(v, want[0])}; mask == plain: "
              f"{torch.equal(m, want[1])}; planes == plain bitwise: "
              f"{cs.same(plane_form(None), want_p)}", flush=True)
        for name, total, loop, kinds in sass_report(lib.so_path):
            if "decay" in name:
                print(f"  sass {name}: {total} instructions, longest loop "
                      f"{loop} ({kinds})", flush=True)
        fns[spec] = (uniform, lambda _, u=uniform: u(_, with_mask=True),
                     plane_form)
    dst = torch.empty_like(sae)
    t = timer(lambda _: dst.copy_(sae), 30)
    print(f"torch copy_ of the SAE (the library's device-to-device copy, "
          f"8 B a cell): {t:.4f} ms, {8 * cells / (t * 1e-3) / 1e9:.0f} "
          f"GB/s", flush=True)
    for i, form in enumerate(("uniform", "with mask", "planes")):
        times = in_turns(timer, {k: v[i] for k, v in fns.items()})
        for k, t in times.items():
            gbs = (8 + (i == 1)) * cells / (np.mean(t) * 1e-3) / 1e9
            print(f"ts_decay {form} {k}: {np.mean(t):.4f} ms, {gbs:.0f} GB/s "
                  f"(turns {[round(x, 4) for x in t]})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
