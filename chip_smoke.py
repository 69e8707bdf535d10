#!/usr/bin/env python3
"""Drive the repro_torch serving paths on one NVIDIA card and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``--prev DIR`` names another checkout (e.g. the parent commit's tree,
unpacked with ``git archive``): its ``stcf_support`` and
``chunk_scatter`` sources are built into a library of their own and timed
in turns with this tree's (old, new, new, old) in the kernel phase.

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and then, in order (phases 1-2 the time-surface path, 3-4 the LM path,
5 the vision heads and labeled ingest on the time-surface path):

1. **Engine** -- the time-surface path: a ``TimeSurfaceEngine`` of 64 slots of
   240x320 pixels and 2 polarities (chunks of 2048 events, eDRAM decay)
   with 64 attached sensors fed from seeded synthetic DND21-like scenes,
   served for 10 deadlines of 10 ms.  Each deadline runs ``serve_step``
   twice, on the two half-window bursts, with the FRAME spec (surface,
   mask, STCF support, 4-bit count, EBBI): a dense fill, then an
   incremental re-read of the dirty tiles.  The kernels' launch counters
   are zeroed just before and read just after.  Checks: incremental ==
   dense read bitwise; the engine's surface == ``ops.ts_decay`` of SAEs
   built independently with ``time_surface.sae_update``, bitwise; the
   SAE, counts, ``t_last`` and ``n_events`` == a CPU engine's on the same
   events, bitwise; every kernel of the path launched.
2. **Kernels** -- each kernel at the engine's full width on the engine's
   own state and a 10 ms push of ~2 M events, held against its plain
   PyTorch version on the card (decay within 2 ULP, counts exact away
   from the comparator threshold, scatter bitwise), and timed with CUDA
   events (median over launches, L2 flushed before each) beside its plain
   version, a one-call PyTorch yardstick where one exists (TF32 off), and
   the least time the card could take (bytes over 3.35 TB/s, operations
   over 67 TFLOP/s float32, the larger).  Besides: ``ts_decay`` with
   per-cell (H, W) parameter planes within 2 ULP at the pool's shape;
   ``chunk_scatter`` bitwise on duplicate-heavy traffic (90 % of the
   events on 8 cells, rows of 5,000 slots, out-of-range ids) at P = 2
   and at P = 1, its time without the L2 flush and without the dirty
   marks and counter plane, and the atomics per event it issues.
3. **LM** -- the Mamba-2 token-serving path: ``ServeEngine`` on
   mamba2-2.7b at full width and depth (d_model 2560, 80 SSD heads x 64,
   state 128, vocab 50280 padded to 50432, 64 layers, float32 master
   weights drawn on the card from a seeded generator, bf16 activations)
   serves 8 requests with seeded prompt lengths in 1024-2048 (left-padded,
   so at most 16 SSD chunks) and 32 greedy tokens each, after one warm-up
   serve.  The counters are zeroed just before and read just after.
   Prints prefill tokens/s, decode ms per step, and from one more prefill
   and decode step under ``torch.profiler`` their device time by op, the
   device's idle share and the share of a prefill spent in ``decay_scan``.  Checks: ``decay_scan`` launched n_layers times by the
   prefill and never by a decode step; every logit finite; every token
   below ``vocab``; then, on the same model at 2 layers in float32, the
   card against the CPU port (last logits and states within rtol = 1e-4,
   atol = 1e-4 x max(1, max|CPU|)) and the chunked prefill against
   prefill of all but the last token plus one recurrent ``decode_step``
   (the same band).
4. **decay_scan** -- the kernel at the prefill's shapes (8, chunks,
   655,360) against its plain version on the card, bitwise, with and
   without ``s0``, and timed like the others (no one PyTorch call
   computes this recurrence, so it has no yardstick).
5. **Heads and labels** -- the engine phase's configuration and traffic
   served through ``serve_step`` with the FRAME+heads spec: FRAME, a
   second ``Surface(mode="ideal", tau=5 ms)`` named ``fast``,
   ``logits = Classify(inputs=("surface", "fast"), n_classes=10,
   width=32)`` on weights drawn on the CPU from a seeded generator and
   registered under a key, and ``labels = Denoise()``; counters zeroed
   just before, read just after.  Prints the step p50/p99 and the
   ``Classify`` head's own time (CUDA events).  Checks: every logit
   finite; ``read`` == ``read_many([heads spec, FRAME])`` bitwise for
   every product; ``labels`` == ``stcf >= stcf_threshold`` bitwise; the
   card's logits for 4 slots == the CPU port's ``cnn_apply`` on the
   card's surfaces copied to the host (rtol = 1e-4, atol = 1e-4 x
   max(1, max|CPU|), float32, TF32 off); the three time-surface kernels
   launched.  Then one 10 ms push of 8 sensors through ``push_labeled``
   on the card and on a CPU engine: supports equal wherever no compared
   cell reads within 2 ULP of V_tw (the excepted events counted);
   sensor 0's labels == the offline ``stcf_chunked`` at chunk 2048 on
   the card, bitwise; ``roc_curve`` AUC against the driving scene's
   ground truth, card vs CPU, within 1e-6; events/s of the labeled push.
   Last, the pool's ``TsQuantized(n_bits=16, tick=1 ms)`` read within 2
   ULP of the plain ``ts_wrapped_read_ref`` on the card.

Output: progress lines, one JSON line of the kernels, the card's
``nvidia-smi`` name and power limit, and last the line
``{"ok": true, "device": {...}}``.  Any failed check, build error or
launch error exits nonzero without that line.  Without a CUDA device, or
without the repository's sources beside it, it exits 2.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores

S, P, H, W = 64, 2, 240, 320
CAP = 2048
N_SCENES = 8
DEADLINES = 10
DEADLINE_S = 0.010
RADIUS = 3
ENGINE_KERNELS = ("ts_decay", "stcf_support", "chunk_scatter")

LM_ARCH = "mamba2-2.7b"
LM_REQUESTS = 8
LM_PROMPT = (1024, 2048)      # prompt lengths drawn in [lo, hi]
LM_NEW_TOKENS = 32
CHECK_LAYERS = 2              # depth of the float32 card-vs-CPU model
CHECK_BATCH, CHECK_PROMPT = 2, 300
LM_TOL = 1e-4    # rtol; atol x max(1, max|ref|): float32 card vs CPU, recurrent

HEADS_KEY = "chip-smoke-heads"
HEADS_CLASSES, HEADS_WIDTH = 10, 32
HEADS_CHECK_SLOTS = 4
HEADS_TOL = 1e-4  # rtol; atol x max(1, max|CPU|): float32 card vs CPU CNN
LABEL_SENSORS = 8

REPLACES = {
    "ts_decay": "src/repro/kernels/ts_decay.py:107",
    "stcf_support": "src/repro/kernels/stcf.py:86",
    "chunk_scatter": "src/repro/kernels/ts_fused.py:81",
    "decay_scan": "src/repro/kernels/decay_scan.py:83",
}
SOURCES = {
    "ts_decay": "src/repro_torch/kernels/csrc/ts_decay.cu",
    "stcf_support": "src/repro_torch/kernels/csrc/stcf.cu",
    "chunk_scatter": "src/repro_torch/kernels/csrc/ts_fused.cu",
    "decay_scan": "src/repro_torch/kernels/csrc/decay_scan.cu",
}

FAILURES: list = []


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    log(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(bits(a).cpu(), bits(b).cpu())


class Timer:
    """Median kernel time in ms from CUDA events around single launches,
    with the 50 MB L2 flushed (and any per-launch state reset) outside the
    timed region before each one."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def __call__(self, fn, reps: int, setup=None, flush=True) -> float:
        for _ in range(2):
            fn(setup() if setup else None)
        times = []
        for _ in range(reps):
            arg = setup() if setup else None
            if flush:
                self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(arg)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def in_turns(timer, new, old, reps: int, what: str, **kw):
    """Time ``new`` alone, or ``old`` and ``new`` in turns (old, new, new,
    old) when there is an ``old``.  Returns (new ms, old ms or None), each
    the mean of its turns' medians."""
    if old is None:
        return timer(new, reps, **kw), None
    turns = [timer(fn, reps, **kw) for fn in (old, new, new, old)]
    log(f"  {what} in turns old, new, new, old: "
        f"{[round(t, 4) for t in turns]} ms")
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


def build_prev(prev_root: Path):
    """The ``stcf_support`` and ``chunk_scatter`` kernels of another
    checkout (``--prev``, e.g. the parent commit's tree), compiled with
    this tree's flags into a library of their own.  Returns a function
    that calls one of their C entry points on the current stream."""
    from repro_torch.kernels import _lib

    csrc = prev_root / "src" / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "prev_kernels"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    nvcc = _lib._nvcc()
    objs, procs = [], []
    for src in ("stcf.cu", "ts_fused.cu"):
        objs.append(str(out / (src + ".o")))
        procs.append(subprocess.Popen(
            [nvcc, *_lib.NVCC_FLAGS, "-c", str(csrc / src), "-o", objs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {prev_root}:\n{text}")
    lib_path = out / "libprev_kernels.so"
    subprocess.run([nvcc, "-shared", "-Xcompiler", "-fPIC", *objs, "-o",
                    str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("stcf_support_mask", "stcf_support_fused", "chunk_scatter"):
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    log(f"build: the previous stcf_support and chunk_scatter from "
        f"{csrc} -> {lib_path}")

    def call(name, *args):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous {name}: CUDA error {err}")
    return call


def prev_stcf(call, x, fused=None):
    """The previous ``stcf_support`` on (..., H, W) ``x`` at RADIUS."""
    h, w = x.shape[-2:]
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if fused is None:
        call("stcf_support_mask", x.data_ptr(), out.data_ptr(),
             x.numel() // (h * w), h, w, RADIUS, 0)
    else:
        params, v_tw, t_now = fused
        call("stcf_support_fused", x.data_ptr(), out.data_ptr(),
             x.numel() // (h * w), h, w, RADIUS, 0, float(t_now),
             *(float(v) for v in params), float(v_tw))
    return out


def prev_scatter(call, st, sids, ev, block):
    """The previous ``chunk_scatter`` into pool state ``st`` (sae, dirty,
    counts, t_last, n_events; any but sae may be None)."""
    s, p, h, w = st[0].shape
    b, n = ev.x.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    call("chunk_scatter", st[0].data_ptr(), s, p, h, w, sids.data_ptr(),
         ev.x.data_ptr(), ev.y.data_ptr(), ev.p.data_ptr(), ev.t.data_ptr(),
         ev.valid.data_ptr(), b, n, ptr(st[1]), block[0], block[1],
         ptr(st[2]), ptr(st[3]), ptr(st[4]))


def scatter_traffic(sids, ev, shape, block, segment):
    """What the sorted ``chunk_scatter`` issues for this push: the valid
    events, and the distinct (segment, key), (segment, cell) and
    (segment, tile) pairs -- one SAE atomic, one counter atomic and one
    dirty-mark store each (the per-event kernel issues two atomics and a
    store per valid event)."""
    s, p, h, w = shape
    b, n = ev.x.shape
    pol = torch.zeros_like(ev.p) if p == 1 else ev.p
    sid = sids.long()[:, None].expand(b, n)
    ok = (ev.valid & (ev.x >= 0) & (ev.x < w) & (ev.y >= 0) & (ev.y < h)
          & (pol >= 0) & (pol < p) & (sid >= 0) & (sid < s))
    j = torch.arange(n, device=ev.x.device)
    seg = (torch.arange(b, device=ev.x.device)[:, None] * -(-n // segment)
           + j // segment)[ok]
    x, y, pol = ev.x.long()[ok], ev.y.long()[ok], pol.long()[ok]
    cell = y * w + x
    th, tw = -(-h // block[0]), -(-w // block[1])
    tile = (pol * th + y // block[0]) * tw + x // block[1]
    n_ok = int(ok.sum())
    out = dict(events=n_ok)
    for name, v, span in (("sae_atomics", cell * p + pol, h * w * p),
                          ("count_atomics", cell, h * w),
                          ("dirty_stores", tile, p * th * tw)):
        out[name] = torch.unique(seg * span + v).numel()
    out["per_event"] = (out["sae_atomics"] + out["count_atomics"]) / max(n_ok, 1)
    return out


def duplicate_heavy_push(dev, s, p):
    """A seeded push at the engine's plane size: 8 rows of 5,000 event
    slots (more than one segment each), 90 % of the events on 8 hot
    cells, t on a 10 us grid (equal stamps inside a run), three rows
    aimed at slot 3, rows aimed at slots -1 and ``s`` (outside the pool),
    and x, y, p out of range on a few events."""
    from repro_torch.core import time_surface as ts

    g = torch.Generator(device=dev).manual_seed(5)
    b, n = 8, 5000

    def ints(lo, hi):
        return torch.randint(lo, hi, (b, n), generator=g, device=dev,
                             dtype=torch.int32)

    hot = torch.randint(0, 8, (b, n), generator=g, device=dev)
    hx = torch.randint(0, W, (8,), generator=g, device=dev, dtype=torch.int32)
    hy = torch.randint(0, H, (8,), generator=g, device=dev, dtype=torch.int32)
    is_hot = torch.rand((b, n), generator=g, device=dev) < 0.9
    pol = torch.where(torch.rand((b, n), generator=g, device=dev) < 0.01,
                      ints(0, 2) * 3 - 1, ints(0, p))   # -1 or 2 on 1 %
    ev = ts.EventBatch(
        x=torch.where(is_hot, hx[hot], ints(-2, W + 2)),
        y=torch.where(is_hot, hy[hot], ints(-2, H + 2)),
        t=0.1 + ints(0, 1000).float() * 1e-5,
        p=pol,
        valid=torch.rand((b, n), generator=g, device=dev) < 0.95)
    sids = torch.tensor([3, 3, 3, 7, s, 0, -1, s - 1], dtype=torch.int32,
                        device=dev)
    return sids, ev


def bound_ms(nbytes: float, nops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                        else "operations")


def make_scenes(datasets, aer):
    """Packed AER words per scene and half-deadline burst."""
    kinds = ("driving", "hotel_bar")
    duration = DEADLINES * DEADLINE_S
    half = DEADLINE_S / 2
    words = []
    for k in range(N_SCENES):
        s = datasets.dnd21_like(kinds[k % 2], H, W, duration, seed=k)
        words.append([aer.pack(s.window(b * half, (b + 1) * half))
                      for b in range(2 * DEADLINES)])
    return words


def run_engine(dev, mods, words, card):
    """Phase 1: the serving loop.  Returns what the kernel phase needs."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    base = dict(h=H, w=W, polarities=P, n_slots=S, chunk_capacity=CAP,
                mode="edram", specs=(frame,))
    cfg = eng.TSEngineConfig(**base)
    # a gather cap of the whole pool keeps every second burst on the
    # incremental path, whatever share of tiles the burst dirties
    cfg = dataclasses.replace(cfg, max_dirty_tiles=S * cfg.tile_counts()[2])
    engine = eng.TimeSurfaceEngine(cfg)
    sessions = [engine.attach() for _ in range(S)]
    scene_of = [k % N_SCENES for k in range(S)]
    bursts = [[(sessions[k], words[scene_of[k]][b]) for k in range(S)]
              for b in range(2 * DEADLINES)]
    tiles_total = engine.state.cache.dirty.numel()

    torch.cuda.synchronize()
    _lib.reset_launches()
    step_ms, dirty_share, mismatched = [], [], []
    t_wall = 0.0
    for d in range(DEADLINES):
        t_now = (d + 1) * DEADLINE_S
        for half in range(2):
            items = bursts[2 * d + half]
            t0 = time.perf_counter()
            out = engine.serve_step(items, frame, t_now)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            t_wall += dt
            step_ms.append(dt * 1e3)
        path_counts = dict(_lib.LAUNCHES)   # the check read is not counted
        dense = engine.read(rs.SURFACE_SPEC, t_now)["surface"]
        _lib.LAUNCHES.update(path_counts)
        if not same(out["surface"], dense):
            mismatched.append(d)
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    n_events = int(engine.state.surfaces.n_events.sum())

    log(f"engine on {card}: {S} sensors x {P}x{H}x{W}, {DEADLINES} deadlines "
        f"x 2 bursts, {n_events} events ingested in {t_wall:.4f} s of "
        f"serve_step -> {n_events / t_wall:.1f} events/s")
    steady = step_ms[2:]   # the first deadline pays first-touch costs
    log(f"engine on {card}: serve_step (push + read) latency over deadlines "
        f"2..{DEADLINES}: "
        f"p50 {np.percentile(steady, 50):.3f} ms, "
        f"p99 {np.percentile(steady, 99):.3f} ms "
        f"(dense fill p50 {np.percentile(steady[0::2], 50):.3f} ms, "
        f"incremental p50 {np.percentile(steady[1::2], 50):.3f} ms); "
        f"first deadline {step_ms[0]:.3f} + {step_ms[1]:.3f} ms")
    log(f"engine: every serve_step, ms: {[round(x, 3) for x in step_ms]}")
    log(f"engine: kernel launches on the path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the engine path ({n})")

    check(not mismatched, f"incremental serve_step == dense read, bitwise, "
          f"at every deadline (mismatched: {mismatched})")
    t_end = DEADLINES * DEADLINE_S

    # independent offline build: unpack every word a scene sent, sae_update
    params = cfg.decay_params()
    offline = []
    for k in range(N_SCENES):
        stream = aer.unpack(np.concatenate(words[k]), H, W)
        batch = pipeline.to_event_batch(stream, device=dev)
        offline.append(ts.sae_update(ts.empty_sae(H, W, P, dev), batch))
    offline = torch.stack([offline[scene_of[k]] for k in range(S)])
    check(same(offline, engine.state.surfaces.sae),
          "engine SAE == offline sae_update SAE, bitwise")
    check(same(ops.ts_decay(offline, t_end, params), out["surface"]),
          "engine surface == ops.ts_decay(offline SAE), bitwise")

    # the CPU port on the same events
    cpu = eng.TimeSurfaceEngine(cfg, device="cpu")
    cpu_sessions = [cpu.attach() for _ in range(S)]
    for items in bursts:
        cpu.push([(cpu_sessions[k], w) for k, (_, w) in enumerate(items)])
        dirty_share.append(float(cpu.state.cache.dirty.float().mean()))
        cpu.state.cache.dirty.zero_()
    g, c = engine.state, cpu.state
    for name, a, b in (("sae", g.surfaces.sae, c.surfaces.sae),
                       ("t_last", g.surfaces.t_last, c.surfaces.t_last),
                       ("n_events", g.surfaces.n_events, c.surfaces.n_events),
                       ("counts", g.counts, c.counts)):
        check(same(a, b), f"card {name} == CPU port {name}, bitwise")
    log(f"engine: share of the pool's {tiles_total} dirty tiles written by "
        f"one 5 ms burst: mean {np.mean(dirty_share):.4f}")
    split_pass(eng, cfg, frame, words, scene_of)
    return dict(engine=engine, cfg=cfg, t_end=t_end, launches=launches,
                n_events=n_events, events_per_s=n_events / t_wall,
                step_ms=step_ms)


def split_pass(eng, cfg, frame, words, scene_of):
    """Where a serve_step's time goes: the same bursts into a fresh engine,
    each step run as its two halves -- ``push``, then the cached read
    ``serve_step`` does after its push -- with the host-only part of the
    push (cutting payloads into chunks, ``_collect``) timed on its own
    first.  Runs after the path's launch counts were read."""
    engine = eng.TimeSurfaceEngine(cfg)
    for _ in range(S):
        engine.attach()
    rows = []
    for b in range(2 * DEADLINES):
        items = [(k, words[scene_of[k]][b]) for k in range(S)]
        t_now = (b // 2 + 1) * DEADLINE_S
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine._collect(items)
        t1 = time.perf_counter()
        engine.push(items)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        engine.serve_step([], frame, t_now)
        torch.cuda.synchronize()
        rows.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    r = np.array(rows[2:]) * 1e3
    med = np.median(r, axis=0)
    log(f"engine breakdown, every step (chunking, push, read) ms: "
        f"{[tuple(round(x * 1e3, 3) for x in row) for row in rows]}")
    log(f"engine breakdown, median ms over steps 3..{2 * DEADLINES}: host "
        f"chunking alone {med[0]:.3f}; push (chunking + copy + scatter) "
        f"{med[1]:.3f}; cached read {med[2]:.3f} (dense "
        f"{np.median(r[0::2, 2]):.3f}, incremental {np.median(r[1::2, 2]):.3f})")


def kernel_phase(dev, mods, words, run, prev=None):
    """Phase 2: each kernel vs its plain version, and its times; with
    ``prev`` (``build_prev``), the previous ``stcf_support`` and
    ``chunk_scatter`` timed in turns with the current ones."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.core import edram
    from repro_torch.kernels import ref
    from repro_torch.kernels.stcf import stcf_support_cuda
    from repro_torch.kernels.ts_decay import ts_decay_cuda
    from repro_torch.kernels.ts_fused import SEGMENT, chunk_scatter_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timer = Timer(dev)
    engine, cfg, t_now = run["engine"], run["cfg"], run["t_end"]
    sae = engine.state.surfaces.sae
    params, v_tw = cfg.decay_params(), cfg.v_tw()
    cells = sae.numel()
    rows = []

    # -- ts_decay: the Surface product's read of the whole pool
    v = ts_decay_cuda(sae, t_now, params)
    vr, mr = ref.ts_decay_ref(sae, t_now, params, v_tw)
    _, m = ts_decay_cuda(sae, t_now, params, v_tw)
    ulp = int(ref.ulp_distance(v, vr).max())
    near = ref.ulp_distance(vr, torch.full_like(vr, v_tw)) <= 4
    check(ulp <= 2, f"ts_decay within 2 ULP of its plain version ({ulp})")
    check(torch.equal(m[~near], mr[~near]),
          f"ts_decay mask exact away from v_tw ({int(near.sum())} cells "
          "within 4 ULP)")
    ms = timer(lambda _: ts_decay_cuda(sae, t_now, params), 30)
    ms_mask = timer(lambda _: ts_decay_cuda(sae, t_now, params, v_tw), 30)
    plain = timer(lambda _: ref.ts_decay_ref(sae, t_now, params), 10)
    b_ms, b_by = bound_ms(8 * cells, 12 * cells)
    log(f"ts_decay: {ms:.4f} ms (with mask {ms_mask:.4f} ms, bound "
        f"{bound_ms(9 * cells, 13 * cells)[0]:.4f} ms), plain {plain:.4f} ms, "
        f"bound {b_ms:.4f} ms")
    # the per-cell-plane entry (ts_decay_planes) at the pool's shape: tau1
    # and tau2 varied per cell by a seeded 5 % spread
    g = torch.Generator(device=dev).manual_seed(4)
    eps = 1.0 + 0.05 * torch.randn((2, H, W), generator=g, device=dev)
    full = lambda x: torch.full((H, W), float(x), device=dev)
    planes = edram.DecayParams(full(params.a1), float(params.tau1) / eps[0],
                               full(params.a2), float(params.tau2) / eps[1],
                               full(params.b))
    vp = ts_decay_cuda(sae, t_now, planes)
    ulp_p = int(ref.ulp_distance(vp, ref.ts_decay_ref(sae, t_now, planes))
                .max())
    check(ulp_p <= 2, f"ts_decay with (H, W) parameter planes within 2 ULP "
          f"of its plain version at {tuple(sae.shape)} ({ulp_p})")
    ms_planes = timer(lambda _: ts_decay_cuda(sae, t_now, planes), 30)
    log(f"ts_decay with parameter planes: {ms_planes:.4f} ms, bound "
        f"{bound_ms(8 * cells + 20 * H * W, 12 * cells)[0]:.4f} ms")
    rows.append(dict(name="ts_decay", max_abs_err=float((v - vr).abs().max()),
                     max_ulp=ulp, near_threshold_cells=int(near.sum()),
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, ms_with_mask=ms_mask,
                     planes_ms=ms_planes, planes_max_ulp=ulp_p))

    # -- stcf_support: the Stcf product (fused decay + compare + count)
    s = stcf_support_cuda(sae, RADIUS, False, fused=(params, v_tw, t_now))
    sr = ref.stcf_support_fused_ref(sae, RADIUS, params, v_tw, t_now)
    near_p = ref.stcf_support_ref(near, RADIUS, include_self=True) > 0
    check(torch.equal(s[~near_p], sr[~near_p]),
          f"stcf_support fused exact away from v_tw ({int(near_p.sum())} "
          "pixels see a near-threshold cell)")
    check(torch.equal(s, stcf_support_cuda(m, RADIUS, False)),
          "stcf_support fused == ts_decay mask -> stcf_support, bitwise")
    sm = stcf_support_cuda(m, RADIUS, False)
    check(torch.equal(sm, ref.stcf_support_ref(m, RADIUS)),
          "stcf_support on the mask == its plain version")
    fused = (params, v_tw, t_now)
    old_f = old_m = None
    if prev is not None:
        check(torch.equal(prev_stcf(prev, sae, fused), s)
              and torch.equal(prev_stcf(prev, m), sm),
              "the previous stcf_support gives the same counts, both forms")
        old_f = lambda _: prev_stcf(prev, sae, fused)
        old_m = lambda _: prev_stcf(prev, m)
    ms, prev_ms = in_turns(timer, lambda _: stcf_support_cuda(
        sae, RADIUS, False, fused=fused), old_f, 30, "stcf_support fused")
    plain = timer(lambda _: ref.stcf_support_fused_ref(
        sae, RADIUS, params, v_tw, t_now), 5)
    ms_m, prev_m = in_turns(timer, lambda _: stcf_support_cuda(
        m, RADIUS, False), old_m, 30, "stcf_support mask form")
    plain_m = timer(lambda _: ref.stcf_support_ref(m, RADIUS), 5)
    k = 2 * RADIUS + 1
    ones = torch.ones((1, 1, k, k), device=dev)
    ones[..., RADIUS, RADIUS] = 0.0
    mf = m.reshape(-1, 1, H, W).float()
    conv = torch.nn.functional.conv2d(mf, ones, padding=RADIUS)
    check(torch.equal(conv.round().int().reshape(sm.shape), sm),
          "conv2d yardstick computes the same support counts")
    lib_m = timer(lambda _: torch.nn.functional.conv2d(mf, ones,
                                                       padding=RADIUS), 30)
    b_ms, b_by = bound_ms(8 * cells, (12 + 2 * k) * cells)
    log(f"stcf_support fused: {ms:.4f} ms (previous kernel "
        f"{prev_ms if prev_ms is None else round(prev_ms, 4)} ms), plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms; mask form: {ms_m:.4f} ms "
        f"(previous {prev_m if prev_m is None else round(prev_m, 4)} ms), "
        f"plain {plain_m:.4f} ms, conv2d {lib_m:.4f} ms, bound "
        f"{bound_ms(5 * cells, 2 * k * cells)[0]:.4f} ms")
    rows.append(dict(name="stcf_support",
                     max_abs_err=float((s - sr).abs().max()),
                     near_threshold_pixels=int(near_p.sum()), ms=ms,
                     plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, prev_kernel_ms=prev_ms,
                     mask_form_ms=ms_m, mask_form_prev_ms=prev_m,
                     mask_form_plain_ms=plain_m,
                     mask_form_library_ms=lib_m))

    # -- chunk_scatter: one 10 ms push of every sensor (~2 M events)
    sids, fields = engine._collect(
        [(k, np.concatenate(words[k % N_SCENES][2:4])) for k in range(S)])
    ev = ts.EventBatch(*(torch.from_numpy(f).to(dev) for f in fields))
    sids = torch.from_numpy(sids).to(dev)
    n_ev = int(ev.valid.sum())
    base = engine.state

    def fresh(_=None):
        return (base.surfaces.sae.clone(), base.cache.dirty.clone(),
                base.counts.clone(), base.surfaces.t_last.clone(),
                base.surfaces.n_events.clone())

    outs = []
    for fn in (chunk_scatter_cuda, ref.chunk_scatter_ref):
        st = fresh()
        fn(st[0], sids, ev, st[1], cfg.block, st[2], st[3], st[4])
        outs.append(st)
    exact = all(same(a, b) for a, b in zip(*outs))
    check(exact, f"chunk_scatter == its plain version on {n_ev} events: SAE, "
          "dirty, counts, t_last, n_events bitwise")
    err = torch.nan_to_num(outs[0][0] - outs[1][0], nan=0.0).abs().max()
    scat = lambda st: chunk_scatter_cuda(st[0], sids, ev, st[1], cfg.block,
                                         st[2], st[3], st[4])
    old_scat = None
    if prev is not None:
        st = fresh()
        prev_scatter(prev, st, sids, ev, cfg.block)
        check(all(same(a, b) for a, b in zip(st, outs[0])),
              "the previous chunk_scatter gives the same five outputs")
        old_scat = lambda st: prev_scatter(prev, st, sids, ev, cfg.block)
    ms, prev_ms = in_turns(timer, scat, old_scat, 30, "chunk_scatter",
                           setup=fresh)
    plain = timer(lambda st: ref.chunk_scatter_ref(
        st[0], sids, ev, st[1], cfg.block, st[2], st[3], st[4]), 5,
        setup=fresh)

    # where its time goes: (a) as timed above, L2 flushed; (b) the same
    # without the flush; (c) flushed, with no dirty marks and no counter
    # plane (the SAE, t_last and n_events only)
    sae_only = lambda st: (st[0], None, None, st[3], st[4])
    diag = {}
    for who, fn in (("kernel", scat), ("previous kernel", old_scat)):
        if fn is None:
            continue
        diag[who] = dict(
            flushed=ms if who == "kernel" else prev_ms,
            warm=timer(fn, 30, setup=fresh, flush=False),
            sae_t_only=timer(fn, 30, setup=lambda: sae_only(fresh())))
        log(f"chunk_scatter diagnosis, {who}: (a) L2 flushed "
            f"{diag[who]['flushed']:.4f} ms, (b) not flushed "
            f"{diag[who]['warm']:.4f} ms, (c) flushed, dirty = counts = "
            f"None {diag[who]['sae_t_only']:.4f} ms")
    traffic = scatter_traffic(sids, ev, tuple(base.surfaces.sae.shape),
                              cfg.block, SEGMENT)
    log(f"chunk_scatter traffic: {traffic['events']} valid events -> "
        f"{traffic['sae_atomics']} SAE atomics, {traffic['count_atomics']} "
        f"counter atomics, {traffic['dirty_stores']} dirty-mark stores "
        f"merged per {SEGMENT}-slot segment: "
        f"{traffic['per_event']:.4f} atomics per event (2 unmerged)")

    # duplicate-heavy traffic, at P = 2 on the engine's state and at P = 1
    # on a polarity-merged pool, bitwise against the plain version
    dup = {}
    for pp in (P, 1):
        d_sids, d_ev = duplicate_heavy_push(dev, S, pp)
        if pp == P:
            start = fresh
        else:
            sae1 = base.surfaces.sae.amax(dim=1, keepdim=True)
            start = lambda _=None: (
                sae1.clone(), torch.zeros((S, ops.tile_geometry(
                    H, W, cfg.block)[2]), dtype=torch.bool, device=dev),
                base.counts.clone(), base.surfaces.t_last.clone(),
                base.surfaces.n_events.clone())
        d_outs = []
        for fn in (chunk_scatter_cuda, ref.chunk_scatter_ref):
            st = start()
            fn(st[0], d_sids, d_ev, st[1], cfg.block, st[2], st[3], st[4])
            d_outs.append(st)
        d_tr = scatter_traffic(d_sids, d_ev, (S, pp, H, W), cfg.block,
                               SEGMENT)
        check(all(same(a, b) for a, b in zip(*d_outs)),
              f"chunk_scatter == its plain version on duplicate-heavy "
              f"traffic at P = {pp} ({d_tr['events']} valid events, "
              f"{d_tr['per_event']:.4f} atomics per event): SAE, dirty, "
              f"counts, t_last, n_events bitwise")
        if pp == P:
            d_scat = lambda st: chunk_scatter_cuda(
                st[0], d_sids, d_ev, st[1], cfg.block, st[2], st[3], st[4])
            d_old = None if prev is None else (lambda st: prev_scatter(
                prev, st, d_sids, d_ev, cfg.block))
            dup = dict(zip(("ms", "prev_ms"), in_turns(
                timer, d_scat, d_old, 30, "chunk_scatter, duplicate-heavy",
                setup=start)), atomics_per_event=d_tr["per_event"])
            log(f"chunk_scatter duplicate-heavy: {dup['ms']:.4f} ms "
                f"(previous kernel {dup['prev_ms']} ms)")
    ok = ev.valid & (ev.x >= 0) & (ev.x < W) & (ev.y >= 0) & (ev.y < H)
    sid = sids.long()[:, None].expand_as(ev.x)
    lin = (((sid * P + ev.p.long()) * H + ev.y.long()) * W + ev.x.long())
    lin = torch.where(ok, lin, torch.zeros_like(lin)).flatten()
    tval = torch.where(ok, ev.t, torch.full_like(ev.t, float("-inf"))).flatten()
    lib = timer(lambda st: st[0].view(-1).scatter_reduce_(
        0, lin, tval, "amax"), 30, setup=fresh)
    ys, xs = ev.y.long()[ok], ev.x.long()[ok]
    cells_hit = torch.unique(lin[ok.flatten()]).numel()
    counts_hit = torch.unique((sid[ok] * H + ys) * W + xs).numel()
    th, tw, tpl = ops.tile_geometry(H, W, cfg.block)
    tiles_hit = torch.unique(sid[ok] * (P * tpl) + (ev.p.long()[ok] * th
                             + ys // cfg.block[0]) * tw
                             + xs // cfg.block[1]).numel()
    nbytes = (17 * ev.x.numel() + 4 * sids.numel() + 8 * cells_hit
              + 8 * counts_hit + tiles_hit + 16 * S)
    b_ms, b_by = bound_ms(nbytes, 2 * n_ev)
    log(f"chunk_scatter: {ev.x.shape[0]} chunks x {CAP}, {n_ev} valid events, "
        f"{cells_hit} cells hit: {ms:.4f} ms (previous kernel "
        f"{prev_ms if prev_ms is None else round(prev_ms, 4)} ms), plain "
        f"{plain:.4f} ms, "
        f"scatter_reduce_ amax (SAE only) {lib:.4f} ms, bound {b_ms:.4f} ms "
        f"({nbytes} B)")
    rows.append(dict(name="chunk_scatter", max_abs_err=float(err),
                     bitwise=exact, events=n_ev, chunks=int(ev.x.shape[0]),
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib, prev_kernel_ms=prev_ms,
                     diagnosis=diag, traffic=traffic,
                     duplicate_heavy=dup))
    return rows


def profiled(fn):
    """Run ``fn`` once under ``torch.profiler`` (CPU + CUDA).  Returns its
    host time (ms, profiler overhead included), the summed device time of
    its kernels, their count, and the device time by PyTorch op."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    avgs = prof.key_averages()
    kernels = {e.key: e.self_device_time_total / 1e3 for e in avgs
               if e.device_type == cuda}
    return dict(wall_ms=wall, device_ms=sum(kernels.values()),
                kernels=kernels,
                launches=sum(e.count for e in avgs if e.device_type == cuda),
                ops={e.key: e.self_device_time_total / 1e3 for e in avgs
                     if e.device_type != cuda and e.key.startswith("aten::")
                     and e.self_device_time_total > 0})


def profile_line(what: str, r: dict, step_ms=None) -> None:
    """Log one ``profiled`` run: device time, launches, the device's idle
    share of the profiled host time (and of ``step_ms``, an unprofiled
    step, when given) and the device time of the top PyTorch ops."""
    top = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:6]
    idle = f"{100 * (1 - r['device_ms'] / r['wall_ms']):.1f} % of it"
    if step_ms is not None:
        idle += (f", {100 * (1 - r['device_ms'] / step_ms):.1f} % of an "
                 f"unprofiled {step_ms:.3f} ms step")
    log(f"{what}: device kernels {r['device_ms']:.3f} ms in "
        f"{r['wall_ms']:.3f} ms profiled -> device idle {idle}; "
        f"{r['launches']} kernel launches; device ms by op: "
        f"{[(k, round(v, 3)) for k, v in top]}")


def lm_requests(cfg, request_cls):
    """The LM phase's traffic: seeded prompt lengths and tokens."""
    rng = np.random.default_rng(0)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    return [request_cls(rng.integers(0, cfg.vocab, n).astype(np.int32),
                        max_new_tokens=LM_NEW_TOKENS) for n in lens]


def run_lm(dev, card):
    """Phase 3: Mamba-2 token serving at full width and depth, bf16.
    Returns what the decay_scan kernel phase needs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.models import module as M
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = get_config(LM_ARCH)
    di, h, p, n = SSM.ssm_dims(cfg)
    check((cfg.d_model, di, h, p, n, cfg.vocab, T.padded_vocab(cfg))
          == (2560, 5120, 80, 64, 128, 50280, 50432)
          and cfg.activation_dtype == torch.bfloat16,
          f"{LM_ARCH} at full width: d_model {cfg.d_model}, d_inner {di}, "
          f"{h} heads x {p}, state {n}, vocab {cfg.vocab} padded to "
          f"{T.padded_vocab(cfg)}, {cfg.n_layers} layers, "
          f"{cfg.activation_dtype}")
    t0 = time.perf_counter()
    params = M.init_params(T.param_defs(cfg),
                           torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in M.flatten(params).values())
    log(f"lm: {n_params} float32 parameters ({n_params * 4 / 1e9:.2f} GB) "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    engine = ServeEngine(cfg, params, max_len=LM_PROMPT[1] + LM_NEW_TOKENS)
    reqs = lm_requests(cfg, Request)

    calls = []   # (kind, seconds, decay_scan launches, logits finite)
    plain_prefill, plain_decode = engine._prefill, engine._decode

    def timed(kind, fn):
        def run(*args):
            torch.cuda.synchronize()
            n0 = _lib.LAUNCHES["decay_scan"]
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            calls.append((kind, dt, _lib.LAUNCHES["decay_scan"] - n0,
                          bool(torch.isfinite(out[0]).all())))
            return out
        return run

    engine._prefill = timed("prefill", plain_prefill)
    engine._decode = timed("decode", plain_decode)
    t0 = time.perf_counter()
    engine.serve([Request(r.prompt, max_new_tokens=2) for r in reqs])
    log(f"lm: warm-up serve (same prompts, 2 tokens) "
        f"{time.perf_counter() - t0:.2f} s")
    calls.clear()
    torch.cuda.reset_peak_memory_stats(dev)

    torch.cuda.synchronize()
    _lib.reset_launches()
    t0 = time.perf_counter()
    results = engine.serve(reqs)
    wall = time.perf_counter() - t0
    launches = dict(_lib.LAUNCHES)

    s_max = max(len(r.prompt) for r in reqs)
    prefill = [c for c in calls if c[0] == "prefill"]
    decode = [c for c in calls if c[0] == "decode"]
    real = sum(len(r.prompt) for r in reqs)
    pf_s = prefill[0][1]
    dec_ms = [c[1] * 1e3 for c in decode]
    log(f"lm on {card}: {LM_ARCH}, {cfg.n_layers} layers, {LM_REQUESTS} "
        f"requests, prompts {sorted(len(r.prompt) for r in reqs)} "
        f"(left-padded to {s_max}, {-(-s_max // cfg.ssm_chunk)} SSD chunks), "
        f"{LM_NEW_TOKENS} new tokens each; serve {wall:.3f} s")
    log(f"lm on {card}: prefill {pf_s * 1e3:.3f} ms -> "
        f"{LM_REQUESTS * s_max / pf_s:.1f} tokens/s computed "
        f"({real / pf_s:.1f} prompt tokens/s without the left padding)")
    log(f"lm on {card}: decode step p50 {np.percentile(dec_ms, 50):.3f} ms, "
        f"p99 {np.percentile(dec_ms, 99):.3f} ms, min {min(dec_ms):.3f} ms "
        f"over {len(dec_ms)} steps of batch {LM_REQUESTS} -> "
        f"{LM_REQUESTS * 1e3 / np.percentile(dec_ms, 50):.1f} tokens/s; "
        f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    log(f"lm: every decode step, ms: {[round(x, 3) for x in dec_ms]}")
    log(f"lm: kernel launches on the path: {launches}")
    check(len(prefill) == 1 and prefill[0][2] == cfg.n_layers
          and launches["decay_scan"] == cfg.n_layers,
          f"decay_scan launched n_layers = {cfg.n_layers} times by the one "
          f"prefill ({[c[2] for c in prefill]})")
    check(len(decode) == LM_NEW_TOKENS - 1 and all(c[2] == 0 for c in decode),
          f"decay_scan launched 0 times by each of {len(decode)} decode steps")
    check(all(c[3] for c in calls), "every prefill and decode logit finite")
    toks = np.stack([r.tokens for r in results])
    check(toks.shape == (LM_REQUESTS, LM_NEW_TOKENS) and toks.min() >= 0
          and toks.max() < cfg.vocab,
          f"tokens {toks.shape} within [0, vocab = {cfg.vocab})")

    # where a prefill's and a decode step's time goes: each once more under
    # torch.profiler, after the path's counts were read
    tokens = torch.zeros((LM_REQUESTS, s_max), dtype=torch.int32)
    for i, r in enumerate(reqs):
        tokens[i, s_max - len(r.prompt):] = torch.from_numpy(r.prompt)
    tokens = tokens.to(dev)
    with torch.inference_mode():
        pf = profiled(lambda: plain_prefill(params, tokens))
        _, caches, pos = plain_prefill(params, tokens)
        cur = tokens[:, -1:]
        dc = profiled(lambda: plain_decode(params, cur, caches, pos))
    scan_ms = sum(v for k, v in pf["kernels"].items() if "decay_scan" in k)
    for name, r, step_ms in (("prefill", pf, pf_s * 1e3),
                             ("decode step", dc, np.percentile(dec_ms, 50))):
        profile_line(f"lm profile, one {name}", r, step_ms)
    check(scan_ms > 0, "torch.profiler traced the prefill's decay_scan kernels")
    log(f"lm: decay_scan kernels inside one prefill: {scan_ms:.3f} ms of the "
        f"{pf_s * 1e3:.3f} ms prefill -> {100 * scan_ms / (pf_s * 1e3):.2f} % "
        f"of prefill time")
    del engine, params
    torch.cuda.empty_cache()
    lm_checks(dev, cfg, M, T)
    return dict(launches=launches, b=LM_REQUESTS,
                nc=-(-s_max // cfg.ssm_chunk), c=h * p * n,
                prefill_ms=pf_s * 1e3)


def lm_checks(dev, cfg, M, T):
    """The full-width model at CHECK_LAYERS layers in float32: the card
    against the CPU port on the same weights, and, on the card, the
    chunked prefill against prefill of all but the last token followed by
    one recurrent decode step."""
    cfg = dataclasses.replace(cfg, n_layers=CHECK_LAYERS, dtype="float32")
    card = M.init_params(T.param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(1), dev)
    cpu = M.unflatten({k: v.cpu() for k, v in M.flatten(card).items()})
    g = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (CHECK_BATCH, CHECK_PROMPT),
                           generator=g, dtype=torch.int32)

    def err(a, b):
        """max |a - b|, and whether a is within rtol = LM_TOL, atol =
        LM_TOL x max(1, max|b|) of b (sums of terms of b's size cancel
        near zero)."""
        a, b = a.float().cpu(), b.float().cpu()
        scale = max(1.0, float(b.abs().max()))
        return (float((a - b).abs().max()),
                bool(torch.allclose(a, b, rtol=LM_TOL, atol=LM_TOL * scale)))

    with torch.inference_mode():
        t0 = time.perf_counter()
        lg, cg, _ = T.prefill(card, tokens.to(dev), cfg, CHECK_PROMPT,
                              last_logits_only=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lc, cc, _ = T.prefill(cpu, tokens, cfg, CHECK_PROMPT,
                              last_logits_only=True)
        t2 = time.perf_counter()
        e_logit, ok_logit = err(lg, lc)
        e_state = [err(a["ssm"]["state"], b["ssm"]["state"])
                   for a, b in zip(cg, cc)]
        check(ok_logit and all(ok for _, ok in e_state),
              f"{cfg.name} full width, {CHECK_LAYERS} layers, float32, "
              f"batch {CHECK_BATCH} x {CHECK_PROMPT} tokens: card == CPU port "
              f"within rtol = {LM_TOL}, atol = {LM_TOL} x max(1, max|CPU|) "
              f"(max |d| last logits "
              f"{e_logit:.3e} of max |logit| {float(lc.abs().max()):.3e}; "
              f"states {[f'{e:.3e}' for e, _ in e_state]}; card "
              f"{(t1 - t0) * 1e3:.1f} ms, CPU {(t2 - t1) * 1e3:.1f} ms)")
        _, caches, pos = T.prefill(card, tokens[:, :-1].to(dev), cfg,
                                   CHECK_PROMPT)
        step, sc = T.decode_step(card, tokens[:, -1:].to(dev), caches, pos,
                                 cfg)
        e_step, ok_step = err(step, lg)
        e_rec = [err(a["ssm"]["state"], b["ssm"]["state"])
                 for a, b in zip(sc, cg)]
        check(ok_step and all(ok for _, ok in e_rec),
              f"chunked prefill == prefill(prompt[:-1]) + decode_step on the "
              f"card within the same band (max |d| logits "
              f"{e_step:.3e}, states {[f'{e:.3e}' for e, _ in e_rec]})")


def decay_scan_phase(dev, lm):
    """Phase 4: decay_scan at the LM prefill's shapes vs its plain version,
    and its times."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decay_scan import decay_scan_cuda

    b, t, c = lm["b"], lm["nc"], lm["c"]
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.exp(-torch.rand((b, t, c), generator=g, device=dev))
    x = torch.randn((b, t, c), generator=g, device=dev)
    s0 = torch.randn((b, c), generator=g, device=dev)
    st, fin = decay_scan_cuda(a, x)
    st_r, fin_r = ref.decay_scan_ref(a, x)
    st0, fin0 = decay_scan_cuda(a, x, s0)
    st0_r, fin0_r = ref.decay_scan_ref(a, x, s0)
    ok = all(same(u, v) for u, v in ((st, st_r), (fin, fin_r), (st0, st0_r),
                                     (fin0, fin0_r)))
    ulp = max(int(ref.ulp_distance(u, v).max()) for u, v in
              ((st, st_r), (fin, fin_r), (st0, st0_r), (fin0, fin0_r)))
    check(ok, f"decay_scan == its plain version bitwise at ({b}, {t}, {c}), "
          f"with and without s0 (max {ulp} ULP)")
    timer = Timer(dev)
    ms = timer(lambda _: decay_scan_cuda(a, x), 30)
    plain = timer(lambda _: ref.decay_scan_ref(a, x), 10)
    nbytes = 4 * (3 * b * t * c + b * c)
    b_ms, b_by = bound_ms(nbytes, 2 * b * t * c)
    log(f"decay_scan: ({b}, {t}, {c}) {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b_ms:.4f} ms ({nbytes} B); x {lm['launches']['decay_scan']} "
        f"launches = {ms * lm['launches']['decay_scan']:.3f} ms of a "
        f"{lm['prefill_ms']:.3f} ms prefill")
    return [dict(name="decay_scan", max_abs_err=float(max(
        (st - st_r).abs().max(), (fin0 - fin0_r).abs().max())), max_ulp=ulp,
        shape=[b, t, c], ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None)]


def label_band(sae, ev, cfg, stcf_mod, edram, ref, ts) -> torch.Tensor:
    """Per valid event of one sensor's labeled push from an empty slot:
    whether any cell or earlier event its STCF support compares reads
    within 2 ULP of V_tw -- replayed chunk by chunk on the CPU as the
    engine labels them (against the SAE of the earlier chunks, plus the
    chunk's own earlier events)."""
    scfg, params, v_tw = cfg.stcf_config(), cfg.decay_params(), cfg.v_tw()

    def close(dt):
        v = edram.v_mem(dt, params)
        return ref.ulp_distance(v, torch.full_like(v, v_tw)) <= 2

    out = []
    for lo in range(0, ev.x.shape[0], CAP):
        ch = ts.EventBatch(*(f[lo:lo + CAP] for f in ev))
        cell, inb = stcf_mod._patch(sae.shape, ch.x, ch.y, ch.p, scfg)
        band = (close(ch.t[:, None] - sae.reshape(-1)[cell]) & inb).any(1)
        near = (((ch.x[:, None] - ch.x[None, :]).abs() <= scfg.radius)
                & ((ch.y[:, None] - ch.y[None, :]).abs() <= scfg.radius))
        dt = ch.t[:, None] - ch.t[None, :]
        band |= (near & (dt > 0) & ch.valid[None, :]
                 & close(dt.clamp_min(0.0))).any(1)
        out.append(band[ch.valid])
        sae = ts.sae_update(sae, ch)
    return torch.cat(out)


def run_heads(dev, mods, words, card, timer):
    """Phase 5: the vision heads and labeled ingest.  Returns the heads
    path's kernel launches and what the phase measured."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.core import edram
    from repro_torch.core import stcf as stcf_mod
    from repro_torch.events import datasets
    from repro_torch.kernels import ref
    from repro_torch.models import cnn
    from repro_torch.models import module as M
    from repro_torch.models.frontends import ts_stack_frontend
    from repro_torch.serve import heads

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    spec = rs.ReadoutSpec(
        **dict(frame.products), fast=rs.surface(mode="ideal", tau=5e-3),
        logits=rs.classify(inputs=("surface", "fast"), weights=HEADS_KEY,
                           n_classes=HEADS_CLASSES, width=HEADS_WIDTH),
        labels=rs.denoise())
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=S,
                             chunk_capacity=CAP, mode="edram",
                             specs=(spec, frame))
    params = M.init_params(heads.head_param_defs(spec["logits"], cfg),
                           torch.Generator().manual_seed(11), "cpu")
    heads.register_head_params(HEADS_KEY, params)
    engine = eng.TimeSurfaceEngine(cfg, device=dev)
    sessions = [engine.attach() for _ in range(S)]
    bursts = [[(sessions[k], words[k % N_SCENES][b]) for k in range(S)]
              for b in range(2 * DEADLINES)]

    torch.cuda.synchronize()
    _lib.reset_launches()
    step_ms, finite = [], True
    for d in range(DEADLINES):
        t_now = (d + 1) * DEADLINE_S
        for half in range(2):
            t0 = time.perf_counter()
            out = engine.serve_step(bursts[2 * d + half], spec, t_now)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(torch.isfinite(out["logits"]).all())
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    t_end = DEADLINES * DEADLINE_S
    steady = step_ms[2:]
    log(f"heads on {card}: {S} sensors x {P}x{H}x{W}, FRAME + fast surface "
        f"+ Classify({HEADS_CLASSES} classes, width {HEADS_WIDTH}, "
        f"{2 * P} input channels) + Denoise, {DEADLINES} deadlines x 2 "
        f"bursts: serve_step p50 {np.percentile(steady, 50):.3f} ms, p99 "
        f"{np.percentile(steady, 99):.3f} ms over deadlines 2..{DEADLINES}; "
        f"first deadline {step_ms[0]:.3f} + {step_ms[1]:.3f} ms")
    log(f"heads: every serve_step, ms: {[round(x, 3) for x in step_ms]}")
    log(f"heads: kernel launches on the path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the heads path ({n})")
    check(finite, f"every logit finite at every step "
          f"({tuple(out['logits'].shape)})")

    single = engine.read(spec, t_end)
    shared = engine.read_many([spec, frame], t_end)
    check(all(same(single[n], shared[spec][n]) for n in spec.names)
          and all(same(single[n], shared[frame][n]) for n in frame.names),
          "read == read_many([heads spec, FRAME]) bitwise, every product")
    check(torch.equal(single["labels"],
                      single["stcf"] >= cfg.stcf_threshold),
          "labels == stcf >= stcf_threshold, bitwise")
    k = HEADS_CHECK_SLOTS
    t0 = time.perf_counter()
    want = cnn.cnn_apply(params, ts_stack_frontend(
        [single["surface"][:k].cpu(), single["fast"][:k].cpu()]))
    cpu_s = time.perf_counter() - t0
    got = single["logits"][:k].cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    check(bool(torch.allclose(got, want, rtol=HEADS_TOL,
                              atol=HEADS_TOL * scale)),
          f"card logits of {k} slots == CPU port cnn_apply on the card's "
          f"surfaces within rtol = {HEADS_TOL}, atol = {HEADS_TOL} x max(1, "
          f"max|CPU|) (max |d| {err:.3e} of max |logit| "
          f"{float(want.abs().max()):.3e}; CPU {cpu_s * 1e3:.1f} ms)")
    _, hp = engine._resolved(spec)
    stack = ts_stack_frontend([single["surface"], single["fast"]])
    classify_ms = timer(lambda _: cnn.cnn_apply(hp["logits"], stack), 10)
    log(f"heads: Classify head alone (ts_stack_frontend + cnn_apply on "
        f"{S} slots of {H}x{W}x{2 * P}) {classify_ms:.4f} ms (CUDA events, "
        f"median of 10, L2 flushed)")

    q_spec = rs.ReadoutSpec(q=rs.ts_quantized(n_bits=16, tick=1e-3))
    q = engine.read(q_spec, t_end)["q"]
    q_ref = ref.ts_wrapped_read_ref(
        ops.ts_quantize_sae(engine.state.surfaces.sae, 16, 1e-3), t_end,
        cfg.tau, 16, 1e-3)
    q_ulp = int(ref.ulp_distance(q, q_ref).max())
    check(q_ulp <= 2, f"TsQuantized(16 bits, 1 ms) read within 2 ULP of "
          f"ts_wrapped_read_ref on the card ({q_ulp})")
    profile_line("heads profile, one serve_step (the first burst again)",
                 profiled(lambda: engine.serve_step(bursts[0], spec, t_end)),
                 np.percentile(steady, 50))
    heads.clear_registry()
    del engine, single, shared, stack

    # labeled ingest: one 10 ms push of LABEL_SENSORS sensors
    lab_cfg = eng.TSEngineConfig(h=H, w=W, polarities=P,
                                 n_slots=LABEL_SENSORS, chunk_capacity=CAP,
                                 mode="edram")
    payloads = [np.concatenate(words[k % N_SCENES][0:2])
                for k in range(LABEL_SENSORS)]
    results = {}
    for where in (dev, "cpu"):
        e = eng.TimeSurfaceEngine(lab_cfg, device=where)
        cams = [e.attach() for _ in payloads]
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        labeled = [c.push_labeled(w) for c, w in zip(cams, payloads)]
        torch.cuda.synchronize()
        results[str(where)] = (labeled, time.perf_counter() - t0,
                               dict(_lib.LAUNCHES), e)
    card_lab, card_s, lab_launches, card_eng = results[str(dev)]
    cpu_lab, cpu_s, _, cpu_eng = results["cpu"]
    n_ev = sum(len(w) for w in payloads)
    excepted, mismatched = 0, 0
    for (gs, gl), (cs, cl), w in zip(card_lab, cpu_lab, payloads):
        st = aer.unpack(w, H, W)
        ev = pipeline.to_event_batch(st, st.n + (-st.n) % CAP, device="cpu")
        band = label_band(ts.empty_sae(H, W, P, "cpu"), ev, lab_cfg,
                          stcf_mod, edram, ref, ts)
        excepted += int(band.sum())
        diff = (gs.cpu() != cs) | (gl.cpu() != cl)
        mismatched += int((diff & ~band).sum())
    check(mismatched == 0,
          f"push_labeled card == CPU port on {n_ev} events of "
          f"{LABEL_SENSORS} sensors, away from the comparator band "
          f"({excepted} events excepted: a compared cell within 2 ULP of "
          f"V_tw; {mismatched} mismatched outside it)")
    check(same(card_eng.state.surfaces.sae, cpu_eng.state.surfaces.sae),
          "SAE after push_labeled, card == CPU port, bitwise")
    log(f"labels on {card}: push_labeled of {n_ev} events ({LABEL_SENSORS} "
        f"sensors x 10 ms) {card_s * 1e3:.3f} ms -> {n_ev / card_s:.1f} "
        f"events/s (CPU port {cpu_s * 1e3:.1f} ms); launches {lab_launches}")
    e = eng.TimeSurfaceEngine(lab_cfg, device=dev)
    cam = e.attach()
    profile_line("labels profile, push_labeled of sensor 0 (10 ms, "
                 f"{len(payloads[0])} events)",
                 profiled(lambda: cam.push_labeled(payloads[0])))
    del e, cam
    st0 = aer.unpack(payloads[0], H, W)
    ev0 = pipeline.to_event_batch(st0, st0.n + (-st0.n) % CAP, device=dev)
    off, off_sig = stcf_mod.stcf_chunked(
        ev0, H, W, lab_cfg.stcf_config(), chunk=CAP, mode="edram",
        params=lab_cfg.decay_params(), v_tw=lab_cfg.v_tw())
    check(torch.equal(card_lab[0][0], off[:st0.n])
          and torch.equal(card_lab[0][1], off_sig[:st0.n]),
          f"push_labeled == offline stcf_chunked(chunk={CAP}) on the card, "
          f"bitwise ({st0.n} events of sensor 0)")
    truth = datasets.dnd21_like("driving", H, W, DEADLINES * DEADLINE_S,
                                seed=0).window(0.0, DEADLINE_S)
    check(truth.n == st0.n, f"scene 0's ground truth covers its push "
          f"({truth.n} == {st0.n} events)")
    labels = torch.from_numpy(truth.is_signal)
    valid = torch.ones(st0.n, dtype=torch.bool)
    _, _, auc_card = stcf_mod.roc_curve(card_lab[0][0], labels.to(dev),
                                        valid.to(dev))
    _, _, auc_cpu = stcf_mod.roc_curve(cpu_lab[0][0], labels, valid)
    check(abs(float(auc_card) - float(auc_cpu)) <= 1e-6,
          f"roc_curve AUC card {float(auc_card):.7f} == CPU port "
          f"{float(auc_cpu):.7f} within 1e-6 (driving scene 0, 10 ms)")
    return dict(launches=launches, step_ms=step_ms, classify_ms=classify_ms,
                label_events_per_s=n_ev / card_s, auc=float(auc_card))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prev", type=Path, default=None,
                    help="root of another checkout (e.g. the parent "
                    "commit's tree): time its stcf_support and "
                    "chunk_scatter in turns with this tree's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch sources are not beside "
              f"{Path(__file__).name}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import time_surface as ts
    from repro_torch.events import aer, datasets, pipeline
    from repro_torch.kernels import _lib, ops
    from repro_torch.serve import spec as rs
    from repro_torch.serve import ts_engine as eng

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card}; torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    _, info = _lib.library()
    log(f"build: {info.seconds:.2f} s compile+link, "
        f"{time.perf_counter() - t0:.2f} s to load -> {info.path}")
    for line in info.ptxas.splitlines():
        if "Used" in line or "Compiling entry" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    t0 = time.perf_counter()
    words = make_scenes(datasets, aer)
    log(f"data: {N_SCENES} scenes x {2 * DEADLINES} bursts, "
        f"{sum(len(w) for s in words for w in s)} events, "
        f"{time.perf_counter() - t0:.2f} s")
    mods = (_lib, ops, ts, aer, pipeline, rs, eng)
    phase_s = {}
    t0 = time.perf_counter()
    run = run_engine(dev, mods, words, card)
    prev = None if args.prev is None else build_prev(args.prev.resolve())
    rows = kernel_phase(dev, mods, words, run, prev)
    torch.cuda.synchronize()
    phase_s["time surface"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lm = run_lm(dev, card)
    phase_s["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows += decay_scan_phase(dev, lm)
    torch.cuda.synchronize()
    phase_s["decay_scan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hd = run_heads(dev, mods, words, card, Timer(dev))
    torch.cuda.synchronize()
    phase_s["heads and labels"] = time.perf_counter() - t0
    log(f"phases, s: { {k: round(v, 2) for k, v in phase_s.items()} }")

    launches = {**run["launches"], "decay_scan": lm["launches"]["decay_scan"]}
    kernels = []
    for row in rows:
        name = row.pop("name")
        kernels.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name],
                            launches=launches[name],
                            heads_path_launches=hd["launches"].get(name, 0),
                            kernel_ms=row["ms"], **row))
    log(json.dumps({"kernels": kernels}))
    if FAILURES:
        log(f"chip_smoke: {len(FAILURES)} check(s) failed:")
        for f in FAILURES:
            log(f"  {f}")
        return 1
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
