#!/usr/bin/env python3
"""Drive the repro_torch serving paths on one NVIDIA card and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``--prev DIR`` names another checkout (e.g. the parent commit's tree,
unpacked with ``git archive``): its ``ts_decay``, ``stcf_support`` and
``chunk_scatter`` sources are built into a library of their own, checked
against this tree's and timed in turns with them (old, new, new, old) in
the kernel phase.

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
and then, in order (phases 1-2 the time-surface path, 3-4 the LM path,
5 the vision heads and labeled ingest on the time-surface path, 6 the
analog-fidelity reads, the streaming runtime and the ``sweep`` CLI, 7 the
elastic slot pool and live migration, 8 the slot pool over several
shards, 9 the slot pool over several cards where more than one is
visible; phase 8 (a) and phase 9's loops run straight after phase 2,
while phase 1's products are held to compare against):

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
   PyTorch version on the card (decay values and masks bitwise, counts
   exact away from the comparator threshold, scatter bitwise), and timed
   with CUDA events (median over launches, L2 flushed before each) beside
   its plain version, a one-call PyTorch yardstick where one exists (TF32
   off), and the least time the card could take (bytes over 3.35 TB/s,
   operations over 67 TFLOP/s float32, the larger).  Besides:
   ``ts_decay`` with per-cell (H, W) parameter planes bitwise at the
   pool's shape; the division gate (``decay.cuh``'s corrected-reciprocal
   quotient against ``__fdiv_rn``: 0 mismatches over all 2^32 dividends
   of each of 9 taus and 2^32 random triples); ``chunk_scatter`` bitwise on duplicate-heavy traffic (90 % of the
   events on 8 cells, rows of 5,000 slots, out-of-range ids) at P = 2
   and at P = 1, its time without the L2 flush and without the dirty
   marks and counter plane, and the atomics per event it issues.
3. **LM** -- the Mamba-2 token-serving path: ``ServeEngine`` on
   mamba2-2.7b at full width and depth (d_model 2560, 80 SSD heads x 64,
   state 128, vocab 50280 padded to 50432, 64 layers, float32 master
   weights drawn on the card from ``PRNGKey(0)``, bf16 activations)
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
   width=32)`` on weights drawn on the CPU from ``PRNGKey(11)`` and
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
6. **Analog fidelity and the stream** -- the engine phase's pool after one
   10 ms push of all 64 sensors, read with the sweep's spec (analog
   surface, analog ``Stcf``, ``Denoise``, ``Classify`` of 4 classes at
   width 16) at ``analog_3d`` and ``analog_2d``.  Checks: sigma = 0 ==
   the digital read bitwise, every product; a repeated read at the same
   (step, generations) bitwise; a new step draws other noise; the first
   8 sensors against a CPU engine fed the same words (surfaces within 8
   ULP, STCF counts and labels equal outside the comparator band, logits
   within 1e-4 x max(1, max|CPU|)); ``ts_decay`` on the virtual SAE
   within 2 ULP and the mask-form ``stcf_support`` on the analog mask
   bitwise against their plain versions, and ``chunk_scatter`` on one
   ring-staged push bitwise.  Times ``cell_eps``, the analog and digital
   reads (CUDA events) and the ring against the host-staged push.  Then
   ``StreamRuntime`` over the pool through ``events.replay``: every third
   sensor in the ``gesture`` tier on the analog_3d sweep spec, the rest
   ``telemetry`` on FRAME, the scene words offered in 2 substeps per 10
   ms deadline for 10 deadlines, ``drop_oldest``, pipelined, ring on;
   counters zeroed just before and read just after.  Checks: the digests
   replay bitwise through the synchronous oracle on the card; the same
   run with the ring off gives the same digests; each tier conserves its
   events; the three kernels launched.  Prints events/s, readout latency
   p50/p99 per tier, modeled energy per event per mode, and one step
   under ``torch.profiler``.  Last, ``python -m repro_torch.launch.serve
   sweep --hw 120x160 --sensors 4 --duration 0.06 --cmem 10,20
   --retention 12,24`` in a subprocess on the card: its three verdicts
   must hold.
7. **Fleet** -- an elastic pool on the card: ``TimeSurfaceEngine`` of
   240x320, 2 polarities, chunks of 2048, eDRAM, ``slot_bucket = n_slots
   = 21`` (the ``--migrate-demo`` rule ``max(2, sensors // 3)`` for 64
   sensors), under ``StreamRuntime`` with ``elastic``, ``shrink_watermark
   = 0.9``, ``shard_budget = 320``, ``shard_barrier_every = 4``,
   ``drop_oldest``, pipelined, ring on, telemetry on FRAME.  It replays
   ``fleet_scene_feeds(240, 320, 0.1, 64, n_moves=4)``: three attach
   waves grow the pool 21 -> 42 -> 63 -> 84, a batch detach of 20
   sensors shrinks it to 63 with compaction, and four sensors migrate
   live (one on the analog, head-bearing gesture tier), over 10
   deadlines of 10 ms; counters zeroed just before and read just after.
   Checks: the digests replay bitwise through the synchronous oracle on
   the card, which derives the logged compaction moves; the log holds
   >= 2 grows, >= 1 shrink with >= 1 move and >= 4 migrates; each tier
   conserves its events; the three kernels launched; cached
   ``serve_step`` == dense read bitwise after a grow, a migrate and a
   shrink; the same feeds at 60x80 on the card and on a CPU engine give
   equal action logs, counters, tier counters and final SAE bits and
   counts.  Times one grow (21 slots), one migrate and one shrink with
   compaction (CUDA events and the host clock).  Prints events/s and
   p50/p99 per tier beside phase 6's.  Last, ``python -m
   repro_torch.launch.serve stream --migrate-demo --hw 48x64 --duration
   0.06 --deadline 0.005`` in a subprocess on the card: its oracle gate
   must pass.
8. **Shards** -- the slot pool over several shards, every shard on the
   one card with tensors of its own (``make_host_mesh(n, devices=[card])``,
   the code a multi-card host runs).  (a) Phase 1's FRAME loop (its
   configuration, words and bursts) on engines of 1, 2 and 4 shards, in
   turns (1, 2, 4, 4, 2, 1), counters zeroed just before each loop and
   read just after, each
   kernel's launches credited to the shard whose SAE it reads or writes.
   Checks: every step's products == phase 1's unsharded products,
   bitwise; incremental == dense read at every deadline; the events
   ingested equal; every kernel launched on every shard.  Prints each
   loop's events/s and ``serve_step`` p50/p99 beside phase 1's, the
   host time of ``route``, the host time of a steady step by part
   (``HostSpans``: chunking, ``route``, uploads and scatter, the
   dirty-tile refresh, its ``nonzero`` sync, the other reads, the gather
   onto shard 0) and, for the first loop of each count, two more steps
   under ``torch.profiler``.  (b) Phase 7's fleet feeds on a 2-shard engine
   (21 slots pad to 22) under the same ``StreamConfig`` (``shard_budget
   = 320``, ``shard_barrier_every = 4``).  Checks: the digests replay
   bitwise through the oracle on a 2-shard factory; a migration crosses
   shards; barrier steps fall every 4th deadline; each tier conserves
   its events; every kernel launched on both shards.  Prints the three
   steps of longest readout latency with the actions logged around
   them.  (c) One migration
   from shard 0 to shard 3 of a 4-shard QVGA pool of 8 slots: every leaf
   bitwise the unsharded engine's after the same move, and the next
   ``serve_step`` too; device and host ms of the move beside the same
   move in one unsharded pool.  (d) ``python -m repro_torch.launch.serve
   sensors --mesh 2 --hw 48x64 --duration 0.05 --sensors 4`` in a
   subprocess: the placement printed and the fused surface bitwise the
   dense read.
9. **Cards** -- only where more than one card is visible (one card:
   skipped with a line).  One small copy between every ordered pair of
   cards, one untimed loop on one shard per card, then phase 8 (a)'s
   loop with N shards on card 0, N shards on the N cards and 2 shards on
   2 cards, in turns, each checked as in phase 8 (a); one migration
   from card 0's shard to the last card's, checked as in phase 8 (c);
   phase 8 (b)'s fleet on one shard per card, twice (the second on
   cards the first warmed), checked as there.

Output: progress lines, one JSON line of the kernels, the card's
``nvidia-smi`` name and power limit, and last the line
``{"ok": true, "device": {...}}``.  Any failed check, build error or
launch error exits nonzero without that line.  Without a CUDA device, or
without the repository's sources beside it, it exits 2.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import importlib
import json
import os
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

SWEEP_CLASSES = 4                 # the sweep CLI's default --classes
ANALOG_CHECK_SLOTS = 8
ANALOG_ULP = 8    # card vs CPU port analog reads (the CPU tests' analog_2d band)
STREAM_DEADLINES = DEADLINES
STREAM_SUBSTEPS = 2
SWEEP_ARGV = ("--hw", "120x160", "--sensors", "4", "--duration", "0.06",
              "--cmem", "10,20", "--retention", "12,24")
SWEEP_TIMEOUT_S = 400

FLEET_SENSORS = 64
FLEET_BUCKET = max(2, FLEET_SENSORS // 3)   # the --migrate-demo rule: 21
FLEET_MOVES = 4
FLEET_SHARD_BUDGET = 320
FLEET_BARRIER_EVERY = 4
FLEET_SMALL_HW = (60, 80)                   # card vs CPU engine
FLEET_CLI_ARGV = ("--migrate-demo", "--hw", "48x64", "--duration", "0.06",
                  "--deadline", "0.005")

SHARD_COUNTS = (1, 2, 4)      # shards of phase 8's FRAME loop, one card
SHARD_LOOP_CHECKED = 2        # the loop whose launches the JSON line reports
SHARD_MIGRATE_SHARDS, SHARD_MIGRATE_SLOTS = 4, 8
SHARD_CLI_ARGV = ("sensors", "--mesh", "2", "--hw", "48x64",
                  "--duration", "0.05", "--sensors", "4")

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
    """The ``ts_decay``, ``stcf_support`` and ``chunk_scatter`` kernels of
    another checkout (``--prev``, e.g. the parent commit's tree; its
    ``ts_decay.cu`` with the first version's plane entry), compiled with
    this tree's flags into a library of their own, each source with the
    headers beside it.  Returns a function that calls one of their C
    entry points on the current stream."""
    from repro_torch.kernels import _lib

    csrc = prev_root / "src" / "repro_torch" / "kernels" / "csrc"
    out = ROOT / "build" / "prev_kernels"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    nvcc = _lib._nvcc()
    objs, procs = [], []
    for src in ("ts_decay.cu", "stcf.cu", "ts_fused.cu"):
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
    for name in ("ts_decay_uniform", "stcf_support_mask",
                 "stcf_support_fused", "chunk_scatter"):
        getattr(lib, name).argtypes = _lib._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    # the first version's plane entry: (n, plane), no launch shape
    lib.ts_decay_planes.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_float]
        + [ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_void_p])
    lib.ts_decay_planes.restype = ctypes.c_int
    log(f"build: the previous ts_decay, stcf_support and chunk_scatter from "
        f"{csrc} -> {lib_path}")

    def call(name, *args):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"previous {name}: CUDA error {err}")
    return call


def prev_decay(call, sae, t_now, params, v_tw=None):
    """The previous ``ts_decay`` on ``sae``: ``v``, or ``(v, mask)``."""
    out = torch.empty_like(sae)
    mask = (None if v_tw is None else
            torch.empty(sae.shape, dtype=torch.bool, device=sae.device))
    mptr = None if mask is None else mask.data_ptr()
    thr = 0.0 if v_tw is None else float(v_tw)
    if params.varied:
        call("ts_decay_planes", sae.data_ptr(), out.data_ptr(), mptr,
             sae.numel(), params.tau1.numel(), float(t_now),
             *(x.data_ptr() for x in params), thr)
    else:
        call("ts_decay_uniform", sae.data_ptr(), out.data_ptr(), mptr,
             sae.numel(), float(t_now), *(float(x) for x in params), thr)
    return out if mask is None else (out, mask)


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
    step_outs = []   # every step's products, for phase 8's shards
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
            step_outs.append(out)
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
                step_ms=step_ms, step_outs=step_outs, frame=frame)


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


def division_gate_phase(dev) -> dict:
    """decay.cuh's corrected-reciprocal quotient against ``__fdiv_rn`` on
    the card: every float32 dividend of each of ``gate_taus()``, then
    2^32 random (dividend, tau1, tau2) triples; 0 mismatches in the decay
    value or the quotient."""
    from repro_torch.kernels.ts_decay import division_gate, gate_taus

    t0 = time.perf_counter()
    found = {f"{tau!r}": division_gate(dev, tau) for tau in gate_taus()}
    found["random"] = division_gate(dev, seed=17)
    secs = time.perf_counter() - t0
    bad = {k: v for k, v in found.items() if v != (0, 0)}
    check(not bad, f"division gate: 0 decay values and 0 quotients differ "
          f"from __fdiv_rn over 2^32 dividends x {len(found) - 1} taus and "
          f"2^32 random triples ({secs:.2f} s; mismatches {bad})")
    return dict(cells=(len(found)) << 32, seconds=secs, mismatches=bad)


def kernel_phase(dev, mods, words, run, prev=None):
    """Phase 2: each kernel vs its plain version, and its times; with
    ``prev`` (``build_prev``), the previous ``ts_decay`` (all three
    forms), ``stcf_support`` and ``chunk_scatter`` timed in turns with
    the current ones."""
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

    # -- ts_decay: the Surface product's read of the whole pool, then the
    # per-cell-plane entry at the pool's shape (tau1 and tau2 varied per
    # cell by a seeded 5 % spread); each bitwise its plain version
    v = ts_decay_cuda(sae, t_now, params)
    vr, mr = ref.ts_decay_ref(sae, t_now, params, v_tw)
    _, m = ts_decay_cuda(sae, t_now, params, v_tw)
    ulp = int(ref.ulp_distance(v, vr).max())
    near = ref.ulp_distance(vr, torch.full_like(vr, v_tw)) <= 4
    check(same(v, vr), f"ts_decay bitwise its plain version (max {ulp} "
          "ULP)")
    check(torch.equal(m, mr), f"ts_decay mask == its plain version's on "
          f"every cell ({int(near.sum())} cells within 4 ULP of v_tw)")
    g = torch.Generator(device=dev).manual_seed(4)
    eps = 1.0 + 0.05 * torch.randn((2, H, W), generator=g, device=dev)
    full = lambda x: torch.full((H, W), float(x), device=dev)
    planes = edram.DecayParams(full(params.a1), float(params.tau1) / eps[0],
                               full(params.a2), float(params.tau2) / eps[1],
                               full(params.b))
    vp = ts_decay_cuda(sae, t_now, planes)
    ulp_p = int(ref.ulp_distance(vp, ref.ts_decay_ref(sae, t_now, planes))
                .max())
    check(ulp_p == 0, f"ts_decay with (H, W) parameter planes bitwise its "
          f"plain version at {tuple(sae.shape)} (max {ulp_p} ULP)")
    old = dict(uniform=None, mask=None, planes=None)
    if prev is not None:
        pv, pm = prev_decay(prev, sae, t_now, params, v_tw)
        check(same(prev_decay(prev, sae, t_now, params), v) and same(pv, v)
              and torch.equal(pm, m)
              and same(prev_decay(prev, sae, t_now, planes), vp),
              "the previous ts_decay gives the same values and mask, "
              "uniform and planes, bitwise")
        old = dict(uniform=lambda _: prev_decay(prev, sae, t_now, params),
                   mask=lambda _: prev_decay(prev, sae, t_now, params, v_tw),
                   planes=lambda _: prev_decay(prev, sae, t_now, planes))
    ms, prev_ms = in_turns(timer, lambda _: ts_decay_cuda(
        sae, t_now, params), old["uniform"], 30, "ts_decay uniform")
    ms_mask, prev_mask = in_turns(timer, lambda _: ts_decay_cuda(
        sae, t_now, params, v_tw), old["mask"], 30, "ts_decay with mask")
    ms_planes, prev_planes = in_turns(timer, lambda _: ts_decay_cuda(
        sae, t_now, planes), old["planes"], 30, "ts_decay planes")
    plain = timer(lambda _: ref.ts_decay_ref(sae, t_now, params), 10)
    b_ms, b_by = bound_ms(8 * cells, 12 * cells)
    rnd = lambda x: x if x is None else round(x, 4)
    log(f"ts_decay: {ms:.4f} ms (previous kernel {rnd(prev_ms)} ms), plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms; with mask {ms_mask:.4f} ms "
        f"(previous {rnd(prev_mask)} ms, bound "
        f"{bound_ms(9 * cells, 13 * cells)[0]:.4f} ms); with parameter "
        f"planes {ms_planes:.4f} ms (previous {rnd(prev_planes)} ms, bound "
        f"{bound_ms(8 * cells + 20 * H * W, 12 * cells)[0]:.4f} ms)")
    gate = division_gate_phase(dev)
    rows.append(dict(name="ts_decay", max_abs_err=float((v - vr).abs().max()),
                     max_ulp=ulp, near_threshold_cells=int(near.sum()),
                     ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                     library_ms=None, prev_kernel_ms=prev_ms,
                     ms_with_mask=ms_mask, mask_prev_ms=prev_mask,
                     planes_ms=ms_planes, planes_prev_ms=prev_planes,
                     planes_max_ulp=ulp_p, division_gate=gate))

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
    (_, sids, fields), = engine._collect(
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
    from repro_torch.core import prng
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
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(T.param_defs(cfg), prng.PRNGKey(0), dev)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in M.flatten(params).values())
    log(f"lm on {card}: {n_params} float32 parameters "
        f"({n_params * 4 / 1e9:.2f} GB) drawn on the card from PRNGKey(0) "
        f"(the reference's key; prng threefry, one split per leaf) in "
        f"{time.perf_counter() - t0:.2f} s; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
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
    lm_checks(dev, cfg, M, T, prng)
    return dict(launches=launches, b=LM_REQUESTS,
                nc=-(-s_max // cfg.ssm_chunk), c=h * p * n,
                prefill_ms=pf_s * 1e3)


def lm_checks(dev, cfg, M, T, prng):
    """The full-width model at CHECK_LAYERS layers in float32: the card
    against the CPU port on the same weights, and, on the card, the
    chunked prefill against prefill of all but the last token followed by
    one recurrent decode step."""
    cfg = dataclasses.replace(cfg, n_layers=CHECK_LAYERS, dtype="float32")
    card = M.init_params(T.param_defs(cfg), prng.PRNGKey(1), dev)
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
    from repro_torch.core import edram, prng
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
                           prng.PRNGKey(11), "cpu")
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


def gesture_sensor(k: int) -> bool:
    """The reference's ``tiered=True`` split: every third sensor (the
    glyph feeds of ``mixed_scene_feeds``) is the gesture tier."""
    return k % 3 == 2


def analog_phase(dev, mods, words, card, timer, rows):
    """Phase 6, part 1: analog reads of the sweep's spec over the full
    pool, and the three kernels at this path's shapes against their plain
    versions (results added to ``rows``)."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.kernels import ref
    from repro_torch.kernels.stcf import stcf_support_cuda
    from repro_torch.kernels.ts_decay import ts_decay_cuda
    from repro_torch.kernels.ts_fused import chunk_scatter_cuda
    from repro_torch.launch.serve import _sweep_spec
    from repro_torch.serve import fidelity as fm
    from repro_torch.serve.ts_engine import IngestRing

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    specs = {name: _sweep_spec(fid, SWEEP_CLASSES) for name, fid in (
        ("analog_3d", fm.analog_3d()), ("analog_2d", fm.analog_2d()),
        ("sigma0", fm.analog_3d(sigma=0.0)), ("digital", None))}
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=S,
                             chunk_capacity=CAP, mode="edram",
                             specs=(specs["analog_2d"],))
    engine = eng.TimeSurfaceEngine(cfg, device=dev)
    for _ in range(S):
        engine.attach()
    payload = [np.concatenate(words[k % N_SCENES][0:2]) for k in range(S)]
    engine.push(list(enumerate(payload)))
    t_read, step = DEADLINE_S, 1
    reads = {n: engine.read(sp, t_read, noise_step=step)
             for n, sp in specs.items()}
    torch.cuda.synchronize()
    check(all(same(reads["sigma0"][n], reads["digital"][n])
              for n in specs["digital"].names),
          f"sigma = 0 analog_3d read == digital read, bitwise, every product "
          f"of the sweep spec at {S} x {P}x{H}x{W}")
    again = engine.read(specs["analog_3d"], t_read, noise_step=step)
    check(all(same(again[n], reads["analog_3d"][n])
              for n in specs["analog_3d"].names),
          "analog_3d read repeated at the same (step, generations), bitwise")
    other = engine.read(specs["analog_3d"], t_read, noise_step=step + 1)
    check(not same(other["surface"], reads["analog_3d"]["surface"]),
          "a new noise step draws other noise")

    # a sub-pool of the first sensors on the CPU port, fed the same words
    k = ANALOG_CHECK_SLOTS
    cpu = eng.TimeSurfaceEngine(dataclasses.replace(cfg, n_slots=k), "cpu")
    for _ in range(k):
        cpu.attach()
    cpu.push(list(enumerate(payload[:k])))
    v_tw = torch.full((), cfg.v_tw())
    agreement = {}
    for name in ("analog_3d", "analog_2d"):
        c = cpu.read(specs[name], t_read, noise_step=step)
        g = {n: v[:k].cpu() for n, v in reads[name].items()}
        ulp = int(ref.ulp_distance(g["surface"], c["surface"]).max())
        near = ref.ulp_distance(c["surface"],
                                v_tw.expand_as(c["surface"])) <= ANALOG_ULP
        near_p = ref.stcf_support_ref(near, RADIUS, include_self=True) > 0
        moved = (g["stcf"] != c["stcf"]) | (g["labels"] != c["labels"])
        scale = max(1.0, float(c["logits"].abs().max()))
        lg = float((g["logits"] - c["logits"]).abs().max())
        agreement[name] = dict(max_ulp=ulp, band_pixels=int(near_p.sum()),
                               moved_in_band=int((moved & near_p).sum()),
                               moved_outside=int((moved & ~near_p).sum()),
                               logits_max_abs=lg)
        check(ulp <= ANALOG_ULP and not bool((moved & ~near_p).any())
              and lg <= HEADS_TOL * scale,
              f"{name} card == CPU port on {k} sensors: surface within "
              f"{ANALOG_ULP} ULP ({ulp}), STCF counts and labels equal "
              f"outside the comparator band ({int(near_p.sum())} pixels see "
              f"a cell within {ANALOG_ULP} ULP of V_tw; "
              f"{int((moved & near_p).sum())} moved inside it), logits "
              f"within {HEADS_TOL} x max(1, max|CPU|) ({lg:.3e})")

    # times: the draw, the analog read given the draw, the digital read,
    # and the whole sweep-spec reads
    sae, params = engine.state.surfaces.sae, cfg.decay_params()
    fid = fm.analog_3d()
    eps = fm.cell_eps(fid, step, engine.state.generation, sae.shape[1:])
    eps_ms = timer(lambda _: fm.cell_eps(fid, step, engine.state.generation,
                                         sae.shape[1:]), 5)
    analog_ms = timer(lambda _: ops.ts_analog_read(sae, t_read, params,
                                                   eps=eps), 20)
    digital_ms = timer(lambda _: ops.ts_decay(sae, t_read, params), 20)
    spec_ms = {n: timer(lambda _, sp=specs[n]: engine.read(
        sp, t_read, noise_step=step), 5) for n in ("analog_3d", "digital")}
    log(f"analog on {card}: cell_eps ({S} x {P}x{H}x{W} normals) "
        f"{eps_ms:.4f} ms; ts_analog_read given eps {analog_ms:.4f} ms; "
        f"digital ts_decay {digital_ms:.4f} ms; whole sweep-spec read "
        f"analog_3d {spec_ms['analog_3d']:.4f} ms, digital "
        f"{spec_ms['digital']:.4f} ms (CUDA events, median, L2 flushed)")

    # the kernels at this path's shapes against their plain versions
    dt = t_read - sae
    virtual = torch.where(torch.isfinite(sae), -(dt * eps),
                          torch.full_like(sae, ts.NEVER))
    vv = ts_decay_cuda(virtual, 0.0, params)
    v_ulp = int(ref.ulp_distance(vv, ref.ts_decay_ref(virtual, 0.0,
                                                      params)).max())
    check(v_ulp <= 2, f"ts_decay on the virtual SAE (ages dt * eps) within "
          f"2 ULP of its plain version ({v_ulp})")
    m = vv > cfg.v_tw()
    sm = stcf_support_cuda(m, RADIUS, False)
    check(torch.equal(sm, ref.stcf_support_ref(m, RADIUS)),
          "stcf_support mask form on the analog mask == its plain version")
    virtual_ms = timer(lambda _: ts_decay_cuda(virtual, 0.0, params), 30)
    mask_ms = timer(lambda _: stcf_support_cuda(m, RADIUS, False), 30)
    ring = IngestRing(CAP, dev)
    parts = []
    for k2 in range(S):
        st0 = aer.unpack(words[k2 % N_SCENES][2], H, W)
        parts += [(k2, tuple(f[i:i + CAP] for f in (st0.x, st0.y, st0.t,
                                                     st0.p)))
                  for i in range(0, st0.n, CAP)]
    buf = ring.acquire(len(parts))
    for i, (slot, part) in enumerate(parts):
        IngestRing.fill_row(buf, i, slot, part)
    sids, ev = ring.upload(buf)
    base = engine.state
    outs = []
    for fn in (chunk_scatter_cuda, ref.chunk_scatter_ref):
        st1 = (base.surfaces.sae.clone(), base.cache.dirty.clone(),
               base.counts.clone(), base.surfaces.t_last.clone(),
               base.surfaces.n_events.clone())
        fn(st1[0], sids, ev, st1[1], cfg.block, st1[2], st1[3], st1[4])
        outs.append(st1)
    check(all(same(a, b) for a, b in zip(*outs)),
          f"chunk_scatter on one ring-staged push ({len(parts)} rows, "
          f"{int(ev.valid.sum())} events) == its plain version, bitwise")
    log(f"analog kernels: ts_decay on the virtual SAE {virtual_ms:.4f} ms, "
        f"stcf_support on the analog mask {mask_ms:.4f} ms")
    for row in rows:
        if row["name"] == "ts_decay":
            row.update(virtual_sae_ms=virtual_ms, virtual_sae_max_ulp=v_ulp)
        elif row["name"] == "stcf_support":
            row.update(analog_mask_ms=mask_ms)

    # ring against host push of the same parts, in turns
    def push_ms(staged):
        e = eng.TimeSurfaceEngine(cfg, device=dev)
        for _ in range(S):
            e.attach()
        streams = [(slot, aer.unpack(words[slot % N_SCENES][2], H, W))
                   for slot in range(S)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if staged:
            e.push_staged(parts)
        else:
            e.push(streams)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    turns = [push_ms(staged) for staged in (True, False) * 2
             for _ in range(2)]
    ring_ms = float(np.median(turns[0::2]))
    host_ms = float(np.median(turns[1::2]))
    log(f"ingest on {card}: one 5 ms push of {S} sensors, ring (pinned, "
        f"staged parts) {ring_ms:.3f} ms vs host-staged push (EventStreams) "
        f"{host_ms:.3f} ms, medians of 4 in turns: "
        f"{[round(x, 3) for x in turns]}")
    return dict(cell_eps_ms=eps_ms, analog_ms=analog_ms,
                digital_ms=digital_ms, spec_ms=spec_ms, ring_ms=ring_ms,
                host_ms=host_ms, agreement=agreement)


def stream_phase(dev, mods, words, card):
    """Phase 6, part 2: the streaming runtime over the full pool.  Returns
    the stream path's kernel launches and what it measured."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.launch.serve import _sweep_spec
    from repro_torch.serve import fidelity as fm
    from repro_torch.serve import stream as st

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    gesture = _sweep_spec(fm.analog_3d(), SWEEP_CLASSES)
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=S,
                             chunk_capacity=CAP, mode="edram",
                             specs=(frame, gesture))
    tiers = {True: dataclasses.replace(st.GESTURE_TIER, spec=gesture),
             False: st.TELEMETRY_TIER}
    streams = [aer.unpack(np.concatenate(words[j][:2 * STREAM_DEADLINES]),
                          H, W) for j in range(N_SCENES)]
    feeds = [rp.SensorFeed(stream=streams[k % N_SCENES], name=f"sensor-{k}",
                           qos=tiers[gesture_sensor(k)]) for k in range(S)]
    t_end = STREAM_DEADLINES * DEADLINE_S - 1e-6
    scfg = st.StreamConfig(policy="drop_oldest", deadline_s=DEADLINE_S,
                           pipeline=True, device_ring=True)

    def make():
        return eng.TimeSurfaceEngine(cfg, device=dev)

    def run(**over):
        return rp.replay(make(), feeds, dataclasses.replace(scfg, **over),
                         frame, arrival_substeps=STREAM_SUBSTEPS, t_end=t_end)

    rp.replay(make(), feeds, scfg, frame, arrival_substeps=STREAM_SUBSTEPS,
              t_end=1.5 * DEADLINE_S)          # first-touch costs
    torch.cuda.synchronize()
    _lib.reset_launches()
    report = run()
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    log(f"stream on {card}: {S} sensors ({sum(map(gesture_sensor, range(S)))}"
        f" gesture on the analog_3d sweep spec, the rest telemetry on "
        f"FRAME), {report.n_steps} deadlines x {DEADLINE_S * 1e3:.0f} ms, "
        f"{STREAM_SUBSTEPS} arrival substeps, drop_oldest, pipelined, ring:")
    for line in report.summary().splitlines():
        log(f"  {line}")
    energy = {}
    for tier, mode in (("gesture", "analog_3d"), ("telemetry", "ideal")):
        row, e = report.tiers[tier], report.tier_energy_uj[tier]
        energy[mode] = e["total_uj"] * 1e3 / max(row["ingested"], 1)
        log(f"stream tier {tier} ({mode}): ingested {row['ingested']}, "
            f"readout latency p50 {row['latency_p50_us'] / 1e3:.3f} ms, p99 "
            f"{row['latency_p99_us'] / 1e3:.3f} ms; modeled energy "
            f"{energy[mode]:.6f} nJ/event")
        check(row["offered"] == row["ingested"] + row["dropped"]
              + row["refused"] + row["discarded"] + row["deferred"],
              f"tier {tier} conserves: offered {row['offered']} == ingested "
              f"+ dropped + refused + discarded + deferred")
    log(f"stream: events/s {report.events_per_sec:.1f}; kernel launches on "
        f"the stream path: {launches}")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the stream path ({n})")
    try:
        n = rp.check_oracle(report, make, frame)
        check(n == report.n_steps, f"stream digests == the synchronous "
              f"oracle's on the card, bitwise, at all {n} deadlines")
    except AssertionError as err:
        check(False, f"stream oracle gate on the card: {err}")
    host = run(device_ring=False)
    check(host.digests == report.digests,
          "the same stream with device_ring=False gives the same digests")

    # one step under the profiler: push (ring) + both specs' reads + the
    # previous step's digest
    rt = st.StreamRuntime(make(), scfg, frame)
    sensors = [rt.connect(f.qos) for f in feeds]

    def offer(d):
        for sen, f in zip(sensors, feeds):
            w = f.stream.window(d * DEADLINE_S, (d + 1) * DEADLINE_S)
            sen.offer((w.x, w.y, w.t, w.p))

    offer(0)
    rt.step(DEADLINE_S)
    offer(1)
    rt.step(2 * DEADLINE_S)
    offer(2)
    prof = profiled(lambda: (rt.step(3 * DEADLINE_S), rt.flush()))
    profile_line("stream profile, one step (ring push, FRAME + analog sweep "
                 "spec, the previous step's digest)", prof)
    return dict(launches=launches, events_per_s=report.events_per_sec,
                tiers={t: {k: report.tiers[t][k] for k in
                           ("ingested", "dropped", "latency_p50_us",
                            "latency_p99_us")} for t in report.tiers},
                energy_nj_per_event=energy,
                idle_share=1 - prof["device_ms"] / prof["wall_ms"])


def log_view(log):
    """A device-neutral view of an action log: QoS classes by tier, step
    records by their schedule, flags and chunk contents."""
    out = []
    for kind, e in log:
        if kind in ("attach", "set_tier"):
            out.append((kind, e[0], e[1].tier))
        elif kind == "shrink":
            out.append((kind, e[0], [tuple(m) for m in e[1]]))
        elif kind == "step":
            out.append((kind, e.t_read, e.n_events, e.n_chunks, e.order,
                        e.deferred, e.overload, e.noise_step, e.barrier,
                        [(slot, [np.asarray(a).tobytes() for a in part])
                         for slot, part in e.chunks]))
        else:
            out.append((kind, e))
    return out


def migrated_tiers(log):
    """The tier of each sensor a ``migrate`` moved, in log order (slots
    followed through attaches, tier changes, detaches and shrinks)."""
    tier_of, moved = {}, []
    for kind, e in log:
        if kind in ("attach", "set_tier"):
            tier_of[e[0]] = e[1].tier
        elif kind == "detach":
            tier_of.pop(e)
        elif kind == "migrate":
            tier_of[e[1]] = tier_of.pop(e[0])
            moved.append(tier_of[e[1]])
        elif kind == "shrink":
            for src, dst in e[1]:
                tier_of[dst] = tier_of.pop(src)
    return moved


def timed_op(fn, devices=()):
    """(result, device ms from CUDA events on the current card, host ms
    ending in a synchronize of it and of every card in ``devices``) of
    one call."""
    for d in (None, *devices):
        torch.cuda.synchronize(d)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    for d in devices:
        torch.cuda.synchronize(d)
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def fleet_moves(dev, mods, words, card, frame):
    """Phase 7, part 1: one grow, one migrate and one shrink with
    compaction of a 21-slot QVGA pool, timed; cached ``serve_step`` ==
    the dense read bitwise after each."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P, n_slots=FLEET_BUCKET,
                             slot_bucket=FLEET_BUCKET, chunk_capacity=CAP,
                             mode="edram", specs=(frame,),
                             max_dirty_tiles=1 << 30)
    engine = eng.TimeSurfaceEngine(cfg, device=dev)
    for _ in range(FLEET_BUCKET):
        engine.attach()
    t_now = DEADLINES * DEADLINE_S
    burst = 0

    def serve(what):
        nonlocal burst
        live = sorted(engine._sessions)
        items = [(s, words[s % N_SCENES][burst % (2 * DEADLINES)])
                 for s in live]
        burst += 1
        got = engine.serve_step(items, frame, t_now)["surface"]
        dense = engine.read(rs.SURFACE_SPEC, t_now)["surface"]
        check(same(got, dense), f"fleet: cached serve_step == dense read "
              f"bitwise after {what} ({len(live)} live of "
              f"{engine.capacity} slots)")

    serve("the first fill")
    cap, g_dev, g_host = timed_op(engine.grow)
    serve(f"a grow to {cap}")
    dst, m_dev, m_host = timed_op(lambda: engine.migrate(5))
    serve(f"a migrate 5 -> {dst}")
    moves, s_dev, s_host = timed_op(lambda: engine.shrink(FLEET_BUCKET))
    check(moves == [(dst, 5)], f"fleet: the shrink compacts {moves}")
    serve(f"a shrink to {engine.capacity}")
    ops_ms = {"grow": (g_dev, g_host), "migrate": (m_dev, m_host),
              "shrink": (s_dev, s_host)}
    log(f"fleet moves on {card}: grow {FLEET_BUCKET} -> {cap} slots at "
        f"{P}x{H}x{W} device {g_dev:.4f} ms, host {g_host:.4f} ms; "
        f"migrate 5 -> {dst} device {m_dev:.4f} ms, host {m_host:.4f} ms; "
        f"shrink {cap} -> {engine.capacity} with moves {moves} device "
        f"{s_dev:.4f} ms, host {s_host:.4f} ms")
    return ops_ms


def fleet_cfgs(eng, st, frame, h, w):
    cfg = eng.TSEngineConfig(h=h, w=w, polarities=P, n_slots=FLEET_BUCKET,
                             slot_bucket=FLEET_BUCKET, chunk_capacity=CAP,
                             mode="edram", specs=(frame,))
    scfg = st.StreamConfig(policy="drop_oldest", deadline_s=DEADLINE_S,
                           pipeline=True, device_ring=True, elastic=True,
                           shrink_watermark=0.9,
                           shard_budget=FLEET_SHARD_BUDGET,
                           shard_barrier_every=FLEET_BARRIER_EVERY)
    return cfg, scfg


def fleet_phase(dev, mods, words, card, stream6):
    """Phase 7: the elastic pool and live migration on the card.  Returns
    the fleet path's kernel launches and what it measured."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.serve import stream as st

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    ops_ms = fleet_moves(dev, mods, words, card, frame)
    duration = DEADLINES * DEADLINE_S
    t0 = time.perf_counter()
    feeds = rp.fleet_scene_feeds(H, W, duration, FLEET_SENSORS,
                                 n_moves=FLEET_MOVES)
    log(f"fleet: {FLEET_SENSORS} feeds, {sum(f.stream.n for f in feeds)} "
        f"events, made in {time.perf_counter() - t0:.2f} s")
    cfg, scfg = fleet_cfgs(eng, st, frame, H, W)

    def make():
        return eng.TimeSurfaceEngine(cfg, device=dev)

    rp.replay(make(), feeds, scfg, frame, arrival_substeps=STREAM_SUBSTEPS,
              t_end=1.5 * DEADLINE_S)          # first-touch costs
    torch.cuda.synchronize()
    _lib.reset_launches()
    report = rp.replay(make(), feeds, scfg, frame,
                       arrival_substeps=STREAM_SUBSTEPS)
    launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    fleet_log = [(k, e) for k, e in report.log
                 if k in ("grow", "shrink", "migrate")]
    log(f"fleet on {card}: {FLEET_SENSORS} sensors, pool of {FLEET_BUCKET} "
        f"slots growing by {FLEET_BUCKET}, shard budget "
        f"{FLEET_SHARD_BUDGET}, a barrier every {FLEET_BARRIER_EVERY}, "
        f"{report.n_steps} deadlines x {DEADLINE_S * 1e3:.0f} ms:")
    for line in report.summary().splitlines():
        log(f"  {line}")
    log(f"fleet log: {fleet_log}")
    kinds = [k for k, _ in fleet_log]
    moves = [m for k, e in fleet_log if k == "shrink" for m in e[1]]
    check(kinds.count("grow") >= 2 and kinds.count("shrink") >= 1
          and moves and kinds.count("migrate") >= FLEET_MOVES,
          f"fleet log: {kinds.count('grow')} grows, {kinds.count('shrink')} "
          f"shrinks with {len(moves)} moves, {kinds.count('migrate')} "
          f"migrates (>= 2, >= 1 with >= 1, >= {FLEET_MOVES})")
    moved_tiers = migrated_tiers(report.log)
    check("gesture" in moved_tiers,
          f"fleet: a gesture (analog, head-bearing) slot migrated (tiers "
          f"of the moved sensors: {moved_tiers})")
    for tier, row in sorted(report.tiers.items()):
        check(row["offered"] == row["ingested"] + row["dropped"]
              + row["refused"] + row["discarded"] + row["deferred"],
              f"fleet tier {tier} conserves: offered {row['offered']} == "
              f"ingested + dropped + refused + discarded + deferred "
              f"(migrated {row['migrated']})")
    for k, n in launches.items():
        check(n > 0, f"{k} launched on the fleet path ({n})")
    try:
        n = rp.check_oracle(report, make, frame)
        check(n == report.n_steps, f"fleet digests == the synchronous "
              f"oracle's on the card, bitwise, at all {n} deadlines, its "
              f"shrink deriving the logged moves {moves}")
    except AssertionError as err:
        check(False, f"fleet oracle gate on the card: {err}")
    for tier in sorted(report.tiers):
        row = report.tiers[tier]
        was = stream6["tiers"].get(tier, {})
        log(f"fleet tier {tier}: ingested {row['ingested']}, migrated "
            f"{row['migrated']}, readout latency p50 "
            f"{row['latency_p50_us'] / 1e3:.3f} ms, p99 "
            f"{row['latency_p99_us'] / 1e3:.3f} ms (phase 6, fixed pool of "
            f"{S}: p50 {was.get('latency_p50_us', float('nan')) / 1e3:.3f} "
            f"ms, p99 {was.get('latency_p99_us', float('nan')) / 1e3:.3f} ms)")
    log(f"fleet: events/s {report.events_per_sec:.1f} (phase 6, fixed "
        f"pool: {stream6['events_per_s']:.1f}); kernel launches on the "
        f"fleet path: {launches}")
    fleet_small(dev, mods, frame)
    fleet_cli()
    return feeds, dict(launches=launches, events_per_s=report.events_per_sec,
                tiers={t: {k: report.tiers[t][k] for k in
                           ("ingested", "dropped", "migrated",
                            "latency_p50_us", "latency_p99_us")}
                       for t in report.tiers},
                log=[(k, e) for k, e in fleet_log], moves_ms=ops_ms)


def fleet_small(dev, mods, frame):
    """Phase 7, part 3: the same fleet feeds at 60x80 on the card and on a
    CPU engine: equal action logs, counters, tier counters and final
    integer state (SAE bits, counts)."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.serve import stream as st

    h, w = FLEET_SMALL_HW
    cfg, scfg = fleet_cfgs(eng, st, frame, h, w)
    feeds = rp.fleet_scene_feeds(h, w, DEADLINES * DEADLINE_S, FLEET_SENSORS,
                                 n_moves=FLEET_MOVES)
    runs = []
    for where in (dev, torch.device("cpu")):
        engine = eng.TimeSurfaceEngine(cfg, device=where)
        rep = rp.replay(engine, feeds, scfg, frame,
                        arrival_substeps=STREAM_SUBSTEPS)
        state = engine.state
        runs.append((rep, bits(state.surfaces.sae).cpu(), state.counts.cpu()))
    (g, g_sae, g_cnt), (c, c_sae, c_cnt) = runs
    keys = ("offered", "accepted", "ingested", "dropped", "refused",
            "discarded", "migrated")
    strip = lambda t: {k: {f: v for f, v in r.items() if "latency" not in f}
                       for k, r in t.items()}
    check(log_view(g.log) == log_view(c.log)
          and all(getattr(g, k) == getattr(c, k) for k in keys)
          and strip(g.tiers) == strip(c.tiers)
          and torch.equal(g_sae, c_sae) and torch.equal(g_cnt, c_cnt),
          f"fleet at {h}x{w}: card == CPU engine: action log "
          f"({len(g.log)} entries), counters, tier counters (migrated "
          f"{g.migrated}) and final SAE bits and counts")


def fleet_cli():
    """Phase 7, part 4: the ``stream --migrate-demo`` CLI in a subprocess
    on the card."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "stream",
         *FLEET_CLI_ARGV], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=SWEEP_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        if not line.startswith("feed "):
            log(f"  migrate-demo | {line}")
    if proc.returncode:
        log(proc.stderr[-4000:])
    check(proc.returncode == 0
          and "bitwise oracle gate: OK" in proc.stdout
          and "fleet ops: grow->" in proc.stdout,
          f"stream --migrate-demo CLI on the card: exit {proc.returncode}, "
          f"oracle gate OK, fleet ops printed "
          f"({time.perf_counter() - t0:.1f} s)")


class ShardLaunches:
    """Each kernel's launches per shard of one engine: while active, the
    three kernels' wrappers (``kernels.ts_decay.ts_decay_cuda``,
    ``kernels.stcf.stcf_support_cuda``, ``kernels.ts_fused.
    chunk_scatter_cuda``) are wrapped so that the launches one call adds
    to ``_lib.LAUNCHES`` are credited to the shard whose SAE the call
    reads or writes (launches on anything else, such as the gathered
    dirty tiles, go to ``None``).  ``paused()`` credits nothing, and puts
    ``_lib.LAUNCHES`` back as it was, around check reads."""

    WRAPPED = (("repro_torch.kernels.ts_decay", "ts_decay_cuda", "ts_decay"),
               ("repro_torch.kernels.stcf", "stcf_support_cuda",
                "stcf_support"),
               ("repro_torch.kernels.ts_fused", "chunk_scatter_cuda",
                "chunk_scatter"))

    def __init__(self, _lib, engine):
        self._lib, self.engine = _lib, engine
        self.counts: dict = {}
        self._active = True
        self._saved = []

    def _wrap(self, fn, kernel):
        def wrapped(x, *args, **kw):
            before = self._lib.LAUNCHES[kernel]
            out = fn(x, *args, **kw)
            if self._active:
                shard = {st.surfaces.sae.data_ptr(): k for k, st in
                         enumerate(self.engine._states)}.get(x.data_ptr())
                key = (shard, kernel)
                self.counts[key] = (self.counts.get(key, 0)
                                    + self._lib.LAUNCHES[kernel] - before)
            return out
        return wrapped

    def __enter__(self):
        for mod, attr, kernel in self.WRAPPED:
            m = importlib.import_module(mod)
            self._saved.append((m, attr, getattr(m, attr)))
            setattr(m, attr, self._wrap(getattr(m, attr), kernel))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in self._saved:
            setattr(m, attr, fn)

    @contextlib.contextmanager
    def paused(self):
        snap = dict(self._lib.LAUNCHES)
        self._active = False
        try:
            yield
        finally:
            self._active = True
            self._lib.LAUNCHES.update(snap)

    def per_shard(self, n_shards):
        return [{k: self.counts.get((shard, k), 0) for k in ENGINE_KERNELS}
                for shard in range(n_shards)]


class HostSpans:
    """Host time of a ``serve_step``'s parts on one engine, split
    exclusively (a span's time less the spans inside it): while active,
    the engine's ``_item_chunks`` (host chunking), ``_plan.route``,
    ``push`` (what is left of it: the uploads and the scatter launches),
    ``read`` (the products read after the surface), ``_gather`` (products
    onto shard 0), ``ops.ts_fused_dirty`` (the dirty-tile refresh) and
    ``torch.nonzero`` (its host sync) are wrapped with the host clock."""

    def __init__(self, ops, engine):
        self._targets = [(engine, "_item_chunks", "chunking"),
                         (engine._plan, "route", "route"),
                         (engine, "push", "uploads + scatter"),
                         (engine, "read", "other reads"),
                         (engine, "_gather", "gather"),
                         (ops, "ts_fused_dirty", "refresh"),
                         (torch, "nonzero", "nonzero sync")]
        self.ms = {name: 0.0 for _, _, name in self._targets}
        self.active = True
        self._stack = []
        self._saved = []

    def _wrap(self, fn, name):
        def wrapped(*args, **kw):
            if not self.active:
                return fn(*args, **kw)
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = (time.perf_counter() - t0) * 1e3
                inner = self._stack.pop()
                self.ms[name] += dt - inner
                if self._stack:
                    self._stack[-1] += dt
        return wrapped

    def __enter__(self):
        for obj, attr, name in self._targets:
            fn = getattr(obj, attr)
            self._saved.append((obj, attr, obj.__dict__.get(attr), fn))
            setattr(obj, attr, self._wrap(fn, name))
        return self

    def __exit__(self, *exc):
        for obj, attr, own, fn in reversed(self._saved):
            if own is None:       # a bound method: drop the wrapper
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)

    def per_step(self, n_steps: int, step_ms: float) -> dict:
        out = {k: v / n_steps for k, v in self.ms.items()}
        out["rest of serve_step"] = step_ms / n_steps - sum(out.values())
        return out


def shard_loop(dev, mods, words, run, n_shards, card, devices=None,
               profile=False):
    """Phase 8 (a): phase 1's FRAME loop on an ``n_shards`` engine, the
    shards cycling over ``devices`` (default: all on ``dev``), each with
    tensors of its own.  Each step's products against phase 1's on the
    same words, bitwise; incremental == dense at every deadline; launches
    per shard; the host time of a step by part (``HostSpans``), and with
    ``profile`` two more steps under ``torch.profiler``."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.launch.mesh import make_host_mesh

    frame, cfg = run["frame"], run["cfg"]
    mesh = make_host_mesh(n_shards, devices=devices or [dev])
    engine = eng.TimeSurfaceEngine(cfg, mesh=mesh)
    sessions = [engine.attach() for _ in range(S)]
    scene_of = [k % N_SCENES for k in range(S)]
    bursts = [[(sessions[k], words[scene_of[k]][b]) for k in range(S)]
              for b in range(2 * DEADLINES)]
    ptrs = {st.surfaces.sae.data_ptr() for st in engine._states}
    check(engine.n_slots_padded == -(-S // n_shards) * n_shards,
          f"shards: {S} slots pad to {engine.n_slots_padded} on "
          f"{n_shards} shards")
    check(len(ptrs) == n_shards and all(
        st.surfaces.sae.device == d
        for st, d in zip(engine._states, mesh.devices)),
        f"shards: {mesh.placement()}, each with an SAE of its own")
    step_ms, differ, mismatched = [], [], []
    t_wall = 0.0
    torch.cuda.synchronize()
    _lib.reset_launches()
    with ShardLaunches(_lib, engine) as sl, HostSpans(ops, engine) as hs:
        for d in range(DEADLINES):
            t_now = (d + 1) * DEADLINE_S
            for half in range(2):
                b = 2 * d + half
                if b == 2:   # spans over the steady steps only
                    hs.ms = dict.fromkeys(hs.ms, 0.0)
                t0 = time.perf_counter()
                out = engine.serve_step(bursts[b], frame, t_now)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                t_wall += dt
                step_ms.append(dt * 1e3)
                want = run["step_outs"][b]
                if not all(same(out[k][:S], want[k])
                           and not bits(out[k][S:]).any() for k in want):
                    differ.append(b)
            with sl.paused():
                hs.active = False
                dense = engine.read(rs.SURFACE_SPEC, t_now)["surface"]
                hs.active = True
                if not same(out["surface"], dense):
                    mismatched.append(d)
        launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    per_shard = sl.per_shard(n_shards)
    n_events = sum(engine.stats()["n_events"])
    steady = step_ms[2:]
    spans = hs.per_step(len(steady), sum(steady))
    res = dict(n_shards=n_shards, events_per_s=n_events / t_wall,
               p50_ms=float(np.percentile(steady, 50)),
               p99_ms=float(np.percentile(steady, 99)), launches=launches,
               launches_per_shard=per_shard, n_events=n_events,
               host_ms_per_step=spans)
    log(f"shards on {card}: FRAME loop on {n_shards} shard(s) of "
        f"{engine._plan.slots_per_shard} slots ({mesh.placement()}): "
        f"{n_events} "
        f"events in {t_wall:.4f} s -> {res['events_per_s']:.1f} events/s; "
        f"serve_step p50 {res['p50_ms']:.3f} ms, p99 {res['p99_ms']:.3f} ms "
        f"over deadlines 2..{DEADLINES} (phase 1, unsharded: "
        f"{run['events_per_s']:.1f} events/s)")
    log(f"shards: {n_shards}-shard launches {launches}, per shard "
        f"{per_shard}")
    log(f"shards: host ms of a steady serve_step by part on {n_shards} "
        f"shard(s), mean of {len(steady)}: "
        f"{ {k: round(v, 4) for k, v in spans.items()} }")
    if profile:
        # one dense and one incremental step under torch.profiler, after
        # the path's counts were read: kernel launches and device idle
        t_now = (DEADLINES + 1) * DEADLINE_S
        prof = profiled(lambda: [engine.serve_step(bursts[b], frame, t_now)
                                 for b in (0, 1)])
        profile_line(f"shards profile, {n_shards} shard(s), two steps "
                     f"(dense + incremental)", prof)
        res["profile"] = dict(launches=prof["launches"],
                              device_ms=prof["device_ms"],
                              wall_ms=prof["wall_ms"])
    check(not differ, f"{n_shards}-shard FRAME products == phase 1's "
          f"unsharded products, bitwise, at every step (differ: {differ})")
    check(not mismatched, f"{n_shards}-shard incremental serve_step == "
          f"dense read, bitwise, at every deadline ({mismatched})")
    check(n_events == run["n_events"], f"{n_shards}-shard events ingested "
          f"{n_events} == phase 1's {run['n_events']}")
    live = sorted({engine._plan.shard_of(c.slot) for c in sessions})
    check(all(per_shard[k][name] > 0 for k in live
              for name in ENGINE_KERNELS),
          f"every kernel launched on every shard holding sensors "
          f"({len(live)} of {n_shards})")
    route_ms = []
    for b in range(2 * DEADLINES):
        parts = engine._item_chunks(bursts[b])
        t0 = time.perf_counter()
        engine._plan.route(parts)
        route_ms.append((time.perf_counter() - t0) * 1e3)
    res["route_ms_p50"] = float(np.percentile(route_ms, 50))
    log(f"shards: host time of route (grouping by shard, stacking each "
        f"shard's fields) over {n_shards} shard(s), median of "
        f"{len(route_ms)} bursts: {res['route_ms_p50']:.4f} ms")
    return res


def shard_fleet(dev, mods, card, feeds, n_shards=2, devices=None):
    """Phase 8 (b): phase 7's elastic fleet on an ``n_shards`` engine (21
    slots pad to 22 on 2 shards: a dead tail) under the multi-shard EDF
    scheduler, the shards cycling over ``devices`` (default: ``dev``)."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.events import replay as rp
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import stream as st

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    cfg, scfg = fleet_cfgs(eng, st, frame, H, W)
    mesh = make_host_mesh(n_shards, devices=devices or [dev])

    def make():
        return eng.TimeSurfaceEngine(cfg, mesh=mesh)

    rp.replay(make(), feeds, scfg, frame, arrival_substeps=STREAM_SUBSTEPS,
              t_end=1.5 * DEADLINE_S)          # first-touch costs
    engine = make()
    check(engine.n_slots_padded == -(-FLEET_BUCKET // n_shards) * n_shards,
          f"shards: a {FLEET_BUCKET}-slot pool pads to "
          f"{engine.n_slots_padded} on {n_shards} shards")
    torch.cuda.synchronize()
    _lib.reset_launches()
    with ShardLaunches(_lib, engine) as sl:
        report = rp.replay(engine, feeds, scfg, frame,
                           arrival_substeps=STREAM_SUBSTEPS)
        launches = {k: _lib.LAUNCHES[k] for k in ENGINE_KERNELS}
    per_shard = sl.per_shard(n_shards)
    fleet_log = [(k, e) for k, e in report.log
                 if k in ("grow", "shrink", "migrate")]
    capacity, crossing = FLEET_BUCKET, []
    for k, e in fleet_log:
        if k == "grow":
            capacity = e
        elif k == "shrink":
            capacity = e[0]
        else:
            sps = -(-capacity // n_shards)
            crossing.append((e, e[0] // sps, e[1] // sps))
    log(f"shards fleet on {card}: {mesh.placement()}, {report.n_steps} "
        f"deadlines:")
    for line in report.summary().splitlines():
        log(f"  {line}")
    log(f"shards fleet log: {fleet_log}; migrations (move, from shard, to "
        f"shard): {crossing}; launches {launches}, per shard {per_shard}")
    check(any(a != b for _, a, b in crossing),
          f"shards fleet: a migration crosses shards ({crossing})")
    steps = [e for k, e in report.log if k == "step"]
    barriers = [i for i, e in enumerate(steps) if e.barrier]
    check(barriers == [i for i in range(len(steps))
                       if (i + 1) % FLEET_BARRIER_EVERY == 0],
          f"shards fleet: barrier steps every {FLEET_BARRIER_EVERY}th "
          f"deadline ({barriers} of {len(steps)})")
    for tier, row in sorted(report.tiers.items()):
        check(row["offered"] == row["ingested"] + row["dropped"]
              + row["refused"] + row["discarded"] + row["deferred"],
              f"shards fleet tier {tier} conserves: offered "
              f"{row['offered']} == ingested + dropped + refused + "
              f"discarded + deferred")
    check(all(per[k] > 0 for per in per_shard for k in ENGINE_KERNELS),
          f"shards fleet: every kernel launched on all {n_shards} shards")
    slow = latency_outliers(report)
    log(f"shards fleet: the {len(slow)} steps of longest readout latency, "
        f"with the actions logged before them and before the next step "
        f"(which syncs them): {slow}")
    try:
        n = rp.check_oracle(report, make, frame)
        check(n == report.n_steps, f"shards fleet digests == the "
              f"synchronous oracle's on a {n_shards}-shard factory, bitwise, at "
              f"all {n} deadlines")
    except AssertionError as err:
        check(False, f"shards fleet oracle gate: {err}")
    return dict(events_per_s=report.events_per_sec, launches=launches,
                launches_per_shard=per_shard, crossing=crossing,
                slowest_steps=slow,
                tiers={t: {k: report.tiers[t][k] for k in
                           ("ingested", "migrated", "latency_p50_us",
                            "latency_p99_us")} for t in report.tiers})


def latency_outliers(report, k=3):
    """The ``k`` steps of a replay with the longest readout latency, each
    with the kinds of the actions logged just before it and just before
    the next step (a pipelined step's latency runs until the next step
    syncs it)."""
    steps, acts, cur = [], [], {}
    for kind, e in report.log:
        if kind == "step":
            steps.append(e)
            acts.append(cur)
            cur = {}
        else:
            cur[kind] = cur.get(kind, 0) + 1
    acts.append(cur)
    order = sorted(range(len(steps)), key=lambda i: -steps[i].latency_s)
    return [dict(step=i, latency_ms=round(steps[i].latency_s * 1e3, 3),
                 n_events=steps[i].n_events, before=acts[i],
                 after=acts[i + 1]) for i in order[:k]]


def shard_migrate(dev, mods, words, card, devices=None):
    """Phase 8 (c): one migration between shards of a 4-shard QVGA pool
    (shards cycling over ``devices``, default ``dev``), bitwise the
    unsharded engine's ``migrate_slot``, timed."""
    _lib, ops, ts, aer, pipeline, rs, eng = mods
    from repro_torch.launch.mesh import make_host_mesh

    frame = rs.ReadoutSpec(surface=rs.surface(), mask=rs.mask(),
                           stcf=rs.stcf(), count=rs.count(4), ebbi=rs.ebbi())
    cfg = eng.TSEngineConfig(h=H, w=W, polarities=P,
                             n_slots=SHARD_MIGRATE_SLOTS, chunk_capacity=CAP,
                             mode="edram", specs=(frame,))
    mesh = make_host_mesh(SHARD_MIGRATE_SHARDS, devices=devices or [dev])
    sharded = eng.TimeSurfaceEngine(cfg, mesh=mesh)
    plain = eng.TimeSurfaceEngine(cfg, device=dev)
    src, dst = 1, SHARD_MIGRATE_SLOTS - 2
    sps = sharded._plan.slots_per_shard
    times = {}
    for e in (sharded, plain):
        for _ in range(SHARD_MIGRATE_SLOTS):
            e.attach()
        for b in range(2):
            e.serve_step([(s, words[s % N_SCENES][b])
                          for s in range(SHARD_MIGRATE_SLOTS)], frame,
                         DEADLINE_S)
        e._sessions[dst].detach()
        got, t_dev, t_host = timed_op(lambda: e.migrate(src, dst),
                                      mesh.devices)
        check(got == dst, f"shards: migrate {src} -> {dst} ({got})")
        times["sharded" if e is sharded else "plain"] = (t_dev, t_host)
    ok = all(b is None or same(a, b) for a, b in
             zip(eng._leaves(sharded.gather_state()),
                 eng._leaves(plain.state)))
    check(ok, f"shards: migrate {src} (shard {src // sps}) -> {dst} (shard "
          f"{dst // sps}) on {SHARD_MIGRATE_SHARDS} shards == the unsharded "
          f"migrate_slot, every leaf bitwise")
    after = sharded.serve_step([(dst, words[1][2])], frame, DEADLINE_S)
    want = plain.serve_step([(dst, words[1][2])], frame, DEADLINE_S)
    check(all(same(after[k], want[k]) for k in want),
          "shards: the next serve_step after the move == unsharded, bitwise")
    (sd, sh), (pd, ph) = times["sharded"], times["plain"]
    log(f"shards migrate on {card}: {P}x{H}x{W} slot {src} -> {dst} across "
        f"shards, device {sd:.4f} ms, host {sh:.4f} ms (the same move in "
        f"one unsharded pool: device {pd:.4f} ms, host {ph:.4f} ms)")
    return dict(cross_device_ms=sd, cross_host_ms=sh, plain_device_ms=pd,
                plain_host_ms=ph)


def shard_cli():
    """Phase 8 (d): the ``sensors --mesh 2`` CLI in a subprocess."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *SHARD_CLI_ARGV],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=SWEEP_TIMEOUT_S)
    for line in proc.stdout.splitlines():
        log(f"  sensors --mesh 2 | {line}")
    if proc.returncode:
        log(proc.stderr[-4000:])
    n = torch.cuda.device_count()
    placement = f"shard 0 -> cuda:0, shard 1 -> cuda:{1 % n}"
    check(proc.returncode == 0 and placement in proc.stdout
          and "fused surface bit-identical to dense readout: True"
          in proc.stdout,
          f"sensors --mesh 2 CLI on the card: exit {proc.returncode}, "
          f"placement {placement} printed, fused == dense "
          f"({time.perf_counter() - t0:.1f} s)")


def shard_loops(dev, mods, words, run, card):
    """Phase 8 (a), run straight after phase 1 while its products are
    held: the FRAME loop on 1, 2 and 4 shards of the card in turns (1, 2,
    4, 4, 2, 1), the first loop of each count profiled."""
    loops = {n: [] for n in SHARD_COUNTS}
    for n in SHARD_COUNTS + SHARD_COUNTS[::-1]:
        loops[n].append(shard_loop(dev, mods, words, run, n, card,
                                   profile=not loops[n]))
    return loops


def shard_phase(dev, mods, words, card, loops, fl, feeds):
    """Phase 8 (b)-(d) and the summary of (a)."""
    fleet = shard_fleet(dev, mods, card, feeds)
    log(f"shards fleet: events/s {fleet['events_per_s']:.1f} on 2 shards "
        f"(phase 7, one shard: {fl['events_per_s']:.1f})")
    mig = shard_migrate(dev, mods, words, card)
    shard_cli()
    for n, rs_ in loops.items():
        log(f"shards summary on {card}: {n} shard(s), in turns: events/s "
            f"{[round(r['events_per_s'], 1) for r in rs_]} (mean "
            f"{np.mean([r['events_per_s'] for r in rs_]):.1f}); serve_step "
            f"p50 {[round(r['p50_ms'], 3) for r in rs_]} ms, p99 "
            f"{[round(r['p99_ms'], 3) for r in rs_]} ms; route "
            f"{[round(r['route_ms_p50'], 4) for r in rs_]} ms")
    parts = {n: {k: float(np.mean([r["host_ms_per_step"][k] for r in rs_]))
                 for k in rs_[0]["host_ms_per_step"]}
             for n, rs_ in loops.items()}
    for n in SHARD_COUNTS[1:]:
        log(f"shards: host ms of a steady serve_step by part, {n} shards "
            f"less 1 shard (means of the loops in turns): "
            f"{ {k: round(parts[n][k] - parts[1][k], 4) for k in parts[1]} }")
    checked = loops[SHARD_LOOP_CHECKED][0]
    return dict(loops=loops, fleet=fleet, migrate=mig,
                launches=checked["launches"],
                launches_per_shard=checked["launches_per_shard"])


def visible_cards():
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def card_layouts(cards):
    """Phase 9's loops: (name, shard count, devices), each layout twice,
    forward then backward."""
    n = len(cards)
    one = [(f"{n} shards on 1 card", n, cards[:1]),
           (f"{n} shards on {n} cards", n, cards),
           ("2 shards on 2 cards", 2, cards[:2])]
    return one + one[::-1]


def card_loops(dev, mods, words, run, card):
    """Phase 9, part 1 (more than one card visible; run beside phase 8
    (a) while phase 1's products are held): one small copy between every
    ordered pair of cards (PyTorch enables peer access at a pair's first
    copy), one untimed N-card loop, then the layouts of ``card_layouts``
    in turns, every product bitwise phase 1's."""
    cards = visible_cards()
    t0 = time.perf_counter()
    for a in cards:
        for b in cards:
            if a != b:
                torch.ones(1, device=a).to(b)
    for d in cards:
        torch.cuda.synchronize(d)
    log(f"cards: first copies between every pair of the {len(cards)} "
        f"cards in {time.perf_counter() - t0:.3f} s")
    shard_loop(dev, mods, words, run, len(cards), card, devices=cards)
    log("cards: the first N-card loop above warmed every card; the loops "
        "below are timed in turns")
    runs = {}
    for name, n, devices in card_layouts(cards):
        runs.setdefault(name, []).append(shard_loop(
            dev, mods, words, run, n, card, devices=devices,
            profile=name not in runs))
    return runs


def cards_phase(dev, mods, words, card, runs, feeds, smi):
    """Phase 9, part 2: a migration from card 0's shard to the last
    card's, and the fleet on one shard per card, twice (the second on
    cards whose allocators the first warmed).  ``smi`` is every card's
    ``nvidia-smi`` name and power limit."""
    cards = visible_cards()
    log(f"cards: {smi}")
    for name, rr in runs.items():
        log(f"cards summary on {card}: {name}, in turns: events/s "
            f"{[round(r['events_per_s'], 1) for r in rr]} (mean "
            f"{np.mean([r['events_per_s'] for r in rr]):.1f}); "
            f"serve_step p50 {[round(r['p50_ms'], 3) for r in rr]} ms, "
            f"p99 {[round(r['p99_ms'], 3) for r in rr]} ms")
    mig = shard_migrate(dev, mods, words, card, devices=cards)
    fleets = [shard_fleet(dev, mods, card, feeds, n_shards=len(cards),
                          devices=cards) for _ in range(2)]
    for i, f in enumerate(fleets):
        log(f"cards fleet run {i + 1} on {len(cards)} cards: events/s "
            f"{f['events_per_s']:.1f}; p50/p99 per tier, us: "
            f"{ {t: (r['latency_p50_us'], r['latency_p99_us']) for t, r in f['tiers'].items()} }")
    return dict(cards=[str(d) for d in cards], smi=smi, migrate=mig,
                fleets=fleets,
                loops={name: [dict(events_per_s=r["events_per_s"],
                                   p50_ms=r["p50_ms"], p99_ms=r["p99_ms"],
                                   host_ms_per_step=r["host_ms_per_step"])
                              for r in rr] for name, rr in runs.items()})


def sweep_phase(card):
    """Phase 6, part 3: the ``sweep`` CLI in a subprocess on the card."""
    out = ROOT / "build" / "smoke_sweep"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "sweep",
         *SWEEP_ARGV, "--out", str(out)], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
        text=True, timeout=SWEEP_TIMEOUT_S)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"  sweep | {line}")
    if proc.returncode:
        log(proc.stderr[-4000:])
        check(False, f"sweep CLI exited {proc.returncode}")
        return {}
    doc = json.loads((out / "sweep.json").read_text())
    v = doc["verdicts"]
    log(f"sweep on {card}: {len(doc['rows'])} runs in {secs:.1f} s")
    check(v["analog_3d_within_tol"] and v["analog_3d_energy_ok"]
          and v["analog_2d_worse_than_3d"],
          f"sweep verdicts: analog_3d within tolerance "
          f"{v['analog_3d_within_tol']}, energy >= 10x "
          f"{v['analog_3d_energy_ok']} (min "
          f"{v['analog_3d_energy_factor']:.0f}x), analog_2d worse "
          f"{v['analog_2d_worse_than_3d']}")
    return dict(verdicts=v, seconds=secs)


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
    loops = shard_loops(dev, mods, words, run, card)
    phase_s["shards"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_runs = (card_loops(dev, mods, words, run, card)
                 if torch.cuda.device_count() > 1 else None)
    run.pop("step_outs")   # phase 1's products are not needed any more
    phase_s["cards"] = time.perf_counter() - t0
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
    t0 = time.perf_counter()
    an = analog_phase(dev, mods, words, card, Timer(dev), rows)
    sm = stream_phase(dev, mods, words, card)
    torch.cuda.synchronize()
    phase_s["analog and stream"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sw = sweep_phase(card)
    phase_s["sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feeds, fl = fleet_phase(dev, mods, words, card, sm)
    torch.cuda.synchronize()
    phase_s["fleet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh = shard_phase(dev, mods, words, card, loops, fl, feeds)
    torch.cuda.synchronize()
    phase_s["shards"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    if card_runs is None:
        log("cards: one card visible; phase 9 runs where there are more")
        cd = None
    else:
        cd = cards_phase(dev, mods, words, card, card_runs, feeds, smi)
    phase_s["cards"] += time.perf_counter() - t0
    log(f"phases, s: { {k: round(v, 2) for k, v in phase_s.items()} }")
    log(json.dumps({"analog": an, "stream": sm, "sweep": sw, "fleet": fl,
                    "shards": sh, "cards": cd}, default=str))

    launches = {**run["launches"], "decay_scan": lm["launches"]["decay_scan"]}
    kernels = []
    for row in rows:
        name = row.pop("name")
        kernels.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name],
                            launches=launches[name],
                            heads_path_launches=hd["launches"].get(name, 0),
                            stream_path_launches=sm["launches"].get(name, 0),
                            fleet_path_launches=fl["launches"].get(name, 0),
                            shard_path_launches=sh["launches"].get(name, 0),
                            shard_path_launches_per_shard=[
                                per.get(name, 0)
                                for per in sh["launches_per_shard"]],
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
