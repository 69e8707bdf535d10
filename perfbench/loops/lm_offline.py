"""Closed-loop offline LM batches served through
``repro_torch.serve.engine.ServeEngine.serve`` on one card.

Set-up draws the weights on the device from the seed (the reference's
own leaf list, ``reference/<config>.py``), builds the engine with
``max_len`` = the longest prompt plus the most new tokens, and warms up
with one ``serve`` of a batch of the cell's own shapes.  The window then
takes batch after batch from ``traffic.make_batch`` and serves each,
waiting for it, until ``seconds`` have passed; it ends when that last
call returns, so every request counted has completed.

The benchmark's wrappers go around ``repro_torch.models.transformer``'s
``prefill`` and ``decode_step`` (the engine looks both up at each call):
they keep, for the sampled rows, the float32 logits the greedy choice
is made from (one small gather a call), and in a traced run time each
call on the host clock between two synchronizes.  A traced run also
records the shapes of ``kernels.ops.decay_scan``'s calls and serves one
more batch under ``torch.profiler`` after the window closes.

After the window the engine is dropped and the reference computes the
sampled rows again in float32 (``check``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import load, traffic
from perfbench import trace as TR

COMMON = load.module(load.HERE / "reference" / "common.py",
                     "perfbench_reference_common")


class Wrappers:
    """The benchmark's wrappers around the program's model calls."""

    def __init__(self, T, ops, vocab: int, timed: bool, sync):
        self.T, self.ops, self.vocab = T, ops, vocab
        self.timed, self.sync = timed, sync
        self.rows: Optional[torch.Tensor] = None
        self.logits: List[torch.Tensor] = []
        self.calls: List[tuple] = []          # (kind, s, batch, seq)
        self.scans: Optional[list] = None     # decay_scan shapes, when on
        # the program's functions: ``orig`` is what the wrappers call (a
        # test's fault may replace an entry), ``true`` what ``remove``
        # puts back
        self.true = (T.prefill, T.decode_step, ops.decay_scan)
        self.orig = list(self.true)

    def _wrap(self, kind: str, fn):
        def run(*args, **kw):
            tokens = args[1] if len(args) > 1 else kw["tokens"]
            with torch.profiler.record_function(f"perfbench.{kind}"):
                if self.timed:
                    self.sync()
                    t0 = time.perf_counter()
                out = fn(*args, **kw)
                if self.timed:
                    self.sync()
                    self.calls.append((kind, time.perf_counter() - t0,
                                       int(tokens.shape[0]),
                                       int(tokens.shape[1])))
            if self.rows is not None:
                self.logits.append(out[0][self.rows, -1, :self.vocab])
            return out
        return run

    def _scan(self, a, x, s0=None):
        if self.scans is not None:
            self.scans.append((*a.shape, s0 is not None))
        return self.orig[2](a, x, s0)

    def install(self):
        self.T.prefill = self._wrap("prefill", self.orig[0])
        self.T.decode_step = self._wrap("decode_step", self.orig[1])
        if self.timed:
            self.ops.decay_scan = self._scan

    def remove(self):
        self.T.prefill, self.T.decode_step, self.ops.decay_scan = self.true


def program_config(cfg_file: dict, model: dict, shrink: Optional[dict]):
    """The program's config of ``cfg_file["arch"]`` (with ``shrink``'s
    keys replaced, for CPU tests), checked against every number the
    configuration file states: a run whose program departs from it is
    no sound run."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    pcfg = get_config(cfg_file["arch"])
    if shrink:
        pcfg = dataclasses.replace(pcfg, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in shrink.items() if k != "vocab_padded"})
    wrong = []
    for k, want in model.items():
        got = T.padded_vocab(pcfg) if k == "vocab_padded" else getattr(pcfg, k)
        if isinstance(got, tuple):
            got = list(got)
        if got != want:
            wrong.append(f"{k}: program {got!r}, configuration {want!r}")
    if wrong:
        raise SystemExit(f"the program's {cfg_file['arch']} is not the "
                         f"configuration {cfg_file['name']}: {wrong}")
    return pcfg


class Cell:
    """One cell's run: ``setup``, ``window``, ``close``, ``check``."""

    def __init__(self, wl: dict, cfg_file: dict, seed: int, device,
                 shrink: Optional[dict] = None, fault=None):
        self.wl, self.cfg_file, self.seed = wl, cfg_file, int(seed)
        self.dev = torch.device(device)
        self.model = dict(cfg_file["model"], **(shrink or {}))
        self.shrink, self.fault = shrink, fault
        self.ref = load.reference(cfg_file["name"])
        self.vocab = int(self.model["vocab"])
        self.sync = (torch.cuda.synchronize if self.dev.type == "cuda"
                     else (lambda: None))
        self.records: List[dict] = []

    # ------------------------------------------------------------ set-up
    def setup(self, trace: bool, capture_rows: Optional[int] = None):
        from repro_torch.kernels import ops
        from repro_torch.models import transformer as T
        from repro_torch.serve.engine import Request, ServeEngine

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        self.Request, self.trace = Request, trace
        self.capture_rows = capture_rows
        pcfg = program_config(self.cfg_file, self.model, self.shrink)
        self.weights = COMMON.draw(self.ref.leaves(self.model), self.seed,
                                   self.dev)
        self.engine = ServeEngine(pcfg, COMMON.nest(self.weights),
                                  max_len=traffic.max_len(self.wl),
                                  device=self.dev)
        self.wrappers = Wrappers(T, ops, self.vocab, trace, self.sync)
        if self.fault is not None:
            self.fault(self)
        self.wrappers.install()
        self._serve(traffic.WARMUP, keep=False)
        self.sync()

    def _serve(self, index: int, keep: bool = True, profile: bool = False):
        b = traffic.make_batch(self.wl, self.vocab, self.seed, index,
                               self.capture_rows)
        reqs = [self.Request(p, max_new_tokens=n)
                for p, n in zip(b.prompts, b.new_tokens)]
        w = self.wrappers
        w.rows = (torch.tensor(b.sampled, device=self.dev) if keep else None)
        w.logits = []
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as tp

            acts = [ProfilerActivity.CPU]
            if self.dev.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            w.scans = []
            prof = tp(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        with torch.profiler.record_function(TR.WINDOW):
            results = self.engine.serve(reqs)
        t1 = time.perf_counter()
        if prof is not None:
            self.sync()
            prof.__exit__(None, None, None)
        if keep:
            self.records.append(dict(index=index, batch=b, results=results,
                                     logits=w.logits, t0=t0, t1=t1))
        w.rows, w.logits = None, []
        return prof

    def serve_batches(self, n: int):
        """Serve batches 0..n-1 (no clock: the control's readings)."""
        for i in range(n):
            self._serve(i)

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        """Serve batches for ``seconds``; returns what the metric readers
        read (``ctx``, see README.md)."""
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.wrappers.calls = []
        start = time.perf_counter()
        i = 0
        while True:
            self._serve(i)
            i += 1
            if self.records[-1]["t1"] - start >= seconds:
                break
        end = self.records[-1]["t1"]
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)
        ctx = dict(model=self.model, workload=self.wl,
                   records=list(self.records), start=start,
                   window_s=end - start, peak_bytes=peak,
                   model_calls=list(self.wrappers.calls),
                   trace=None, scans=None)
        ctx.update(window_numbers(ctx))
        if self.trace:
            prof = self._serve(i, profile=True)
            ctx["trace"] = TR.read(*TR.events(prof))
            ctx["scans"] = self.wrappers.scans
            self.wrappers.scans = None
        return ctx

    def close(self):
        """Drop the engine and the program's state (the weights are the
        benchmark's, and stay for the reference)."""
        self.wrappers.remove()
        del self.engine
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def _rows_of(self, rec: dict):
        """The sampled rows of one served batch: (reference input tokens
        (R, T), positions compared, per row its served tokens and the
        program's logits (n, vocab))."""
        b = rec["batch"]
        s0 = max(len(p) for p in b.prompts)
        rows = b.sampled
        toks = [np.asarray(rec["results"][r].tokens, np.int64) for r in rows]
        nmax = max(len(t) for t in toks)
        seq = np.zeros((len(rows), s0 + nmax - 1), np.int64)
        prog = []
        for j, r in enumerate(rows):
            p = b.prompts[r]
            seq[j, s0 - len(p):s0] = p           # left-padded with 0
            seq[j, s0:s0 + len(toks[j]) - 1] = toks[j][:-1]
            prog.append([rec["logits"][q][j] for q in range(len(toks[j]))])
        return seq, range(s0 - 1, s0 - 1 + nmax), toks, prog

    def check(self, fp8_control: bool = False) -> Dict[str, float]:
        """The numbers that can be compared, over every sampled row of
        every batch served: ``gap``, the widest gap by which a served
        token's logit lies below the reference's best; ``rel_err``, the
        largest ||program - reference|| / ||reference - its mean|| over
        the true vocab at one position, and ``rel_err_p75``, its 75th
        percentile over the positions; ``gap_mean``, the mean gap over
        the served tokens; ``altered``, served tokens that are not the
        argmax of the logits they were chosen from.  With
        ``fp8_control`` it also reads the control in the program's place,
        the gaps of the tokens it would choose (``ctl_`` and the same
        names)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        gaps, rels, ctl_gaps, ctl_rels = [], [], [], []
        altered = requests = 0
        with torch.inference_mode():
            for rec in self.records:
                seq, pos, toks, prog = self._rows_of(rec)
                t = torch.from_numpy(seq).to(self.dev)
                ref = self.ref.logits(self.model, self.weights, t, pos)
                ctl = (self.ref.logits(self.model, self.weights, t, pos,
                                       fp8=True) if fp8_control else None)
                for j, served in enumerate(toks):
                    requests += 1
                    for q, tok in enumerate(served.tolist()):
                        r = ref[j, q]
                        p = prog[j][q].to(r.device, torch.float32)
                        gaps.append(float(r.max() - r[tok]))
                        rels.append(_rel(p, r))
                        altered += int(int(p.argmax()) != tok)
                        if ctl is not None:
                            c = ctl[j, q]
                            ctl_gaps.append(float(r.max() - r[int(c.argmax())]))
                            ctl_rels.append(_rel(c, r))
                del ref, ctl
        out = dict(_summary(gaps, rels), altered=altered,
                   tokens=len(gaps), requests=requests)
        if fp8_control:
            out.update({"ctl_" + k: v
                        for k, v in _summary(ctl_gaps, ctl_rels).items()})
        return out


def _summary(gaps: List[float], rels: List[float]) -> Dict[str, float]:
    if not gaps:
        return dict(gap=0.0, gap_mean=0.0, rel_err=0.0, rel_err_p75=0.0)
    p75 = sorted(rels)[math.ceil(0.75 * len(rels)) - 1]   # nearest rank
    return dict(gap=max(gaps), gap_mean=sum(gaps) / len(gaps),
                rel_err=max(rels), rel_err_p75=p75)


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x - ref)
                 / torch.linalg.vector_norm(ref - ref.mean()))


def window_numbers(ctx: dict) -> dict:
    """Requests, real tokens, per-request latencies and useful FLOPs of
    the window's batches (all completed)."""
    from perfbench import yardstick

    lat, tokens, flops, attempted, failed = [], 0, 0.0, 0, 0
    for rec in ctx["records"]:
        b = rec["batch"]
        for p, n, res in zip(b.prompts, b.new_tokens, rec["results"]):
            attempted += 1
            if len(res.tokens) != n:
                failed += 1
                continue
            lat.append(rec["t1"] - rec["t0"])
            tokens += len(p) + n
            flops += yardstick.request_flops(ctx["model"], len(p), n)
    return dict(latencies_s=lat, tokens=tokens, flops=flops,
                attempted=attempted, failed=failed)
