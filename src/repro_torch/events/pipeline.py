"""Host event streams -> fixed-capacity ``EventBatch`` tensors, and the
synthetic LM token pipeline.

The port of ``to_event_batch``, ``window_chunks`` (with its oracle
``_window_chunks_reference``), ``TokenPipelineState`` and
``TokenPipeline`` and ``shard_batch`` from ``repro.events.pipeline``.  Padding is
``valid=False`` zeros; the scatter writes nothing for invalid events, so
pad values never reach a surface.  The token pipeline is numpy only and
yields the reference's tokens bitwise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import time_surface as ts
from repro_torch.device import resolve_device
from repro_torch.events import synthetic as syn


def _batch(fields, device) -> ts.EventBatch:
    device = resolve_device(device)
    return ts.EventBatch(*(torch.from_numpy(f).to(device) for f in fields))


def to_event_batch(s: syn.EventStream, capacity: Optional[int] = None,
                   device=None) -> ts.EventBatch:
    """Pad/truncate a host stream to a fixed-capacity EventBatch on
    ``device`` (default: the CUDA device; raises when there is none)."""
    n = s.n if capacity is None else capacity
    pad = max(0, n - s.n)
    cut = min(s.n, n)
    return _batch((
        np.pad(s.x[:cut], (0, pad)).astype(np.int32),
        np.pad(s.y[:cut], (0, pad)).astype(np.int32),
        np.pad(s.t[:cut], (0, pad)).astype(np.float32),
        np.pad(s.p[:cut], (0, pad)).astype(np.int32),
        np.pad(np.ones(cut, bool), (0, pad), constant_values=False),
    ), device)


def window_chunks(s: syn.EventStream, window_s: float,
                  capacity_per_window: int, device=None) -> ts.EventBatch:
    """Bin a stream into fixed windows: (K, capacity) EventBatch fields on
    ``device`` (default: the CUDA device; raises when there is none).

    Each event lands in exactly one window.  Overflowing windows keep
    their first ``capacity`` events in time order; short windows are
    padded with ``valid=False`` zeros.
    """
    cap = capacity_per_window
    if not s.n:
        return _batch((np.zeros((1, cap), np.int32),
                       np.zeros((1, cap), np.int32),
                       np.zeros((1, cap), np.float32),
                       np.zeros((1, cap), np.int32),
                       np.zeros((1, cap), bool)), device)
    k = int(np.ceil(s.t[-1] / window_s))
    idx = np.minimum((s.t / window_s).astype(np.int64), k - 1)
    # events of one window are contiguous in the time-sorted stream: each
    # event's position is its running index minus its window's start
    starts = np.zeros(k, np.int64)
    np.add.at(starts, idx, 1)
    starts = np.concatenate(([0], np.cumsum(starts)[:-1]))
    pos = np.arange(s.n, dtype=np.int64) - starts[idx]
    keep = pos < cap

    def fill(src, dtype):
        out = np.zeros((k, cap), dtype)
        out[idx[keep], pos[keep]] = src[keep].astype(dtype)
        return out

    valid = np.zeros((k, cap), bool)
    valid[idx[keep], pos[keep]] = True
    return _batch((fill(s.x, np.int32), fill(s.y, np.int32),
                   fill(s.t, np.float32), fill(s.p, np.int32), valid), device)


def _window_chunks_reference(s: syn.EventStream, window_s: float,
                             capacity_per_window: int,
                             device=None) -> ts.EventBatch:
    """The per-window loop (O(K·N) host work): the behavioral oracle
    ``window_chunks`` must match field for field."""
    k = int(np.ceil(s.t[-1] / window_s)) if s.n else 1
    idx = (np.minimum((s.t / window_s).astype(np.int64), k - 1) if s.n
           else np.zeros(0, np.int64))
    batches = []
    for wi in range(k):
        m = idx == wi
        sub = syn.EventStream(x=s.x[m], y=s.y[m], t=s.t[m], p=s.p[m],
                              is_signal=s.is_signal[m], h=s.h, w=s.w)
        batches.append(to_event_batch(sub, capacity_per_window, device))
    return ts.EventBatch(*(torch.stack(f) for f in zip(*batches)))


@dataclasses.dataclass
class TokenPipelineState:
    """Checkpointable state of the synthetic LM token pipeline."""

    seed: int
    step: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "step": self.step}

    @classmethod
    def from_dict(cls, d) -> "TokenPipelineState":
        return cls(seed=int(d["seed"]), step=int(d["step"]))


class TokenPipeline:
    """Deterministic synthetic LM tokens: (tokens, labels), int32 numpy
    arrays of shape (batch, seq), from an RNG keyed on (seed, step), so
    restoring ``state.step`` resumes exactly.  Each row weaves a repeated
    motif (period 16 + step % 7) into uniform tokens, 70 % motif, so a
    model has structure to learn."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.state = TokenPipelineState(seed=seed)

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s = self.state
        rng = np.random.default_rng((s.seed, s.step))
        base = rng.integers(0, self.vocab, size=(self.batch, self.seq + 1),
                            dtype=np.int64)
        period = 16 + (s.step % 7)
        ar = np.arange(self.seq + 1)
        motif = rng.integers(0, self.vocab, size=(self.batch, period),
                             dtype=np.int64)
        use_motif = rng.random((self.batch, self.seq + 1)) < 0.7
        woven = np.where(use_motif, motif[:, ar % period], base)
        self.state = dataclasses.replace(s, step=s.step + 1)
        return woven[:, :-1].astype(np.int32), woven[:, 1:].astype(np.int32)

    def state_dict(self) -> Dict[str, int]:
        return self.state.to_dict()

    def load_state_dict(self, d) -> None:
        self.state = TokenPipelineState.from_dict(d)


def shard_batch(arrays, mesh, data_axes=("data",)):
    """This rank's rows of each host array (a dict, list or tuple of
    them, or one): the batch dim split into contiguous blocks over
    ``data_axes`` of ``mesh`` (a ``distributed.mesh.ProcessMesh``), on the
    mesh's device."""
    n = mesh.count(data_axes)
    k = mesh.index([a for a in data_axes if a in mesh.shape])

    def one(a):
        a = np.asarray(a)
        if a.shape[0] % n:
            raise ValueError(f"batch {a.shape[0]} does not split over {n} "
                             f"data ranks")
        b = a.shape[0] // n
        return torch.from_numpy(np.ascontiguousarray(
            a[k * b:(k + 1) * b])).to(mesh.device)

    if isinstance(arrays, dict):
        return {key: one(v) for key, v in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(one(v) for v in arrays)
    return one(arrays)
