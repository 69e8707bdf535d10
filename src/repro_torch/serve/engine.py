"""Batched LM serving engine: prefill + lockstep greedy decode.

The port of ``repro.serve.engine``.  A batch of requests is left-padded
with token 0 to the longest prompt and prefilled in one pass (for an SSM
the pad tokens run through the recurrence, exactly as in the reference);
then the whole batch decodes one token per step, greedily over the true
vocab (the logits are padded for sharding).  A request that has hit its
EOS or its token budget stops counting, but its row keeps decoding and
its tokens are discarded -- the static-shape analogue of continuous
batching.

Prefill unembeds only the last position (``last_logits_only``): serving
never needs the (B, S, V) logits.  The engine runs on the CUDA device
unless the caller passes ``device="cpu"``; the parameters must already
be there.

Over a mesh (``launch.mesh.make_test_mesh``, one process a device) every
rank builds the engine on its blocks of the parameters
(``sharding.placements``) and serves the same requests: it left-pads the
whole batch, prefills and decodes its own rows (the batch over the data
axes that divide it), and keeps its block of each cache, the sequence
split over ``cache_seq_axes`` (flash-decoding).  The last position's
logits are gathered over ``"model"`` before the greedy ``argmax``, each
step's tokens over the data axes, and every rank returns every
request's ``Result``.

Under tracing (``repro_torch.tracing``) a call is one
``repro_torch.serve`` span (counts ``prompt_tokens`` and
``prompt_slots``, the padded batch), holding ``repro_torch.serve.prefill``
(prefill and the first token), one ``repro_torch.serve.decode_step`` a
step (counts ``rows`` computed and ``live_rows``, those whose request
still needs the token) and a ``repro_torch.serve.fetch`` around each copy
of the tokens to the host.

An all-SSM model on one device decodes over two cache sets the engine
keeps at fixed addresses from call to call (``T.DecodeGraphs``, made anew
when the batch size changes): prefill fills one, each step writes the
other, and on a card each step from the third on replays a CUDA graph of
the whole step.  Each ``decode_step`` span counts ``graph``: 1 when that
step replayed a captured graph, else 0.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.mesh import check_mesh
from repro_torch.models import module as M
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never stops early


@dataclasses.dataclass
class Result:
    tokens: np.ndarray
    n_prefill: int
    n_decoded: int


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 mesh=None, device=None):
        check_mesh(mesh)
        if mesh is None:
            self.device = resolve_device(device)
        elif device is not None and resolve_device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device}")
        else:
            self.device = mesh.device
        wrong = [k for k, v in M.flatten(params).items()
                 if v.device != self.device]
        if wrong:
            raise ValueError(f"parameters {wrong[:3]} are not on the "
                             f"engine's device {self.device}")
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self.mesh = mesh
        # the current serve's batch and cache layout over the mesh, and
        # the decode caches and graphs of an all-SSM model on one device
        # (``T.DecodeGraphs``, kept for the newest batch size); the calls
        # below close over this dict, not over the engine, so that a
        # dropped engine frees its parameters at once (no cycle)
        self._layout = layout = {"batch": None, "shards": None,
                                 "graphs": None}
        self._decode = lambda p, t, c, pos: T.decode_step(
            p, t, c, pos, cfg, mesh=mesh, cache_shards=layout["shards"],
            graphs=layout["graphs"])

        def prefill(p, t):
            g = layout["graphs"]
            return T.prefill(
                p, t, cfg, max_len=max_len, mesh=mesh, last_logits_only=True,
                cache_shards=layout["shards"],
                caches=g.sets[0] if g is not None and g.batch == t.shape[0]
                else None)
        self._prefill = prefill

    def _rows(self, b: int):
        """This rank's rows of a batch of ``b`` (all of them without a
        mesh), and the mesh axes that split the batch."""
        if self.mesh is None:
            return slice(0, b), ()
        bspec = SH.batch_spec(self.mesh, b)
        axes = bspec[0] if bspec else ()
        n = self.mesh.count(axes)
        k = self.mesh.index(axes)
        return slice(k * (b // n), (k + 1) * (b // n)), axes

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The argmax within the true vocab (the logits are padded for
        sharding; ties to the lowest index), the vocab shards gathered
        over ``"model"`` first."""
        if self.mesh is not None:
            logits = SH.all_gather_dim(logits, self.mesh, "model", -1)
        return torch.argmax(logits[..., :self.cfg.vocab],
                            dim=-1).to(torch.int32)

    @torch.inference_mode()
    def serve(self, requests: Sequence[Request]) -> List[Result]:
        b = len(requests)
        s0 = max(len(r.prompt) for r in requests)
        with tracing.span("repro_torch.serve") as call:
            if call is not None:
                call.counts.update(
                    prompt_tokens=sum(len(r.prompt) for r in requests),
                    prompt_slots=b * s0)
            prompts = np.zeros((b, s0), np.int32)
            for i, r in enumerate(requests):
                prompts[i, s0 - len(r.prompt):] = r.prompt  # left-pad
            rows, axes = self._rows(b)
            if self.mesh is not None:
                self._layout.update(batch=b, shards=SH.cache_placements(
                    self.cfg, self.mesh, b, self.max_len))
            elif self.cfg.family == "ssm" and (
                    self._layout["graphs"] is None
                    or self._layout["graphs"].batch != b):
                # the old size's caches and graphs go before the new come
                self._layout["graphs"] = None
                self._layout["graphs"] = T.DecodeGraphs(self.cfg, b,
                                                        self.device)

            def gather(t: torch.Tensor) -> np.ndarray:
                """Every row's tokens on the host: where the host waits for
                the card."""
                with tracing.span("repro_torch.serve.fetch"):
                    if axes:
                        t = SH.all_gather_dim(t, self.mesh, axes, 0)
                    return t.cpu().numpy()

            with tracing.span("repro_torch.serve.prefill"):
                logits, caches, pos = self._prefill(
                    self.params,
                    torch.from_numpy(prompts[rows]).to(self.device))
                cur = self._greedy(logits[:, -1:, :])
                outs = [gather(cur)]
            max_new = max(r.max_new_tokens for r in requests)
            live = np.ones(b, bool)
            decoded = np.zeros(b, np.int32)
            for t in range(max_new - 1):
                for i, r in enumerate(requests):
                    if live[i] and (int(outs[-1][i, 0]) == r.eos_id
                                    or decoded[i] + 1 >= r.max_new_tokens):
                        live[i] = False
                decoded += live.astype(np.int32)
                if not live.any():
                    break
                with tracing.span("repro_torch.serve.decode_step",
                                  step=t) as step:
                    if step is not None:
                        # rows computed, and those whose request needs
                        # the token
                        step.counts.update(rows=int(cur.shape[0]),
                                           live_rows=int(live[rows].sum()))
                    logits, caches = self._decode(self.params, cur, caches,
                                                  s0 + t)
                    if step is not None:
                        g = self._layout["graphs"]
                        step.counts["graph"] = int(
                            g is not None and g.last in ("capture", "replay"))
                    cur = self._greedy(logits)
                    outs.append(gather(cur))
            gen = np.concatenate(outs, axis=1)
            return [
                Result(tokens=gen[i, : requests[i].max_new_tokens],
                       n_prefill=len(requests[i].prompt),
                       n_decoded=int(min(gen.shape[1],
                                         requests[i].max_new_tokens)))
                for i in range(b)
            ]
