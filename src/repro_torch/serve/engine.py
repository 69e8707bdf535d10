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
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
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
                 device=None):
        self.device = resolve_device(device)
        wrong = [k for k, v in M.flatten(params).items()
                 if v.device != self.device]
        if wrong:
            raise ValueError(f"parameters {wrong[:3]} are not on the "
                             f"engine's device {self.device}")
        self.cfg, self.params, self.max_len = cfg, params, max_len
        self._decode = lambda p, t, c, pos: T.decode_step(p, t, c, pos, cfg)
        self._prefill = lambda p, t: T.prefill(p, t, cfg, max_len=max_len,
                                               last_logits_only=True)

    @torch.inference_mode()
    def serve(self, requests: Sequence[Request]) -> List[Result]:
        cfg = self.cfg
        b = len(requests)
        s0 = max(len(r.prompt) for r in requests)
        prompts = np.zeros((b, s0), np.int32)
        for i, r in enumerate(requests):
            prompts[i, s0 - len(r.prompt):] = r.prompt  # left-pad
        logits, caches, pos = self._prefill(
            self.params, torch.from_numpy(prompts).to(self.device))
        max_new = max(r.max_new_tokens for r in requests)
        # greedy within the true vocab (vocab is padded for sharding)
        cur = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1).to(torch.int32)
        outs = [cur.cpu().numpy()]
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
            logits, caches = self._decode(self.params, cur, caches, s0 + t)
            cur = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
            outs.append(cur.cpu().numpy())
        gen = np.concatenate(outs, axis=1)
        return [
            Result(tokens=gen[i, : requests[i].max_new_tokens],
                   n_prefill=len(requests[i].prompt),
                   n_decoded=int(min(gen.shape[1], requests[i].max_new_tokens)))
            for i in range(b)
        ]
