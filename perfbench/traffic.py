"""The seeded generator of offline LM batches.

Generalised from ``chip_smoke.lm_requests`` to the sizes a workload file
gives.  Every batch holds the same multiset of sizes: ``batch`` prompt
lengths from ``prompt_tokens`` and ``batch`` token budgets from
``new_tokens``.  Each is either ``[lo, hi]``, sizes spread evenly over
that range (both ends included, rounded), or ``{"sizes": [...]}``, one
size a row (the quantiles of a published length distribution, say).
The seed draws only which row gets which size, which rows are sampled
for the correctness check, and the token ids (uniform over the true
vocab).  So every seed asks for the same work, in another order, and
every batch has the shapes that set-up warms up.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

#: the stream of the warm-up batch; window batches use 0, 1, 2, ...
WARMUP = 2**20


class Batch(NamedTuple):
    prompts: List[np.ndarray]     # int32 token ids, one array a request
    new_tokens: List[int]         # greedy tokens to serve, no EOS
    sampled: List[int]            # rows whose logits the check compares


def sizes(spec, batch: int) -> np.ndarray:
    if isinstance(spec, dict):
        out = np.asarray(spec["sizes"], np.int64)
        if out.shape != (batch,) or out.min() < 1:
            raise ValueError(f"{batch} sizes of at least 1 wanted, got "
                             f"{spec['sizes']}")
        return out
    lo, hi = spec
    return np.rint(np.linspace(lo, hi, batch)).astype(np.int64)


def max_len(wl: dict) -> int:
    """The engine's ``max_len``: the longest prompt plus the most new
    tokens."""
    b = int(wl["batch"])
    return int(sizes(wl["prompt_tokens"], b).max()
               + sizes(wl["new_tokens"], b).max())


def make_batch(wl: dict, vocab: int, seed: int, index: int,
               capture_rows: int = None) -> Batch:
    """Batch ``index`` of workload ``wl`` under ``seed``.  ``sampled`` holds
    the row of the longest prompt, a row with the most new tokens, and
    others drawn from the seed, ``capture_rows`` in all (the workload's
    ``capture_rows`` by default; all rows when it is 0 or more than the
    batch)."""
    b = int(wl["batch"])
    rng = np.random.default_rng([int(seed), int(index)])
    lens = rng.permutation(sizes(wl["prompt_tokens"], b))
    news = rng.permutation(sizes(wl["new_tokens"], b))
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]
    k = wl.get("capture_rows", 3) if capture_rows is None else capture_rows
    if k <= 0 or k >= b:
        sampled = list(range(b))
    else:
        first = [int(np.argmax(lens)), int(np.argmax(news))]
        rest = [int(r) for r in rng.permutation(b) if r not in first]
        sampled = sorted(set(first))
        sampled += rest[:k - len(sampled)]
        sampled.sort()
    return Batch(prompts, [int(n) for n in news], sampled)
