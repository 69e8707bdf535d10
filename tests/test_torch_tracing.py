"""``repro_torch.tracing`` on the LM serving path, on the CPU.

The reduced ``mamba2-2.7b`` (2 layers, d_model 64, chunk 16, float32)
serves a hand-built batch: three prompts of 40, 23 and 57 tokens, left-
padded to 57, with budgets of 1, 3 and 6 new tokens.  Off, nothing is
recorded and no profiler range is entered; under ``tracing.on()`` or a
``torch.profiler`` session the spans form the engine's tree with exact
counts, the served tokens are bitwise those of an untraced call, and
under the profiler each span lies within 1 ms of the profiler's own
event of that name (a median under 50 us).
"""
import statistics
import threading

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.models import module as M
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

CFG = get_config("mamba2-2.7b").reduced()
PROMPTS = (40, 23, 57)
BUDGETS = (1, 3, 6)
S0 = max(PROMPTS)


@pytest.fixture(scope="module")
def engine():
    params = M.init_params(T.param_defs(CFG), prng.PRNGKey(3), device="cpu")
    return ServeEngine(CFG, params, max_len=S0 + max(BUDGETS), device="cpu")


def _requests():
    rng = np.random.default_rng(5)
    return [Request(rng.integers(1, CFG.vocab, n).astype(np.int32),
                    max_new_tokens=k) for n, k in zip(PROMPTS, BUDGETS)]


def _tokens(results):
    return [r.tokens.tolist() for r in results]


@pytest.fixture(autouse=True)
def _empty():
    tracing.clear()
    yield
    tracing.clear()


def _by_name(recs, name):
    return [r for r in recs if r.name == name]


def test_off_records_nothing_and_enters_no_range(engine, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not torch.autograd._profiler_enabled()
    engine.serve(_requests())
    assert tracing.spans() == [] and entered == []
    with tracing.span("repro_torch.x") as off:
        assert off is None               # nothing to count into
    assert tracing.span("repro_torch.x") is tracing.span("repro_torch.y")


def test_tree_of_one_call(engine):
    with tracing.on():
        engine.serve(_requests())
        engine.serve(_requests())
    recs = tracing.spans()
    assert all(r.name.startswith("repro_torch.") and "decay_scan" not in
               r.name for r in recs)
    serves = _by_name(recs, "repro_torch.serve")
    assert len(serves) == 2
    assert {r.call for r in recs} == {s.id for s in serves}
    ids = {r.id: r for r in recs}
    for s in serves:
        assert s.parent is None and s.call == s.id
        call = [r for r in recs if r.call == s.id]
        assert call[0] is s and all(r.end_ns is not None for r in call)
        for r in call[1:]:
            p = ids[r.parent]
            assert p.call == s.id
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        kids = lambda rec, name: [r for r in call if r.parent == rec.id
                                  and r.name == name]
        (pre,) = kids(s, "repro_torch.serve.prefill")
        assert len(kids(pre, "repro_torch.serve.fetch")) == 1
        steps = kids(s, "repro_torch.serve.decode_step")
        assert len(steps) == max(BUDGETS) - 1
        assert [r.attrs["step"] for r in steps] == list(range(len(steps)))
        for st in steps:
            assert len(kids(st, "repro_torch.serve.fetch")) == 1
        # nothing else opens under the call
        assert {r.parent for r in call[1:]} <= {r.id for r in call}
        assert len(call) == 1 + 2 + 2 * len(steps)


def test_counts_are_exact(engine):
    with tracing.on():
        engine.serve(_requests())
    recs = tracing.spans()
    (s,) = _by_name(recs, "repro_torch.serve")
    assert s.counts == {"prompt_tokens": sum(PROMPTS),
                        "prompt_slots": 3 * S0}
    steps = _by_name(recs, "repro_torch.serve.decode_step")
    assert [r.counts["rows"] for r in steps] == [3] * 5
    # a row of budget k needs the tokens of k - 1 decode steps
    assert [r.counts["live_rows"] for r in steps] == [2, 2, 1, 1, 1]
    assert sum(r.counts["live_rows"] for r in steps) == sum(
        k - 1 for k in BUDGETS)
    # no other span has counts
    assert not any(r.counts for r in recs if r.name not in (
        "repro_torch.serve", "repro_torch.serve.decode_step"))


def test_tokens_bitwise_with_tracing_on_and_off(engine):
    from torch.profiler import ProfilerActivity, profile

    off = _tokens(engine.serve(_requests()))
    with tracing.on():
        on = _tokens(engine.serve(_requests()))
    with profile(activities=[ProfilerActivity.CPU]):
        profiled = _tokens(engine.serve(_requests()))
    assert off == on == profiled
    assert len(_by_name(tracing.spans(), "repro_torch.serve")) == 2


def test_spans_match_the_profilers_events(engine):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.serve(_requests())
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("repro_torch.")),
                    key=lambda e: e.start_ns())
    recs = tracing.spans()
    assert len(events) == len(recs) > 0
    diffs = []
    for name in {r.name for r in recs}:
        ev = [e for e in events if e.name() == name]
        rs = _by_name(recs, name)
        assert len(ev) == len(rs), name
        for e, r in zip(ev, rs):
            diffs += [abs(e.start_ns() - r.start_ns),
                      abs(e.start_ns() + e.duration_ns() - r.end_ns)]
    assert max(diffs) < 1_000_000
    assert statistics.median(diffs) < 50_000


def test_buffer_keeps_the_newest():
    first = None
    with tracing.on():
        for _ in range(tracing.MAX_SPANS + 10):
            with tracing.span("repro_torch.test") as s:
                first = first or s.id
    recs = tracing.spans()
    assert len(recs) == tracing.MAX_SPANS
    assert recs[0].id == first + 10 and recs[-1].id == first + len(recs) + 9


def test_threads_keep_their_own_stacks():
    """A span opened in another thread while one is open here is a root
    of its own call, not a child of this thread's span."""
    with tracing.on(), tracing.span("repro_torch.outer") as outer:
        t = threading.Thread(target=lambda: tracing.span(
            "repro_torch.other").__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracing.span("repro_torch.inner") as inner:
            pass
    (other,) = _by_name(tracing.spans(), "repro_torch.other")
    assert other.parent is None and other.call == other.id
    assert inner.parent == outer.id and inner.call == outer.id


def test_call_at_picks_the_call_open_at_a_time(engine):
    with tracing.on():
        engine.serve(_requests())
        engine.serve(_requests())
    a, b = _by_name(tracing.spans(), "repro_torch.serve")
    mid = (b.start_ns + b.end_ns) // 2
    call = tracing.call_at(mid, "repro_torch.serve")
    assert call[0] is b and all(r.call == b.id for r in call)
    assert tracing.call_at(a.start_ns, "repro_torch.serve")[0] is a
    assert tracing.call_at(mid, "repro_torch.other") == []
    assert tracing.call_at(b.end_ns + 1, "repro_torch.serve") == []
