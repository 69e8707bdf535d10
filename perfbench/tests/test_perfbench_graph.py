"""The reader of the program's ``graph`` count (``decode.graph_pct``):
one batch of each cell's own sizes, served on the CPU at tiny widths
under ``tracing.on()`` (no step replays a graph there), with device
activities placed by hand inside its spans and the steps' counts set by
hand as a card's would be; with no device activity, or a program that
counts no ``graph``, it reads nothing."""
import pytest

from perfbench import load
from perfbench.tests.test_perfbench_tracing import (CELLS, _placed,
                                                    _served_call)

READ = load.metric("decode.graph_pct").read


@pytest.mark.parametrize("cell", CELLS)
def test_graph_share_reads_the_steps_counts(cell):
    call = _served_call(cell)
    dev, _ = _placed(call)
    ctx = dict(trace={"device": dev})
    steps = [s for s in call if s.name == "repro_torch.serve.decode_step"]
    assert len(steps) > 2
    assert READ(ctx) == 0.0
    # a card's first call: two eager warm-ups, then captures and replays
    for i, s in enumerate(steps):
        s.counts["graph"] = int(i >= 2)
    assert READ(ctx) == pytest.approx(100.0 * (len(steps) - 2) / len(steps),
                                      rel=1e-12, abs=0)
    for s in steps:
        s.counts["graph"] = 1
    assert READ(ctx) == 100.0


def test_graph_share_reads_nothing_without_the_count_or_the_device():
    call = _served_call(CELLS[0])
    dev, _ = _placed(call)
    after = call[0].end_ns + 10**9
    for ctx in (dict(trace=None), dict(trace={"device": []}),
                dict(trace={"device": [(after, after + 5, "k")]})):
        assert READ(ctx) is None, ctx
    # a program whose steps count no ``graph`` (one before the graphs)
    for s in call:
        s.counts.pop("graph", None)
    assert READ(dict(trace={"device": dev})) is None
