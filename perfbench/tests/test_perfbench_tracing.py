"""The readers of the program's spans and counters (``repro_torch.
tracing``): one batch of each cell's own sizes, served on the CPU at tiny
widths under ``tracing.on()``, with device activities placed by hand
inside its spans, reads the exact left padding and dead decode rows of
the cell's traffic, the placed activities a step (also under a device
clock that drifts from the host's), and the placed idle shares; with no
device activity, or none inside a ``serve`` call, every reader reads
nothing."""
import pytest

from perfbench import load, traffic
from perfbench.tests.conftest import tiny

CELLS = [w["name"] for w in load.benchmark()["workloads"]]
READERS = ("prefill.pad_pct", "decode.dead_row_pct",
           "decode.kernels_per_step", "decode.idle_pct", "prefill.idle_pct",
           "engine.first_token_ms")
SEED = 2147483659


def pad_pct(cell):
    """100 x the left padding of batch 0 of ``cell`` over its prompt
    slots (the batch times its longest prompt), from the cell's own
    traffic."""
    wl = load.workload(cell)
    vocab = tiny(wl["config"])["vocab"]
    lens = [len(p) for p in traffic.make_batch(wl, vocab, SEED, 0).prompts]
    slots = len(lens) * max(lens)
    return 100 * (slots - sum(lens)) / slots


@pytest.mark.parametrize("cell, pct", [("mamba2-2.7b.docs", 25.0),
                                       ("mamba2-2.7b.short", 43.75)])
def test_pad_share_of_the_mamba2_cells(cell, pct):
    """docs prefills 32,768 slots for 24,576 real tokens, short 32,768
    for 18,432."""
    assert pad_pct(cell) == pct


def _served_call(cell):
    """The spans of one ``serve`` of batch 0 of ``cell`` at tiny widths."""
    from repro_torch import tracing
    from repro_torch.serve.engine import Request, ServeEngine

    wl = load.workload(cell)
    cfg = load.config(wl["config"])
    shrink = dict(tiny(cfg["name"]), dtype="float32")
    model = dict(cfg["model"], **shrink)
    loop = load.loop(wl["loop"])
    pcfg = loop.program_config(cfg, model, shrink)
    weights = loop.COMMON.draw(load.reference(cfg["name"]).leaves(model),
                               SEED, "cpu")
    engine = ServeEngine(pcfg, loop.COMMON.nest(weights),
                         max_len=traffic.max_len(wl), device="cpu")
    b = traffic.make_batch(wl, model["vocab"], SEED, 0)
    tracing.clear()
    with tracing.on():
        engine.serve([Request(p, max_new_tokens=n)
                      for p, n in zip(b.prompts, b.new_tokens)])
    call = tracing.spans()
    assert call[0].name == "repro_torch.serve"
    return call


COPY = "Memcpy DtoH (Device -> Pageable)"


def _placed(call):
    """Device activities placed in the call's spans, and the numbers the
    readers must give: in the prefill span, two overlapping activities
    busy over 4 tenths of it up to its fetch; in each decode step three
    that start before its fetch ends, the first at its start, busy over
    all but 5 tenths of it up to its fetch (the last runs past the
    step's end); and a copy to the host of no length at the end of each
    fetch."""
    dev = []
    fetches = [x for x in call if x.name == "repro_torch.serve.fetch"]
    pre = next(s for s in call if s.name == "repro_torch.serve.prefill")
    s, e, f = pre.start_ns, pre.end_ns, fetches[0].end_ns
    q = (f - s) // 10
    dev += [(s + q, s + 4 * q, "k"), (s + 3 * q, s + 5 * q, "k"),
            (f - 1, f - 1, COPY)]
    pre_idle = 100.0 * (e - s - 4 * q) / (e - s)
    steps = [x for x in call if x.name == "repro_torch.serve.decode_step"]
    total = idle = 0
    for st, fetch in zip(steps, fetches[1:]):
        s, e, f = st.start_ns, st.end_ns, fetch.end_ns
        q = (f - s) // 10
        dev += [(s, s + 3 * q, "k"), (s + 5 * q, s + 6 * q, "k"),
                (s + 9 * q, e + 1, "k"), (f - 1, f - 1, COPY)]
        total += e - s
        idle += 5 * q
    want = {"decode.dead_row_pct": 50.0, "decode.kernels_per_step": 4.0,
            "decode.idle_pct": 100.0 * idle / total,
            "prefill.idle_pct": pre_idle,
            "engine.first_token_ms":
                (fetches[0].end_ns - call[0].start_ns) / 1e6}
    return sorted(dev), want


@pytest.mark.parametrize("cell", CELLS)
def test_readers_read_the_call_and_the_placed_activities(cell):
    call = _served_call(cell)
    dev, want = _placed(call)
    want["prefill.pad_pct"] = pad_pct(cell)
    ctx = dict(trace={"device": dev})
    got = {n: load.metric(n).read(ctx) for n in READERS}
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    # the traffic's own numbers, exactly
    assert got["prefill.pad_pct"] == want["prefill.pad_pct"]
    assert got["decode.dead_row_pct"] == 50.0
    assert got["decode.kernels_per_step"] == 4.0


@pytest.mark.parametrize("drift", ["late", "early", "growing", "clipped"])
def test_kernel_count_holds_under_a_drifting_device_clock(drift):
    """The device's clock running late or early against the host's, or
    ever later, by more than the host's gap from one fetch to the next
    step (which moves activities across the steps' spans, at the first
    step's start too) and less than half a step, leaves the count as it
    is; so does a late clock that carries the last step's copy past the
    traced window's end, where the trace drops it."""
    call = _served_call(CELLS[0])
    dev, want = _placed(call)
    ends = [x.end_ns for x in call if x.name == "repro_torch.serve.fetch"]
    starts = [x.start_ns for x in call
              if x.name == "repro_torch.serve.decode_step"]
    gap = max(b - a for a, b in zip(ends, starts))
    d = 4 * min(b - a for a, b in zip(ends, ends[1:])) // 10
    assert d > gap
    t0 = dev[0][0]
    shift = {"late": lambda t: d, "early": lambda t: -d,
             "growing": lambda t: d * (t - t0) // (ends[-1] - t0),
             "clipped": lambda t: d}[drift]
    moved = sorted((a + shift(a), b + shift(a), n) for a, b, n in dev)
    if drift == "clipped":
        moved = [m for m in moved if m[0] <= call[0].end_ns]
        assert sum(m[2] == COPY for m in moved) == len(ends) - 1
    read = load.metric("decode.kernels_per_step").read
    assert read(dict(trace={"device": moved})) == 4.0


def test_readers_read_nothing_without_device_activity_in_a_call():
    call = _served_call(CELLS[0])
    after = call[0].end_ns + 10**9
    for ctx in (dict(trace=None), dict(trace={}),
                dict(trace={"device": []}),
                dict(trace={"device": [(after, after + 5, "k")]})):
        for n in READERS:
            assert load.metric(n).read(ctx) is None, (n, ctx)
