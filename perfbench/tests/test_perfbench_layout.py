"""BENCHMARK.json keeps to the benchmark's format and limits, and every cell,
configuration, reference, loop and metric it names is found by name."""
import json
import re

import pytest

from perfbench import load

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
#: the configurations' width keys, which ``reduced`` may never name
WIDTHS = {"d_model", "d_ff", "ssm_state", "ssm_heads", "ssm_headdim",
          "ssm_expand", "n_heads", "n_kv_heads", "head_dim"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert all(_line(w) for w in BENCH["command"])
    assert len((load.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_unit_and_line():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + METRICS
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert len(set(METRICS)) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # no width: no hidden, state, head or projection size, no
        # expansion factor, no key ending in _dim or _rank
        assert not set(c["reduced"]) & WIDTHS, c["reduced"]
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])


def test_metrics_shape():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for c in CELLS:
        assert load.metrics_of(BENCH, c, True), c


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    entry = load.cell(BENCH, cell)
    wl = load.workload(cell)
    cfg = load.config(entry["config"])
    assert wl["name"] == cell and wl["config"] == entry["config"]
    assert cfg["name"] == entry["config"]
    assert all(v is not None and v > 0 for v in wl["limits"].values())
    assert hasattr(load.loop(wl["loop"]), "Cell")
    assert hasattr(load.reference(cfg["name"]), "logits")


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_file(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((load.ROOT / entry["file"]).read_text())
    assert cfg["name"] == name and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) <= set(cfg["model"])
    assert any(w["config"] == name for w in BENCH["workloads"])


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found(name):
    assert callable(load.metric(name).read)


def test_metric_readers_find_nothing_in_an_empty_run():
    empty = dict(records=[], model_calls=[], trace=None, scans=None,
                 tokens=0, flops=0.0, latencies_s=[], peak_bytes=0,
                 window_s=1.0)
    for name in METRICS:
        if name != "setup_s":
            assert load.metric(name).read(empty) is None, name


@pytest.mark.parametrize(
    "prompts", [[100, 400], {"sizes": [400, 120, 250, 100]}],
    ids=["range", "sizes"])
def test_every_seed_gets_the_same_sizes(prompts):
    from perfbench import traffic

    wl = dict(batch=4, prompt_tokens=prompts, new_tokens=[1, 8])
    want = sorted(traffic.sizes(prompts, 4).tolist())
    assert want[0] == 100 and want[-1] == 400
    assert traffic.max_len(wl) == 408
    for seed in (1, 2**31 + 11):
        b = traffic.make_batch(wl, 300, seed, 0)
        assert sorted(len(p) for p in b.prompts) == want
        assert sorted(b.new_tokens) == [1, 3, 6, 8]
    with pytest.raises(ValueError):
        traffic.sizes({"sizes": [1, 2]}, 4)
