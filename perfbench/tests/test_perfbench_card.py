"""The harness on the card at tiny widths: a run of every cell ends with
a result line whose device is the card and whose metrics are the cell's
(run with ``-m gpu`` on a machine with a card)."""
import pytest
import torch

from perfbench import load, run
from perfbench.tests.conftest import SMALL_TRAFFIC, TINY

CELLS = [w["name"] for w in load.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_on_the_card(tmp_path, cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = load.workload(cell)["config"]
    r = run.main(["--workload", cell, "--seed", "2147483659", "--seconds",
                  "0.5", "--trace", str(trace), "--out", str(tmp_path)],
                 device="cuda", shrink=dict(TINY[cfg], dtype="float32"),
                 wl_patch=SMALL_TRAFFIC)
    assert r["correct"] and r["device"]["platform"] == "cuda"
    names = {m["name"] for m in load.metrics_of(load.benchmark(), cell,
                                                bool(trace))}
    assert set(r["metrics"]) <= names
    if trace:
        assert r["device"]["busy_s"] > 0
        assert "decay_scan_roofline" in r["metrics"]
