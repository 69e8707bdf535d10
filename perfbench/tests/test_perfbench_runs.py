"""A whole run of each cell on the CPU at tiny widths (the look for a card
skipped): the references agree with ``repro_torch``, and ``correct``
comes out false when the timed path is broken underneath."""
import pytest
import torch

from perfbench import load, run
from perfbench.tests.conftest import SMALL_TRAFFIC, TINY

CELLS = [w["name"] for w in load.benchmark()["workloads"]]


def _run(tmp_path, cell, dtype="float32", fault=None, limits=None,
         trace=0, traffic=SMALL_TRAFFIC):
    cfg = load.workload(cell)["config"]
    patch = dict(traffic)
    if limits is not None:
        patch["limits"] = limits
    return run.main(["--workload", cell, "--seed", "2147483659",
                     "--seconds", "0.3", "--trace", str(trace),
                     "--out", str(tmp_path)],
                    device="cpu", shrink=dict(TINY[cfg], dtype=dtype),
                    fault=fault, wl_patch=patch)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program_in_float32(tmp_path, cell):
    r = _run(tmp_path, cell)
    assert r["correct"] and r["failed"] == 0
    # float32 on both sides: only the order of the sums differs
    assert all(c["value"] < 1e-4 for c in r["checks"].values())
    assert set(r["metrics"]) == {"tokens_per_s", "request_p95_ms",
                                 "setup_s"}


def test_traced_run_reports_the_per_layer_metrics(tmp_path):
    r = _run(tmp_path, "mamba2-2.7b.docs", trace=1)
    # on the CPU no device activity is traced: the device's metrics and
    # decay_scan's roofline read nothing and are left out
    assert set(r["metrics"]) == {"engine.host_pct", "prefill.tokens_per_s",
                                 "decode.step_ms", "step_mfu"}
    assert r["correct"] and "breakdown" in r


def _frozen_state(cell):
    """decode_step returns the caches it was given: the SSM state and
    conv rings never move."""
    step = cell.wrappers.orig[1]

    def frozen(params, tokens, caches, *a, **kw):
        logits, _ = step(params, tokens, caches, *a, **kw)
        return logits, caches
    cell.wrappers.orig[1] = frozen


def _half_batch(cell):
    """Half of the batch left out: in prefill and in every decode step
    the rows past the first half get the mean of the first half's
    logits."""
    def halved(fn):
        def run(params, tokens, *a, **kw):
            out = fn(params, tokens, *a, **kw)
            logits = out[0].clone()
            h = max(1, logits.shape[0] // 2)
            logits[h:] = logits[:h].mean(0, keepdim=True)
            return (logits, *out[1:])
        return run
    cell.wrappers.orig[0] = halved(cell.wrappers.orig[0])
    cell.wrappers.orig[1] = halved(cell.wrappers.orig[1])


def _altered_token(cell):
    """The engine's greedy choice moved by one where it is made (every
    row, so that the sampled rows see it however few batches the window
    holds)."""
    greedy = cell.engine._greedy

    def altered(logits):
        return (greedy(logits) + 1) % cell.vocab
    cell.engine._greedy = altered


FAULTS = {"frozen_state": _frozen_state, "half_batch": _half_batch,
          "altered_token": _altered_token}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    limits = load.workload(cell)["limits"]
    # more decode steps than the other tests: a fault in decode then
    # weighs on most of the served tokens, as at the cells' own sizes
    r = _run(tmp_path, cell, fault=FAULTS[fault], limits=limits,
             traffic=dict(SMALL_TRAFFIC, new_tokens=[6, 12]))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_bf16_run_is_correct_at_the_cells_limits(tmp_path, cell):
    limits = load.workload(cell)["limits"]
    r = _run(tmp_path, cell, dtype="bfloat16", limits=limits)
    assert r["correct"], r["checks"]


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""
