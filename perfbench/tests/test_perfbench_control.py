"""The control (the reference in fp8 in the program's place) is judged as
a run is judged and comes out not correct.  At a size a test run holds
the control reads three times the program or more, and a limit between
the two passes the program and fails the control; at the cells' own
sizes the readings taken on the card (``perfbench/control.py``, listed
in PERF.md and kept in ``readings/<cell>.json``) lie on either side of
each cell's limits."""
import math

import pytest

from perfbench import control, load
from perfbench.tests.conftest import card_readings, tiny

CELLS = [w["name"] for w in load.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_three_times_the_program(cell):
    wl = dict(load.workload(cell), batch=8, prompt_tokens=[20, 70],
              new_tokens=[1, 5])
    cfg = load.config(wl["config"])
    rows = [control.readings(wl, cfg, seed, 2, "cpu",
                             shrink=tiny(wl["config"]))
            for seed in (1, 2, 3)]
    assert all(r["altered"] == 0 for r in rows)
    lower = max(r["rel_err"] for r in rows)
    upper = min(r["ctl_rel_err"] for r in rows)
    assert upper >= 3 * lower, (lower, upper)
    limits = {"rel_err": math.sqrt(lower * upper)}
    for r in rows:
        j = control.judged(r, limits)
        assert j["correct"] and not j["ctl_correct"], j


@pytest.mark.parametrize("cell", CELLS)
def test_cell_limits_lie_between_the_card_readings(cell):
    limits = load.workload(cell)["limits"]
    readings = card_readings(cell)
    assert set(limits) == set(readings)
    program = dict({k: lo for k, (lo, _) in readings.items()}, altered=0,
                   tokens=1)
    ctl = {"ctl_" + k: hi for k, (_, hi) in readings.items()}
    j = control.judged(dict(program, **ctl), limits)
    assert j["correct"] and not j["ctl_correct"], j
    for k, (lo, hi) in readings.items():
        assert hi >= 3 * lo and lo < limits[k] < hi, (k, lo, hi)
