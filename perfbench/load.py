"""Finding the benchmark's pieces by name: ``BENCHMARK.json`` at the root
of the checkout, ``configs/<config>.json``, ``workloads/<cell>.json``,
``reference/<config>.py``, ``work/<config>.py`` (where a configuration
brings one), ``metrics/<metric>.py`` and ``loops/<loop>.py`` under this
directory."""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def module(path: Path, name: str = None):
    """The Python file ``path`` loaded as a module of its own."""
    path = Path(path)
    name = name or "perfbench_" + "_".join(
        path.relative_to(HERE).with_suffix("").parts).replace(
            ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is not there")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is not there")
    return json.loads(path.read_text())


def benchmark(root: Path = ROOT) -> dict:
    return _json(Path(root) / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    """The ``workloads`` entry of BENCHMARK.json named ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json; cells: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def workload(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def reference(config_name: str):
    return module(HERE / "reference" / f"{config_name}.py")


def work(config_name: str):
    """``request_flops(m, prompt, new)`` of configuration ``config_name``:
    that of ``work/<config>.py`` where the configuration brings one (a
    block the yardstick does not count), ``yardstick.request_flops``
    otherwise."""
    path = HERE / "work" / f"{config_name}.py"
    if path.is_file():
        return module(path).request_flops
    from perfbench import yardstick

    return yardstick.request_flops


def metric(name: str):
    return module(HERE / "metrics" / f"{name}.py")


def loop(name: str):
    return module(HERE / "loops" / f"{name}.py")


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: its end-to-end
    metrics with ``trace`` off, its per-layer metrics with it on (an
    entry with a ``workloads`` list counts only for those cells)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]
