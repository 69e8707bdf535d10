"""A configuration and its cell join the benchmark by new files alone: a
copy of ``perfbench/`` with a renamed twin of mamba2-2.7b, brought as new
files and new entries in ``BENCHMARK.json`` and nothing else, passes
every test that its names select, and the twin's own work count gives
mamba2-2.7b's FLOPs.  A configuration that brings no work count is
counted by the yardstick."""
import json
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

from perfbench import load, yardstick
from perfbench.loops import lm_offline

TWIN, SOURCE = "twin", "mamba2-2.7b"
CELL, SOURCE_CELL = "twin.docs", "mamba2-2.7b.docs"
SEED = 2147483659


def _json(path, obj):
    path.write_text(json.dumps(obj, indent=2) + "\n")


def add_twin(root):
    """Give the copy at ``root`` the twin of mamba2-2.7b by new files:
    configuration, reference, tiny widths, work count, workload, card
    readings and a per-layer metric of its own, and their entries in
    ``BENCHMARK.json``."""
    pb = root / "perfbench"
    new = []

    def write(rel, obj=None, text=None):
        path = pb / rel
        assert not path.exists(), path
        path.parent.mkdir(parents=True, exist_ok=True)
        _json(path, obj) if text is None else path.write_text(text)
        new.append(path)

    cfg = json.loads((pb / "configs" / f"{SOURCE}.json").read_text())
    write(f"configs/{TWIN}.json", dict(cfg, name=TWIN))
    write(f"reference/{TWIN}.py",
          text=(pb / "reference" / f"{SOURCE}.py").read_text())
    write(f"tests/tiny/{TWIN}.json",
          json.loads((pb / "tests" / "tiny" / f"{SOURCE}.json").read_text()))
    write(f"work/{TWIN}.py", text=(
        '"""The work count of the twin: mamba2-2.7b\'s."""\n'
        "from perfbench import yardstick\n\n\n"
        "def request_flops(m, prompt, new):\n"
        "    return yardstick.request_flops(m, prompt, new)\n"))
    wl = json.loads((pb / "workloads" / f"{SOURCE_CELL}.json").read_text())
    write(f"workloads/{CELL}.json", dict(wl, name=CELL, config=TWIN))
    write(f"tests/readings/{CELL}.json", json.loads(
        (pb / "tests" / "readings" / f"{SOURCE_CELL}.json").read_text()))
    write(f"metrics/{TWIN}.step_mfu.py", text=(
        '"""step_mfu of the twin\'s cells."""\n'
        "from perfbench import load\n\n\n"
        "def read(ctx):\n"
        '    return load.metric("step_mfu").read(ctx)\n'))

    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == SOURCE)
    bench["configs"].append(dict(entry, name=TWIN,
                                 file=f"perfbench/configs/{TWIN}.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == SOURCE_CELL)
    bench["workloads"].append(dict(cell, name=CELL, config=TWIN))
    mfu = next(m for m in bench["per_layer"] if m["name"] == "step_mfu")
    bench["per_layer"].append(dict(mfu, name=f"{TWIN}.step_mfu",
                                   workloads=[CELL]))
    _json(root / "BENCHMARK.json", bench)
    return new


def copy_with_twin(dest):
    """``perfbench/`` and ``BENCHMARK.json`` copied to ``dest``, with the
    program's ``src`` linked beside them (``run.import_program`` wants
    the program inside the checkout), and the twin added."""
    shutil.copytree(load.HERE, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(load.ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    (dest / "src").symlink_to(load.ROOT / "src")
    return add_twin(dest)


def _flops(root):
    """The FLOPs ``window_numbers`` counts over two served batches of
    each of mamba2-2.7b.docs and twin.docs (tiny widths, one seed), in a
    process that imports the copy at ``root``."""
    code = f"""
import json, sys
sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]
from perfbench import load, yardstick
from perfbench.tests.conftest import SMALL_TRAFFIC, tiny
out = {{}}
for cell in ({SOURCE_CELL!r}, {CELL!r}):
    wl = dict(load.workload(cell), **SMALL_TRAFFIC)
    cfg = load.config(wl["config"])
    drv = load.loop(wl["loop"])
    c = drv.Cell(wl, cfg, {SEED}, "cpu",
                 shrink=dict(tiny(cfg["name"]), dtype="float32"))
    c.setup(trace=False)
    c.serve_batches(2)
    out[cell] = drv.window_numbers(dict(model=c.model, workload=c.wl,
                                        records=c.records))["flops"]
    c.close()
out["own"] = load.work({TWIN!r}) is not yardstick.request_flops
print(json.dumps(out))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_twin_joins_by_new_files_alone(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    new = copy_with_twin(root)
    assert all(p.is_file() for p in new)
    xml = tmp_path / "twin.xml"
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "-o", "markers=gpu: needs a CUDA card", "-k", f"{TWIN} or layout",
           "--ignore=perfbench/tests/test_perfbench_room.py",
           f"--junitxml={xml}", "perfbench/tests"]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                         cwd=root)
    cases = list(ET.parse(xml).getroot().iter("testcase"))
    twin = [c for c in cases if TWIN in c.get("name")]
    bad = [(c.get("classname"), c.get("name")) for c in cases
           if c.find("failure") is not None or c.find("error") is not None]
    skipped = [c.get("name") for c in cases if c.find("skipped") is not None]
    assert run.returncode == 0 and not bad, (bad, run.stdout[-4000:])
    # the card's tests skip on the CPU; every other test of the twin ran
    assert all(n.startswith("test_tiny_run_on_the_card") for n in skipped)
    assert len(twin) - len(skipped) >= 15, [c.get("name") for c in twin]

    flops = _flops(root)
    assert flops["own"] and flops[CELL] > 0
    assert flops[CELL] == flops[SOURCE_CELL]


def test_a_configuration_without_a_work_file_counts_with_the_yardstick():
    for c in load.benchmark()["configs"]:
        if not (load.HERE / "work" / f"{c['name']}.py").is_file():
            assert load.work(c["name"]) is yardstick.request_flops
    model = load.config(SOURCE)["model"]
    batch = type("B", (), dict(prompts=[[0] * 100, [0] * 7],
                               new_tokens=[3, 1]))
    res = [type("R", (), dict(tokens=[0] * 3)),
           type("R", (), dict(tokens=[0]))]
    ctx = dict(model=model, workload=dict(config=SOURCE),
               records=[dict(batch=batch, results=res, t0=0.0, t1=1.0)])
    got = lm_offline.window_numbers(ctx)
    assert got["flops"] == (yardstick.request_flops(model, 100, 3)
                            + yardstick.request_flops(model, 7, 1))
    assert (got["tokens"], got["attempted"], got["failed"]) == (111, 2, 0)
