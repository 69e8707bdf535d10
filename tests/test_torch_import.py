"""repro_torch stands alone: it imports neither JAX nor the JAX package.

The port has to run on a machine without JAX or ``msgpack``, so ``import
repro_torch`` and every submodule (the checkpoint's manifest codec
included) must succeed with ``jax``, ``msgpack`` and the top-level
``repro`` package blocked, and no source line of the port or of
``chip_smoke.py`` may import any of them.
"""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = """
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro", "msgpack"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, %r)
import chip_smoke
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "repro", "msgpack")]
assert not leaked, leaked
missing = [m for m in %r if m not in names]
assert not missing, missing
print(len(names))
"""

#: modules the port must hold (every one is imported above, with the rest)
REQUIRED = (
    "repro_torch.device", "repro_torch.convert",
    "repro_torch.configs", "repro_torch.configs.base",
    "repro_torch.configs.mamba2_2p7b",
    "repro_torch.models", "repro_torch.models.module",
    "repro_torch.models.layers", "repro_torch.models.ssm",
    "repro_torch.models.transformer",
    "repro_torch.kernels.ops", "repro_torch.kernels.ref",
    "repro_torch.kernels.decay_scan", "repro_torch.kernels.ts_decay",
    "repro_torch.kernels.stcf", "repro_torch.kernels.ts_fused",
    "repro_torch.serve.engine", "repro_torch.serve.ts_engine",
    "repro_torch.serve.heads", "repro_torch.serve.spec",
    "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
    "repro_torch.checkpoint.manifest",
    "repro_torch.models.cnn", "repro_torch.models.frontends",
    "repro_torch.core.stcf", "repro_torch.core.representations",
    "repro_torch.core.time_surface",
    "repro_torch.launch", "repro_torch.launch.serve",
    "repro_torch.core.prng", "repro_torch.core.isc_array",
    "repro_torch.core.edram", "repro_torch.hw.energy_model",
    "repro_torch.serve.fidelity", "repro_torch.serve.stream",
    "repro_torch.events.replay",
    "repro_torch.distributed", "repro_torch.distributed.sharding",
    "repro_torch.launch.mesh",
)


def test_import_with_jax_and_repro_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT % (str(ROOT), REQUIRED)],
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 50   # every port module imported


_IMPORT_LINE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro|msgpack)\b")


def test_no_source_line_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [
        f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
        for f in files
        for i, line in enumerate(f.read_text().splitlines(), 1)
        if _IMPORT_LINE.match(line)
    ]
    assert not offenders, offenders
    assert _IMPORT_LINE.match("from repro.kernels import ops")
    assert _IMPORT_LINE.match("import jax.numpy as jnp")
    assert _IMPORT_LINE.match("import msgpack")
    assert not _IMPORT_LINE.match("from repro_torch.kernels import ops")
