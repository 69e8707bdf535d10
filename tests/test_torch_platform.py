"""The port's ``platform`` against the reference's, on the CPU, and the
two packages' module lists.

``set_platform`` maps the reference's platform pin onto a device (``tpu``
and contradictions refused), ``enable_x64(True)`` is refused for the
float32 reason the launchers give, ``debug_nans`` toggles autograd's
anomaly detection, and ``describe`` reports the device, the card count,
the versions and the kernel route.  The reference's XLA flag functions
and ``repro.compat`` have no counterpart, for the reasons the port's
module docstring states: this file holds both facts.
"""
import pathlib

import pytest
import torch

from repro import platform as ref_pf
from repro_torch import platform as pf

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the reference's names with no counterpart: XLA flags, set before jax's
#: backend starts; a CPU mesh of the port is a gloo world of processes
XLA_ONLY = {"GPU_XLA_FLAGS", "HOST_DEVICE_COUNT_FLAG", "merge_xla_flags",
            "set_host_device_count", "ensure_host_device_count"}


def test_names_are_the_reference_s_but_the_xla_flags():
    assert set(pf.__all__) == set(ref_pf.__all__) - XLA_ONLY
    assert pf.PLATFORMS == tuple(p for p in ref_pf.PLATFORMS if p != "tpu")
    for name in XLA_ONLY:
        assert name in pf.__doc__ and not hasattr(pf, name)


@pytest.mark.parametrize("platform,device,want", [
    (None, None, None), (None, "cpu", "cpu"), (None, "cuda:1", "cuda:1"),
    ("cpu", None, "cpu"), ("cpu", "cpu", "cpu"),
    ("gpu", None, None), ("gpu", "cuda:0", "cuda:0"),
])
def test_set_platform_maps_onto_the_device(platform, device, want):
    assert pf.set_platform(platform, device) == want


@pytest.mark.parametrize("platform,device,words", [
    ("tpu", None, "tpu is refused"), ("quantum", None, "unknown platform"),
    ("gpu", "cpu", "contradicts"), ("cpu", "cuda:0", "contradicts"),
])
def test_set_platform_refuses(platform, device, words):
    with pytest.raises(ValueError, match=words):
        pf.set_platform(platform, device)


def test_x64_is_refused_for_the_float32_reason():
    with pytest.raises(ValueError, match="float32 end to end"):
        pf.enable_x64(True)
    pf.enable_x64(False)


def test_debug_nans_toggles_anomaly_detection():
    before = torch.is_anomaly_enabled()
    try:
        pf.debug_nans(True)
        assert torch.is_anomaly_enabled()
        pf.debug_nans(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_describe_reports_the_process():
    d = pf.describe()
    card = torch.cuda.is_available()
    assert d["torch"] == torch.__version__ and d["cuda"] == torch.version.cuda
    assert d["x64"] is False
    assert d["kernel_route"] == ("cuda" if card else "plain")
    assert d["n_devices"] == (torch.cuda.device_count() if card else 1)
    assert d["device"].startswith("cuda" if card else "cpu")


def _modules(pkg: str):
    base = ROOT / "src" / pkg
    return {p.relative_to(base).as_posix() for p in base.rglob("*.py")}


def test_every_reference_module_has_a_counterpart_but_compat():
    """``compat.py`` holds shims over jax APIs (``optimization_barrier``,
    ``shard_map``); the port calls its collectives explicitly and runs
    eagerly, so it needs neither (``repro_torch.platform``'s docstring)."""
    missing = _modules("repro") - _modules("repro_torch")
    assert missing == {"compat.py"}, missing
    assert "repro.compat" in pf.__doc__
