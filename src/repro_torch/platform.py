"""Process-level platform settings of the port.

The port of ``repro.platform``.  ``set_platform`` maps the reference's
platform pin onto the device an entry point runs on, as the launchers'
``--platform`` does (``launch.serve``, ``launch.train``): ``"gpu"`` is
the CUDA device, ``"cpu"`` the CPU's plain PyTorch versions, and
``"tpu"`` is refused.  ``enable_x64(True)`` is refused: the port is
float32 end to end, as the reference's serving stack is (its flag is for
offline analysis).  ``debug_nans`` turns on autograd's anomaly detection,
the nearest PyTorch has to jax's NaN debugging.  ``describe`` is a
summary for launch banners and logs.

What has no counterpart, and why:

* ``merge_xla_flags``, ``GPU_XLA_FLAGS``, ``HOST_DEVICE_COUNT_FLAG``,
  ``set_host_device_count`` and ``ensure_host_device_count`` set XLA's
  flags before jax's backend starts.  PyTorch reads no such flags, and a
  CPU mesh of the port is a gloo world of CPU processes
  (``launch.mesh.make_test_mesh(device="cpu")``), not emulated host
  devices.
* ``repro.compat`` (``optimization_barrier``, ``shard_map``) holds shims
  over jax APIs that moved between jax versions.  The port calls its
  collectives explicitly (``distributed.sharding``) and schedules
  eagerly, so it needs neither, and there is no ``repro_torch.compat``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["PLATFORMS", "set_platform", "enable_x64", "debug_nans",
           "describe"]

#: the platforms ``set_platform`` accepts (None = the default device)
PLATFORMS = ("cpu", "gpu")

_DEVICE_TYPE = {"gpu": "cuda", "cpu": "cpu"}


def set_platform(platform: Optional[str], device=None):
    """The device to run on under the reference's platform pin: ``device``
    as given for ``None``; for ``"gpu"`` the CUDA device (``device``, or
    None for the current card), for ``"cpu"`` the CPU.  Raises
    ``ValueError`` for ``"tpu"`` or any other name, and where ``device``
    contradicts the platform."""
    if platform is None:
        return device
    if platform not in PLATFORMS:
        raise ValueError(
            f"unknown platform {platform!r}; expected one of {PLATFORMS} or "
            "None (the port runs on the CUDA device or the CPU; tpu is "
            "refused)")
    want = _DEVICE_TYPE[platform]
    if device is not None and torch.device(device).type != want:
        raise ValueError(f"platform {platform} contradicts device {device}")
    return "cpu" if want == "cpu" else device


def enable_x64(use_x64: bool = True) -> None:
    """Refused for ``True``: the port is float32 end to end (the SAE
    stores float32 offsets, and the LM stack float32 masters); ``False``
    is what it always runs."""
    if use_x64:
        raise ValueError("x64 is refused: the port is float32 end to end "
                         "(the reference's flag is for offline analysis)")


def debug_nans(flag: bool = True) -> None:
    """Toggle autograd's anomaly detection, which raises at the op whose
    backward produced a NaN (slow; never in the serving hot path)."""
    torch.autograd.set_detect_anomaly(bool(flag))


def describe() -> Dict[str, object]:
    """One-line process platform summary for launch banners and logs:
    the default device, the card count, the torch and CUDA versions and
    the kernel route (``"cuda"``: the hand-written kernels on a card;
    ``"plain"``: their PyTorch versions on the CPU)."""
    card = torch.cuda.is_available()
    return {
        "device": (f"cuda:{torch.cuda.current_device()}" if card else "cpu"),
        "device_name": torch.cuda.get_device_name(0) if card else "cpu",
        "n_devices": torch.cuda.device_count() if card else 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "x64": False,
        "kernel_route": "cuda" if card else "plain",
    }
