"""Meshes for the slot pool: ``n`` shards over a list of devices.

The port of ``repro.launch.mesh.make_host_mesh``.  The reference builds a
1-D ``jax`` mesh over host devices (emulated ones on the CPU); the port's
mesh is the ordered list of the devices its shards live on, with the
reference's ``"data"`` axis name.  One process drives every shard: the
engine (``serve.ts_engine.TimeSurfaceEngine(cfg, mesh=...)``) keeps each
shard's state in tensors of its own on its device and launches each
shard's kernels there, so no process group is needed.

When more shards are asked for than there are devices, the shards cycle
over the devices: two shards on one card each hold their own tensors and
run the same code a two-card host runs.  ``placement`` says where each
shard landed, and the CLIs print it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """A 1-D mesh over the ``"data"`` axis: shard ``k`` of the slot pool
    lives on ``devices[k]``."""

    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def placement(self) -> str:
        """Where each shard lives, e.g. ``shard 0 -> cuda:0, shard 1 ->
        cuda:0``."""
        return ", ".join(f"shard {k} -> {d}" for k, d in
                         enumerate(self.devices))


def _visible(device) -> Tuple[torch.device, ...]:
    """The devices a default mesh spreads over: every visible card for
    ``None`` or a bare ``"cuda"``, else the one device named."""
    if device is None or str(device) == "cuda":
        resolve_device(None)   # raises when there is no card
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (resolve_device(device),)


def make_host_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None,
                   device=None) -> HostMesh:
    """A 1-D mesh of ``n_devices`` shards over the ``"data"`` axis.

    ``devices`` lists the devices to spread over; by default every
    visible card (``device=None`` or ``"cuda"``), or the one device
    ``device`` names (``"cpu"``, ``"cuda:1"``).  ``n_devices=None`` takes
    one shard per listed device; more shards than devices cycle over
    them.
    """
    base = (_visible(device) if devices is None
            else tuple(resolve_device(d) for d in devices))
    if not base:
        raise ValueError("a mesh needs at least one device")
    n = len(base) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return HostMesh(tuple(base[k % len(base)] for k in range(n)))
