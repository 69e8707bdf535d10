"""Meshes: the slot pool's shards over a list of devices, and the
process meshes that the LM trainer shards its model over.

``make_host_mesh`` is the port of ``repro.launch.mesh.make_host_mesh``.  The reference builds a
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

``make_test_mesh`` and ``make_production_mesh`` are the ports of the
reference's meshes for the model: one process per device, as PyTorch
shards a model.  Every process of a ``torch.distributed`` world builds
the same ``ProcessMesh``: the world's ranks laid out row-major over the
named axes (the last axis varies fastest), the process group of every
set of axes, and this rank's device.  ``.shape`` is the reference's
``{axis: size}`` dict, so the sharding rules read a ``ProcessMesh`` as
they read a ``jax`` mesh.  The process group comes from the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``, as ``torchrun`` sets them) unless the caller has
initialized it (a ``file://`` store, as the tests do): NCCL on the
cards, gloo on the CPU.  On the ``meta`` device the mesh is one rank of
a ``"fake"`` world that the dry run starts (``launch.dryrun.fake_world``):
every collective returns at once on meta tensors, so a production mesh
of 256 or 512 ranks fits in one process.  The reference's
``ensure_host_device_count`` asks XLA for emulated host devices and has
no counterpart: a CPU mesh of the port is a gloo world of CPU processes.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import ProcessMesh


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


# ------------------------------------------------------- process meshes

def _local_device(device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` by default (raising when
    there is no card), else the one ``device`` names."""
    if device is None or str(device) == "cuda":
        resolve_device(None)   # raises when there is no card
        local = int(os.environ.get("LOCAL_RANK", 0))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but only "
                               f"{torch.cuda.device_count()} cards are "
                               "visible")
        return torch.device("cuda", local)
    return resolve_device(device)


def _process_mesh(shape: Sequence[int], axes: Sequence[str],
                  device) -> ProcessMesh:
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not pair")
    dev = _local_device(device)
    backend = {"cuda": "nccl", "meta": "fake"}.get(dev.type, "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        if backend == "fake":
            raise RuntimeError("a mesh on meta tensors is one rank of a fake "
                               "world: start it with launch.dryrun."
                               "fake_world(world_size, rank)")
        dist.init_process_group(backend, init_method="env://",
                                **({"device_id": dev}
                                   if dev.type == "cuda" else {}))
    elif dist.get_backend() != backend:
        raise RuntimeError(f"a mesh on {dev} needs a {backend} world; this "
                           f"one runs {dist.get_backend()}")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; this world has {world}")
    # every rank creates every group, in one order
    groups: Dict[Tuple[str, ...], object] = {}
    coords = [dict(zip(axes, c)) for c in
              itertools.product(*(range(n) for n in shape))]
    mine = coords[rank]
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(axes, k):
            if math.prod(shape[axes.index(a)] for a in sub) == 1:
                continue
            sub = tuple(a for a in axes if a in sub and
                        shape[axes.index(a)] > 1)
            if sub in groups:
                continue
            rest = [a for a in axes if a not in sub]
            for fixed in itertools.product(
                    *(range(shape[axes.index(a)]) for a in rest)):
                ranks = [r for r, c in enumerate(coords)
                         if all(c[a] == f for a, f in zip(rest, fixed))]
                g = dist.new_group(ranks)
                if all(mine[a] == f for a, f in zip(rest, fixed)):
                    groups[sub] = g
    return ProcessMesh(axes, shape, rank, dev, groups)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device=None) -> ProcessMesh:
    """A mesh of ``shape`` over ``axes`` on this world's ranks, each on
    ``device`` (default: ``cuda:LOCAL_RANK``; ``"cpu"`` for a gloo
    world of CPU processes).  The world must hold ``prod(shape)``
    ranks."""
    return _process_mesh(shape, axes, device)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> ProcessMesh:
    """The reference's production mesh: 16x16 ("data", "model"), or
    2x16x16 ("pod", "data", "model") with ``multi_pod``.  Raises, naming
    the 256 or 512 ranks it needs, when the world is another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if world != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {need} "
            f"ranks (torchrun over {need} cards); this world has {world}")
    return _process_mesh(shape, axes, device)
