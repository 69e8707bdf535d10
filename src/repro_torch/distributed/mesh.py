"""The process mesh that the LM's parameters are sharded over.

A ``ProcessMesh`` is the world of ``torch.distributed`` laid row-major
over named axes, with the process group of every set of axes.  The
sharding rules, the model and the trainer read it; the launcher builds
it (``launch.mesh.make_test_mesh`` / ``make_production_mesh``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class ProcessMesh:
    """A mesh of the processes of a ``torch.distributed`` world: rank
    ``r`` sits at the row-major coordinates of ``r`` over ``axes`` (sizes
    ``dims``) and works on ``device``.  ``groups`` holds the process
    group of every non-empty set of axes (keyed by the axes in mesh
    order) that holds this rank: the ranks that share its coordinates on
    the other axes, whose group ranks run row-major over the set's
    axes."""

    axes: Tuple[str, ...]
    dims: Tuple[int, ...]
    rank: int
    device: torch.device
    groups: Dict[Tuple[str, ...], object]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis."""
        out, r = {}, self.rank
        for a, n in reversed(list(zip(self.axes, self.dims))):
            out[a], r = r % n, r // n
        return {a: out[a] for a in self.axes}

    def ordered(self, axes) -> Tuple[str, ...]:
        """``axes`` in mesh order, those of size 1 left out: the axes a
        collective over ``axes`` really spans."""
        axes = {axes} if isinstance(axes, str) else set(axes)
        unknown = axes - set(self.axes)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in the mesh "
                             f"{self.shape}")
        return tuple(a for a in self.axes if a in axes
                     and self.shape[a] > 1)

    def count(self, axes) -> int:
        """How many ranks the axes span together."""
        return math.prod(self.shape[a] for a in self.ordered(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (in the order given,
        as a ``PartitionSpec`` entry lists them)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i, c = 0, self.coords
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def group(self, axes):
        """The process group over ``axes``; None when they span one
        rank (every collective over them is the identity)."""
        key = self.ordered(axes)
        return self.groups[key] if key else None

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(**_device_ids(self.device))


def _device_ids(device: torch.device) -> dict:
    return {"device_ids": [device.index]} if device.type == "cuda" else {}


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is None or a ``ProcessMesh``."""
    if mesh is not None and not isinstance(mesh, ProcessMesh):
        raise TypeError(f"mesh must be a ProcessMesh (launch.mesh."
                        f"make_test_mesh), not {type(mesh).__name__}")
