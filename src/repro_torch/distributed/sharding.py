"""Slot-pool placement rules: how the time-surface engine's pool splits
over the shards of a mesh (``launch.mesh.make_host_mesh``).

The port of the slot-pool half of ``repro.distributed.sharding``.  A
mesh here is a list of devices with one ``"data"`` axis; the pool's slot
axis splits into contiguous blocks, one per shard, and every other axis
stays whole.  Where the reference hands ``shard_map`` a
``PartitionSpec``, the port hands the engine the ordered list of shard
devices (``slot_pool_devices``): shard ``k`` owns global slots
``[k * slots_per_shard, (k + 1) * slots_per_shard)`` and keeps its rows
in tensors of its own on ``slot_pool_devices(mesh)[k]``.

The model-sharding rules of the reference (``logical_rules``,
``param_shardings``, ``batch_spec``, ``cache_seq_axes``) wait for the
training substrate (ROADMAP queue 1 item 6).
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's axes the slot pool splits over."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def slot_shard_count(mesh) -> int:
    """How many ways the engine's slot pool splits: the product of the
    mesh's data axes."""
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return max(n, 1)


def pad_pool(n_slots: int, mesh) -> int:
    """Smallest pool size >= ``n_slots`` divisible by the shard count.

    A pool that does not divide is padded: the engine never hands out
    the dead tail slots, and they read as never-written.  Elastic pools
    grow and shrink in buckets padded by this same rule, so every
    capacity splits evenly.
    """
    n = slot_shard_count(mesh)
    return -(-n_slots // n) * n


def shard_of(slot: int, slots_per_shard: int) -> int:
    """The shard owning a global slot index (contiguous blocks).  The
    multi-shard EDF scheduler budgets per shard with this."""
    return slot // slots_per_shard


def slot_pool_devices(mesh) -> List[torch.device]:
    """The device of each shard of the slot pool, in shard order: the
    counterpart of the reference's ``slot_pool_sharding`` /
    ``slot_pool_spec`` / ``slot_pool_out_specs``.  Every leaf of the
    engine state and every pool-level product splits the same way, so
    one list places all of them."""
    devices = [torch.device(d) for d in mesh.devices]
    if len(devices) != slot_shard_count(mesh):
        raise ValueError(f"mesh lists {len(devices)} devices for "
                         f"{slot_shard_count(mesh)} shards")
    return devices
