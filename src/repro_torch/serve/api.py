"""Sensor sessions: the handle a connected sensor holds on the engine.

The port of ``repro.serve.api``.  ``engine.attach()`` returns a
``SensorSession`` owning one slot of the pool for its lifetime
(acquire-on-attach, wipe-on-detach)::

    session = engine.attach()
    session.push(aer_words)                          # scatter events
    support, is_signal = session.push_labeled(words) # scatter + STCF labels
    out = session.read(spec, t_now)                  # products, this sensor
    out = session.push_and_read(burst, spec, t_now)  # cache-backed read
    session.detach()                                 # slot wiped + reusable

Reads are per-sensor views of the engine's pool-wide read.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.serve import spec as spec_mod


class SensorSession:
    """One sensor's lease on an engine slot (create via ``engine.attach``).

    All methods raise ``RuntimeError`` after ``detach()``: a detached
    session's slot may already belong to a new sensor.
    """

    def __init__(self, engine, slot: int):
        self._engine = engine
        self._slot = slot
        self._alive = True

    @property
    def slot(self) -> int:
        """The pool slot this session owns (stable until ``detach``)."""
        return self._slot

    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def generation(self) -> int:
        """The slot's acquire generation (bumps each time it is reused)."""
        return int(self._engine.state.generation[self._slot])

    def detach(self) -> None:
        """Release the slot back to the pool, wiping its surface and its
        readout-cache row."""
        self._check()
        self._engine._detach(self._slot)
        self._alive = False

    def __enter__(self) -> "SensorSession":
        return self

    def __exit__(self, *exc) -> None:
        if self._alive:
            self.detach()

    def __repr__(self) -> str:
        state = "live" if self._alive else "detached"
        return f"SensorSession(slot={self._slot}, {state})"

    def _check(self) -> None:
        if not self._alive:
            raise RuntimeError(f"session on slot {self._slot} is detached")

    def push(self, payload) -> None:
        """Scatter one payload (packed uint64 AER words, a host
        ``EventStream``, or a pre-padded ``EventBatch``) into this
        sensor's surface."""
        self._check()
        self._engine.push([(self._slot, payload)])

    def push_labeled(self, payload) -> Tuple[torch.Tensor, torch.Tensor]:
        """Push and label: ``(support, is_signal)`` per valid event, the
        STCF denoise verdicts of this payload against the surface as it
        stood when each chunk landed (the offline ``stcf_chunked`` at
        ``chunk = chunk_capacity``), on the engine's device."""
        self._check()
        (sup, sig), = self._engine._ingest_labeled([(self._slot, payload)])
        return sup, sig

    def read(self, spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
             t_now: float = 0.0) -> Dict[str, torch.Tensor]:
        """This sensor's products at ``t_now`` (a view of the pool read)."""
        self._check()
        pool = self._engine.read(spec, t_now)
        return {name: v[self._slot] for name, v in pool.items()}

    def push_and_read(self, payload,
                      spec: spec_mod.ReadoutSpec = spec_mod.SURFACE_SPEC,
                      t_now: float = 0.0) -> Dict[str, torch.Tensor]:
        """Push, then serve ``spec`` with the surface product backed by
        the engine's dirty-tile cache.  ``payload`` may be ``None`` for a
        pure cached read."""
        self._check()
        items = [] if payload is None else [(self._slot, payload)]
        pool = self._engine.serve_step(items, spec, t_now)
        return {name: v[self._slot] for name, v in pool.items()}


def attach_many(engine, n: int) -> Tuple[SensorSession, ...]:
    """Attach ``n`` sessions at once (the multi-camera setup helper)."""
    return tuple(engine.attach() for _ in range(n))


def pool_items(pairs) -> list:
    """Normalize ``(session, payload)`` pairs to the engine's item list."""
    items = []
    for session, payload in pairs:
        session._check()
        items.append((session.slot, payload))
    return items
