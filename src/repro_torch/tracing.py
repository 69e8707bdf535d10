"""Spans and counts on the LM serving path, kept in memory.

A span is one layer boundary crossed: a ``ServeEngine.serve`` call, its
prefill, each decode step and each copy of tokens to the host.  Its
record holds the name (every name starts with ``repro_torch.``),
``start_ns`` and ``end_ns`` from ``time.time_ns()`` -- the clock
``torch.profiler`` stamps its events with, so a span lines up with a
device trace of the same call -- its ``parent`` span's id, the ``call``
it belongs to (the id of its outermost span: one ``serve``), the
attributes given when it opened, and ``counts``, which the code that
opened it fills.

Tracing is off unless a ``torch.profiler`` session is running or the
code runs under ``on()``.  Off, ``span`` costs one check and returns a
shared null context, whose ``with ... as`` target is None: code counts
only under ``if span is not None``.  Under a profiler each span is also
a ``record_function`` range, so it shows in the profiler's own trace.
The newest ``MAX_SPANS`` records are kept; ``spans()`` returns them in
the order they opened.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, Optional

import torch

MAX_SPANS = 200_000

_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = threading.local()       # this thread's stack of open spans
_on_lock = threading.Lock()
_on = 0                         # depth of ``on()`` contexts, all threads
_NULL = contextlib.nullcontext()


class Span:
    """One span's record; a context manager that opens and closes it."""

    __slots__ = ("id", "name", "attrs", "counts", "parent", "call",
                 "start_ns", "end_ns", "_range")

    def __init__(self, name: str, attrs: dict, profiled: bool):
        self.id = next(_ids)
        self.name, self.attrs, self.counts = name, attrs, {}
        self.start_ns: int = 0
        self.end_ns: Optional[int] = None
        self._range = (torch.profiler.record_function(name) if profiled
                       else None)

    def __enter__(self) -> "Span":
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        self.call = top.call if top else self.id
        stack.append(self)
        _records.append(self)
        self.start_ns = time.time_ns()
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._range is not None:
            self._range.__exit__(*exc)
        self.end_ns = time.time_ns()
        _stack().pop()
        return False


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str, **attrs):
    """A context manager around one layer boundary: a ``Span`` when
    tracing is on, else a shared null context."""
    profiled = torch.autograd._profiler_enabled()
    if not (_on or profiled):
        return _NULL
    return Span(name, attrs, profiled)


@contextlib.contextmanager
def on():
    """Tracing on inside the ``with`` block, with no profiler running."""
    global _on
    with _on_lock:
        _on += 1
    try:
        yield
    finally:
        with _on_lock:
            _on -= 1


def spans() -> List[Span]:
    """The kept records, in the order their spans opened."""
    return list(_records)


def clear() -> None:
    _records.clear()


def call_at(t_ns: int, name: str) -> List[Span]:
    """The records of the newest call whose outermost span is named
    ``name`` and was open at ``t_ns`` (a profiler's clock reading), that
    span first; [] if there is none."""
    recs = spans()
    roots = [r for r in recs if r.id == r.call and r.name == name
             and r.end_ns is not None and r.start_ns <= t_ns <= r.end_ns]
    if not roots:
        return []
    return [r for r in recs if r.call == roots[-1].id]
