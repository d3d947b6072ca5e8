"""Spans of the port's host work, on the profiler's timeline.

``span(name, n)`` marks one stretch of host work as ``ttamm.<name>``::

    with trace.span("search", n=len(queries)) as root:
        with trace.span("search.prepare"):
            ...

While no ``torch.profiler`` session is recording, a span is one flag check
(``torch.autograd._profiler_enabled()``) and a shared no-op context: no
``record_function``, no record, no host sync. While one records (the
profiler's active steps; not its warm-up), a span opens
``torch.profiler.record_function("ttamm.<name>")``, so it lands on the same
timeline as the kernels in any trace the session writes. The flag is the
calling thread's: a profiler records the thread that started it, and spans
follow it (under ``profile_all_threads`` the flag reads false, and spans
stay off). ``n`` counts the work done under the span (queries, steps,
replays, chunks); a span that learns its count late sets ``.n`` on the
object the ``with`` gives (a no-op while nothing records).

The program keeps no record of its spans. A caller that reads them, such
as a benchmark around its traced part, calls :func:`collect` first and
:func:`clear` when done: in between, each span that closes under a
recording profiler also appends a :class:`Record` to the list that
:func:`records` returns, at most ``cap`` of them (:func:`dropped` counts
the rest). A record's stamps are on the profiler's own clock, the one
kineto's events read (``start_ns()``): Unix-epoch nanoseconds, which
``time.time_ns()`` gives. A span's parent is the innermost span open in the
same thread, so concurrent requests of the threaded HTTP server keep their
trees apart; every span of one call shares its root's id, which serves as
the call's identifier.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

PREFIX = "ttamm."
CAP = 1_000_000

clock_ns = time.time_ns  # the profiler's clock (kineto's start_ns())
_recording = torch.autograd._profiler_enabled


class Record(NamedTuple):
    """One closed span: ``parent_id`` is None for a root, whose
    ``root_id`` is its own ``id``."""

    id: int
    root_id: int
    parent_id: int | None
    name: str
    start_ns: int
    end_ns: int
    n: int

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Kept:
    """A collection's records, at most ``cap``, and the count dropped."""

    def __init__(self, cap: int):
        self.cap, self.records, self.dropped = cap, [], 0
        self.lock = threading.Lock()

    def add(self, record: Record) -> None:
        with self.lock:
            if len(self.records) < self.cap:
                self.records.append(record)
            else:
                self.dropped += 1


_kept: _Kept | None = None  # while a caller collects
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span while no profiler records."""

    __slots__ = ()
    n = property(lambda self: 0, lambda self, value: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "n", "_fn", "_kept", "_ids", "_start")

    def __init__(self, name: str, n: int):
        self.name, self.n = name, n

    def __enter__(self):
        self._kept = _kept
        if self._kept is not None:
            stack = getattr(_local, "stack", None)
            if stack is None:
                stack = _local.stack = []
            own = next(_ids)
            # (id, root id, parent id); the root's own id for a root
            self._ids = (own, stack[-1][1], stack[-1][0]) if stack else (own, own, None)
            stack.append(self._ids)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self._start = clock_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = clock_ns()
        self._fn.__exit__(*exc)
        if self._kept is not None:
            _local.stack.pop()
            self._kept.add(Record(*self._ids, self.name, self._start, end, self.n))
        return False


def span(name: str, n: int = 1):
    """The context of the span ``ttamm.<name>`` covering ``n`` units of
    work; a shared no-op unless a profiler is recording."""
    if not _recording():
        return _OFF
    return _Span(PREFIX + name, n)


def collect(cap: int = CAP) -> None:
    """Keep the record of every span that closes from now on, at most
    ``cap`` of them, in place of any kept so far."""
    global _kept
    _kept = _Kept(cap)


def clear() -> None:
    """Stop keeping records, and drop those kept."""
    global _kept
    _kept = None


def records() -> list[Record]:
    """The closed spans kept since :func:`collect`, in the order they
    closed (none while nothing collects)."""
    kept = _kept
    if kept is None:
        return []
    with kept.lock:
        return list(kept.records)


def dropped() -> int:
    """Records not kept because the collection held its cap."""
    kept = _kept
    return 0 if kept is None else kept.dropped
