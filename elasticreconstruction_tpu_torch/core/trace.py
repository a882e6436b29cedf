"""Named host spans and counters, recorded while a ``torch.profiler`` is recording.

``span(name)`` marks a phase of the host's work; ``count(name, n)`` adds to a
counter of the innermost open span. Tracing is on exactly while a profiler is
recording (``torch.profiler.profile``, the stage CLI's ``--profile``), and
there is no other switch:

- Off, ``span`` costs one check (``torch._C._autograd._profiler_enabled``) and
  returns a shared no-op context; ``count`` finds no open span and returns.
- On, a span opens the user-scope record function that
  ``torch.profiler.record_function(name)`` opens, so it lands in the
  profiler's own trace (a ``user_annotation`` event, and a
  ``gpu_user_annotation`` over the kernels it launched, when the profiler
  records CPU activity; under a CUDA-only profiler it records nothing), and
  it keeps a :class:`Span` record in this module's store: ``time.time_ns()``
  just before the annotation opens and just after it closes, on the
  Unix-epoch clock that kineto puts its events on; its parent; the outermost
  span it ran under (``root``); its counters. It calls the record function's
  own binding, not ``record_function``'s dispatcher op, whose profiled
  bookkeeping puts 70-100 us between the annotation's stamp and its caller on
  an H100's host.

A span measures host time. Device work it queued but did not wait for is paid
at the next host sync, inside whichever span makes it. Counters add Python
integers the host already holds and never read a device value. The store is
process-wide, like the profiler, and is read with :func:`records` and emptied
with :func:`clear`. Spans are opened by one thread, the one that drives the
stage.
"""

from __future__ import annotations

import contextlib
import itertools
import numbers
import time
from typing import NamedTuple

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
_annotation_enter = torch.autograd._record_function_with_args_enter
_annotation_exit = torch.autograd._record_function_with_args_exit


class Span(NamedTuple):
    """One closed span: times in epoch nanoseconds, ``parent`` None at a root."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    counters: dict[str, int]


_open: list[_Open] = []  # the spans open now, outermost first
_closed: list[Span] = []
_ids = itertools.count()
_OFF = contextlib.nullcontext()


class _Open:
    """A span while it is open: stamped, annotated and on the stack of open spans."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "counters", "_annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1].id if _open else None
        self.root = _open[0].id if _open else self.id
        self.counters = {}
        self.start_ns = time.time_ns()
        self._annotation = _annotation_enter(self.name)
        _open.append(self)
        return self

    def __exit__(self, *exc):
        _open.pop()
        _annotation_exit(self._annotation)
        end_ns = time.time_ns()
        _closed.append(Span(self.name, self.id, self.parent, self.root, self.start_ns, end_ns, self.counters))
        return False


def span(name: str):
    """A context that records the enclosed host work as span ``name`` while a profiler records."""
    return _Open(name) if _profiler_enabled() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (an integer the host holds) to counter ``name`` of the innermost open span, if any."""
    if type(n) is not int and not isinstance(n, numbers.Integral):  # a tensor would be read back: a host sync
        raise TypeError(f"a counter adds host integers, not {type(n).__name__}")
    if _open:
        c = _open[-1].counters
        c[name] = c.get(name, 0) + int(n)


def records() -> list[Span]:
    """The closed spans, in the order they opened."""
    return sorted(_closed, key=lambda s: s.id)


def clear() -> None:
    """Forget every closed span."""
    _closed.clear()


# The binding's first use builds its Python wrapper (about a millisecond): pay it here, not inside
# the first span a profiler records.
_annotation_exit(_annotation_enter("trace"))
