"""Spans and counters inside the port: where a request's time goes.

Off unless a caller turns it on for a block with `recording()`.  Off,
`span` returns one shared no-op context manager and `count` returns at
once: no record, no host read, no device work.  On, every span keeps its
name, its start and end on ``time.perf_counter_ns()``, its own id, the id of
the span that opened it (``parent``), the id of its request (the outermost
open span) and its attributes.  While a torch.profiler trace is active, a
recorded span also enters ``torch.profiler.record_function`` of its name, so
the trace holds it as a host event on the profiler's clock, beside the
card's kernels.

Counters (`count`) are summed per request where their values live (a
tensor's sum stays on its device) and read once, when the request's root
span closes: its record carries them under ``counters``.

Spans nest by a stack; the port runs one thread per process.

    with spans.recording() as records:
        sweep(...)
    # records: one dict per span, children before their parents
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

_rec = None  # the open `_Recording`; None while recording is off


class _Recording:
    def __init__(self):
        self.records = []  # closed spans
        self.stack = []  # open spans, the request's root first
        self.counters = {}  # the open request's
        self.ids = 0


class _Off:
    """The shared span of recording off.  Falsy, so that ``if sp:`` guards
    work done only for a record."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    """A span that always times itself (`seconds`) and is recorded where
    ``rec`` is a recording."""

    def __init__(self, rec, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self._annotation = None

    def __bool__(self):
        return self.rec is not None

    def set(self, **attrs):
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            rec.ids += 1
            self.id = rec.ids
            self.parent = rec.stack[-1].id if rec.stack else None
            self.request = rec.stack[0].id if rec.stack else self.id
            rec.stack.append(self)
            if torch._C._autograd._profiler_enabled():
                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        rec = self.rec
        if rec is None:
            return False
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        rec.stack.pop()
        out = dict(name=self.name, start=self.start, end=self.end, id=self.id,
                   parent=self.parent, request=self.request, attrs=self.attrs)
        if not rec.stack and rec.counters:  # the request's one read of its counters
            out["counters"] = {k: v.item() if torch.is_tensor(v) else v
                               for k, v in rec.counters.items()}
            rec.counters = {}
        rec.records.append(out)
        return False


def span(name: str, **attrs):
    """A span of ``name`` around a block; the shared no-op while recording
    is off."""
    if _rec is None:
        return _OFF
    return _Span(_rec, name, attrs)


def timed(name: str, **attrs):
    """`span`, timed also while recording is off: for a caller that prints
    the block's `seconds`."""
    return _Span(_rec, name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is a span of ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _rec is None:
                return fn(*args, **kwargs)
            with _Span(_rec, name, {}):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor whose sum is added on its device)
    to the open request's counter ``name``.  Nothing outside a recorded
    span."""
    rec = _rec
    if rec is None or not rec.stack:
        return
    if torch.is_tensor(value):
        value = value.sum()
    c = rec.counters
    c[name] = c[name] + value if name in c else value


@contextlib.contextmanager
def recording():
    """Record every span and counter of the block; yields the list of
    records, filled as spans close."""
    global _rec
    prev, _rec = _rec, _Recording()
    try:
        yield _rec.records
    finally:
        _rec = prev
