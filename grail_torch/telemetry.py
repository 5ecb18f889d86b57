"""The port's spans: named, nested intervals of its own work, recorded only
while a torch profiler records (torch.profiler.profile, or emit_nvtx).

With no profiler recording, `span` returns one shared null context and
`spanned` calls straight through: nothing is constructed or recorded. While
one records, each span goes to two sinks: a `record_function("grail:<name>")`
range in the profiler's own trace, on the clock of the device activity it
issues, and an entry of the in-memory log SPANS (id, parent id, root id,
thread, start and end on the perf_counter_ns clock, and the lanes of a
wave where given). Spans nest per thread; every span of one request carries
the id of its root (`render` on a render, `megawave` on a training step).

Every call on the hot paths that makes the host wait for the device (a
read of a device value, a copy from the host's pageable memory to the
device) goes through `sync`, inside a `sync/<site>` span, so the wait is
timed where it happens.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

PREFIX = "grail:"

# the spans of the profiled work, oldest first (bounded: a long profile keeps
# its latest spans)
SPANS = collections.deque(maxlen=1 << 18)

_NULL = contextlib.nullcontext()
_IDS = itertools.count(1)
_LOCAL = threading.local()


class Span:
    """One recorded span: the context manager while open, the log's entry
    once closed (end set)."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start", "end", "lanes",
                 "_range")

    def __init__(self, name, lanes=None):
        self.name, self.lanes = name, lanes
        self.id = next(_IDS)
        self.thread = threading.get_ident()
        self.start = self.end = None

    def __enter__(self):
        stack = _LOCAL.__dict__.setdefault("stack", [])
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        self.root = self.id if top is None else top.root
        stack.append(self)
        self._range = record_function(PREFIX + self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        self._range = None
        _LOCAL.stack.pop()
        SPANS.append(self)
        return False


def span(name, lanes=None):
    """A context manager: the span `name` while a profiler records, else a
    shared null context."""
    if not _profiler_enabled():
        return _NULL
    return Span(name, lanes)


def spanned(name):
    """Decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def sync(site, fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, a call that makes the host wait for the device,
    inside the span `sync/<site>`."""
    with span("sync/" + site):
        return fn(*args, **kwargs)


def reset():
    """Empty the log."""
    SPANS.clear()
