"""Spans and counters at the port's layer boundaries, on the clock of the
device trace.

    from sbmc_tpu_torch import tracing
    with tracing.span("sbmc.forward", x):    # x: a tensor or a device
        with tracing.span("sbmc.splat"):     # the parent's device
            ...
    with tracing.span("denoise.to_device", x):
        tracing.count("h2d_bytes", n)        # into the innermost open span
    tracing.calls("sbmc.forward")            # the recorded instances

Tracing is on exactly while a ``torch.profiler`` records (the benchmark's
traced stretches, ``denoise --trace``, ``python -m
sbmc_tpu_torch.profile``); nothing else turns it on. Off, :func:`span`
returns one shared no-op context and :func:`count` returns at once: one
read of the profiler's process-wide flag, no allocation, no CUDA call.

On, a span is a ``torch.profiler.record_function`` range, so it lies in
the profiler's host timeline, on the clock kineto puts the device's kernels
on. On a CUDA device it also records a timing event on the device's current
stream at entry and at exit (events are pooled); the time between them is
the span's device time. A span's parent is the innermost span open on the
same thread, so the autograd engine's threads and background feeders keep
stacks of their own. :func:`count` adds to the innermost open span's
counters.

Finished top-level spans stay in memory (at most :data:`MAX_CALLS`, the
oldest dropped) until :func:`calls` reads them, resolving their events with
one synchronisation; :func:`reset` empties the store.
"""

import collections
import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler

__all__ = ["MAX_CALLS", "Call", "Stage", "span", "count", "calls", "reset",
           "enabled"]

#: Top-level calls the store keeps; a longer profiled run drops the oldest.
MAX_CALLS = 4096

_OFF = contextlib.nullcontext()
_local = threading.local()


def enabled():
    """Whether a ``torch.profiler`` records now: the flag torch sets for the
    whole process while one does (its C++ state is the recording thread's
    own, so a span on another thread would miss it)."""
    return _profiler._is_profiler_enabled


class Stage:
    """The instances of one span name below a call, summed: ``calls``,
    ``host_ms``, ``device_ms`` and ``counters``."""

    __slots__ = ("calls", "host_ms", "device_ms", "counters")

    def __init__(self):
        self.calls, self.host_ms, self.device_ms = 0, 0.0, 0.0
        self.counters = {}


def _add(into, counters):
    for k, v in counters.items():
        into[k] = into.get(k, 0) + v


class Call:
    """One finished span: ``name``, ``host_ms``, ``device_ms`` (between its
    two events; its host ms where it ran on no CUDA device), ``counters``
    (its own and those of every span below it) and ``children`` (the spans
    opened directly inside it, in order). ``below`` maps each span name at
    any depth below it to a :class:`Stage`."""

    __slots__ = ("name", "host_ms", "device_ms", "counters", "children",
                 "_below")

    def __init__(self, name, host_ms, device_ms, counters, children):
        self.name, self.host_ms, self.device_ms = name, host_ms, device_ms
        self.counters, self.children = counters, children
        self._below = None

    @property
    def below(self):
        if self._below is None:
            below = {}
            for c in self.walk():
                if c is self:
                    continue
                s = below.setdefault(c.name, Stage())
                s.calls += 1
                s.host_ms += c.host_ms
                s.device_ms += c.device_ms
                _add(s.counters, c.counters)
            self._below = below
        return self._below

    def walk(self):
        """This call and every call below it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()

    def __repr__(self):
        return "Call(%r, host_ms=%.4f, device_ms=%.4f, counters=%r, " \
            "children=%d)" % (self.name, self.host_ms, self.device_ms,
                              self.counters, len(self.children))


class _Events:
    """Timing events by device index, reused once their span is read."""

    def __init__(self):
        self._free = collections.defaultdict(list)

    def take(self, index):
        try:
            return self._free[index].pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def give(self, index, *events):
        self._free[index].extend(events)


class _Span:
    __slots__ = ("name", "device", "parent", "children", "counters", "t0",
                 "t1", "events", "range")

    def __init__(self, name, device):
        self.name, self.device = name, device
        self.children, self.counters, self.events = [], {}, None

    def __enter__(self):
        # The range opens first and closes last, so the host timeline puts
        # the span's own bookkeeping inside it.
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack = _stack()
        self.parent = stack[-1] if stack else None
        dev = self.device
        if dev is None:
            dev = self.parent.device if self.parent is not None else None
        elif isinstance(dev, torch.Tensor):
            dev = dev.device
        elif not isinstance(dev, torch.device):
            dev = torch.device(dev)
        self.device = dev
        if dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = _EVENTS.take(stream.device_index)
            start.record(stream)
            self.events = (stream, start)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            stream, start = self.events
            end = _EVENTS.take(stream.device_index)
            end.record(stream)
            self.events = (stream.device_index, start, end)
        _stack().pop()
        if self.parent is not None:
            self.parent.children.append(self)
        else:
            _STORE.add(self)
        self.range.__exit__(*exc)
        return False

    def resolve(self):
        """The :class:`Call` of this span (its events already reached)."""
        children = [c.resolve() for c in self.children]
        host_ms = (self.t1 - self.t0) * 1e-6
        device_ms = host_ms
        if self.events is not None:
            index, start, end = self.events
            device_ms = start.elapsed_time(end)
            _EVENTS.give(index, start, end)
        counters = dict(self.counters)
        for c in children:
            _add(counters, c.counters)
        return Call(self.name, host_ms, device_ms, counters, children)

    def devices(self):
        out = {self.events[0]} if self.events is not None else set()
        for c in self.children:
            out |= c.devices()
        return out


class _Store:
    """Finished top-level spans, in the order they ended."""

    def __init__(self, cap):
        self._lock = threading.Lock()
        self._calls = collections.deque()
        self._cap = cap

    def add(self, span):
        with self._lock:
            self._calls.append(span)
            while len(self._calls) > self._cap:
                dropped = self._calls.popleft()
                if isinstance(dropped, _Span):
                    _recycle(dropped)

    def read(self):
        with self._lock:
            raw = [s for s in self._calls if isinstance(s, _Span)]
            if raw:
                for index in set().union(*(s.devices() for s in raw)):
                    torch.cuda.synchronize(index)
                done = {id(s): s.resolve() for s in raw}
                self._calls = collections.deque(
                    done.get(id(s), s) for s in self._calls)
            return list(self._calls)

    def clear(self):
        with self._lock:
            for s in self._calls:
                if isinstance(s, _Span):
                    _recycle(s)
            self._calls.clear()


def _recycle(span):
    if span.events is not None:
        _EVENTS.give(*span.events)
    for c in span.children:
        _recycle(c)


_EVENTS = _Events()
_STORE = _Store(MAX_CALLS)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name, device=None):
    """A context manager: the span ``name`` while tracing is on (see the
    module), else the shared no-op context. ``device`` (a tensor, a device
    or its name) says where its device time is taken; None takes the
    parent span's."""
    if not enabled():
        return _OFF
    return _Span(name, device)


def count(name, n=1):
    """Add ``n`` to counter ``name`` of the innermost open span on this
    thread, while tracing is on."""
    if not enabled():
        return
    stack = getattr(_local, "stack", None)
    if stack:
        counters = stack[-1].counters
        counters[name] = counters.get(name, 0) + n


def calls(name=None):
    """The recorded instances of span ``name`` at any depth, in the order
    they began within each top-level call (the top-level calls in the order
    they ended); with no name, the top-level calls."""
    top = _STORE.read()
    if name is None:
        return top
    return [c for t in top for c in t.walk() if c.name == name]


def reset():
    """Empty the store."""
    _STORE.clear()
