"""Tracing: the port's recorder (the JAX package's ``utils/profiling.py``
has a phase timer and trace annotations in its place).

  * :func:`span` - a named span at a layer boundary: start and end on both
    host clocks (wall and monotonic, ns), the enclosing span of the same
    thread, a request id (the volume served, the trainer step) and the
    thread; with ``device=True`` also two CUDA events on the current
    stream, read as :attr:`Span.device_ms`
  * :func:`count` - named counters: :func:`launched` counts each kernel
    launch as ``kernels.launches.<kernel>``, recording or not;
    :func:`launch_clock` / :func:`launch_timed` add each launch's host time
    while recording
  * :func:`recorded` - the spans and counters so far, read without
    clearing them and without waiting for the device
  * :func:`trace` - a ``torch.profiler`` trace of the block, written as a
    Chrome trace (``chrome://tracing``, Perfetto) into ``log_dir``, the
    recorder's spans in it on the profiler's clock

Spans are recorded exactly while a ``torch.profiler`` session runs (its
flag, ``torch.autograd.profiler._is_profiler_enabled``, is one for every
thread): turning profiling on turns tracing on. Otherwise :func:`span` is
one flag test that returns a shared no-op context manager.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

Stamp = Tuple[int, int]  # (time.time_ns(), time.monotonic_ns())

_spans: List["Span"] = []
_counters: Dict[str, int] = {}
_roots: Dict[str, int] = {}     # root spans started so far, by name
_events: List[torch.cuda.Event] = []  # free CUDA events
_lock = threading.Lock()
_local = threading.local()


def _now() -> Stamp:
    return time.time_ns(), time.monotonic_ns()


class Span:
    """One recorded span. ``start`` / ``end`` are :data:`Stamp` s (``end``
    None while it runs); ``parent`` the span of the same thread it opened
    in; ``request`` the parent's, else the one given, else the number of
    earlier root spans of its name."""

    __slots__ = ("name", "device", "parent", "request", "thread", "start", "end", "child_ns",
                 "_ev")

    def __init__(self, name: str, device: bool, request: Optional[int]):
        self.name, self.device, self.request = name, device, request
        self.end, self.child_ns, self._ev = None, 0, None

    def __enter__(self) -> "Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.thread = threading.get_ident()
        with _lock:
            if self.parent is None:
                n = _roots.get(self.name, 0)
                _roots[self.name] = n + 1
                if self.request is None:
                    self.request = n
            _spans.append(self)
            if self.device and torch.cuda.is_initialized():
                self._ev = tuple(_events.pop() if _events else torch.cuda.Event(enable_timing=True)
                                 for _ in range(2))
        if self.request is None:
            self.request = self.parent.request
        stack.append(self)
        if self._ev is not None:
            self._ev[0].record()
        self.start: Stamp = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end = _now()
        if self._ev is not None:
            self._ev[1].record()
        _local.stack.pop()
        if self.parent is not None:
            self.parent.child_ns += self.end[1] - self.start[1]

    @property
    def host_ms(self) -> Optional[float]:
        return None if self.end is None else (self.end[1] - self.start[1]) / 1e6

    @property
    def self_ms(self) -> Optional[float]:
        """Host ms not covered by the span's children."""
        return None if self.end is None else (self.end[1] - self.start[1] - self.child_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Device ms between the span's two events; None for a span not
        device-timed, or whose end the device has not reached yet."""
        if self._ev is None or self.end is None or not self._ev[1].query():
            return None
        return self._ev[0].elapsed_time(self._ev[1])


class _Off:
    """The span of an untraced run: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()


def span(name: str, *, device: bool = False, request: Optional[int] = None):
    """A context manager recording the span ``name`` while a profiler
    session runs, else the shared no-op. ``device``: also time it on the
    device (CUDA events on the current stream, never synchronised)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device, request)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, recording or not."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


LAUNCHES = "kernels.launches."


def launched(kernel: str) -> None:
    """Count one launch of ``kernel`` (``kernels.launches.<kernel>``)."""
    count(LAUNCHES + kernel)


def launch_clock() -> int:
    """At a kernel wrapper's entry: the host clock (ns) while recording,
    else 0."""
    return time.perf_counter_ns() if _profiler._is_profiler_enabled else 0


def launch_timed(kernel: str, start: int) -> None:
    """After a launch that began at ``start`` (:func:`launch_clock`): add
    its host ns to ``kernels.launch_host_ns.<kernel>`` and count it in
    ``kernels.launches_timed.<kernel>``; nothing for ``start`` 0."""
    if start:
        count(f"kernels.launch_host_ns.{kernel}", time.perf_counter_ns() - start)
        count(f"kernels.launches_timed.{kernel}")


def recorded() -> Tuple[List[Span], Dict[str, int]]:
    """The spans in the order they started, and the counters: copies of
    the lists, the spans themselves shared (a running one ends later)."""
    with _lock:
        return list(_spans), dict(_counters)


def reset() -> None:
    """Forget every span and counter; the spans' CUDA events go back to
    the pool."""
    with _lock:
        for s in _spans:
            if s._ev is not None:
                _events.extend(s._ev)
        _spans.clear()
        _counters.clear()
        _roots.clear()


def reset_counters(prefix: str) -> None:
    """Zero the counters whose name starts with ``prefix``."""
    with _lock:
        for key in [k for k in _counters if k.startswith(prefix)]:
            del _counters[key]


def _chrome_events(spans: List[Span], begin: Stamp, origin: int, base: int) -> List[dict]:
    """The ended spans started at or after ``begin`` as Chrome trace events
    on the profiler's clock: of the two host clocks, the one on which the
    profile's start ``origin`` (ns) lies nearest ``begin``; ``ts`` counts
    microseconds from ``base``, as the profiler's export does."""
    clock = min((0, 1), key=lambda c: abs(begin[c] - origin))
    pid = os.getpid()
    out = []
    for s in spans:
        if s.end is None or s.start[clock] < begin[clock]:
            continue
        out.append({"ph": "X", "cat": "recorder", "name": s.name, "pid": pid, "tid": s.thread,
                    "ts": (s.start[clock] - base) / 1e3,
                    "dur": (s.end[clock] - s.start[clock]) / 1e3,
                    "args": {"request": s.request, "device_ms": s.device_ms,
                             "parent": None if s.parent is None else s.parent.name}})
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile the block (host, and the card when there is one) and write
    ``trace.json``, a Chrome trace holding the recorder's spans, into
    ``log_dir`` (default ``diffusioniqt_trace`` under the temporary
    directory). Yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "diffusioniqt_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        begin = _now()
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    doc["traceEvents"] += _chrome_events(recorded()[0], begin,
                                         prof.profiler.kineto_results.trace_start_ns(),
                                         int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as fh:
        json.dump(doc, fh)
