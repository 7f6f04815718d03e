"""The port's span recorder: named, nested time ranges on the host and on
the card's stream, kept in memory until taken.

The recorder is off by default. :func:`enable` turns it on and
:func:`disable` turns it off; no environment variable does. When it is
off, :func:`span` tests one flag and returns a shared object whose
``with`` does nothing: no record, no CUDA call.

When it is on, each span records:

* its id;
* its parent, the innermost span open on the same thread;
* its step, the id of the outermost span open on that thread, so every
  span opened inside one ``train_step`` carries the id of that call's
  ``train.step`` span;
* its name and attributes;
* its host start and end;
* on the card, a pair of timing events recorded on the current stream,
  taken from a pool that :func:`take` refills.

Host times are nanoseconds of :func:`clock_ns`, the clock of
``torch.profiler``'s events (``KinetoEvent.start_ns()`` reads the Unix
time), so a span lies on a profile's timeline without conversion. The
recorder opens no ``record_function`` range, so it adds nothing to a
profile's host events.

:func:`take` synchronises once and returns the finished spans. Each has
its device start and end in ms from the take's first marker, all on one
axis. On the CPU, where operations run as they are issued, the device
times are the host times.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

clock_ns = time.time_ns  # the profiler's clock

_on = False
_cuda = False
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_done: list = []  # (Span, start event, end event), in the order spans closed
_pool: list = []  # timing events free for reuse


@dataclass
class Span:
    """One finished span; ``device_*_ms`` are filled in by :func:`take`."""
    id: int
    parent: Optional[int]
    step: int
    name: str
    attrs: dict = field(default_factory=dict)
    host_start_ns: int = 0
    host_end_ns: int = 0
    device_start_ms: float = 0.0
    device_end_ms: float = 0.0

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    @property
    def device_ms(self) -> float:
        return self.device_end_ms - self.device_start_ms


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event():
    return _pool.pop() if _pool else torch.cuda.Event(enable_timing=True)


class _Open:
    __slots__ = ("span", "start", "cuda", "stack")

    def __init__(self, name: str, attrs: dict):
        self.stack = _stack()
        sid = next(_ids)
        up = self.stack[-1] if self.stack else None
        self.span = Span(sid, up.id if up else None, up.step if up else sid, name, attrs)
        self.start = None
        self.cuda = _cuda

    def __enter__(self) -> Span:
        self.stack.append(self.span)
        self.span.host_start_ns = clock_ns()
        if self.cuda:
            self.start = _event()
            self.start.record()
        return self.span

    def __exit__(self, *exc):
        end = None
        if self.cuda:
            end = _event()
            end.record()
        self.span.host_end_ns = clock_ns()
        self.stack.pop()
        with _lock:
            _done.append((self.span, self.start, end))
        return False


def span(name: str, **attrs):
    """A context manager around one span of work named ``name``.

    When the recorder is off, this tests one flag and returns the shared
    no-op object. It touches no CUDA API; the only cost is the empty
    keyword dict that Python builds for the call."""
    if not _on:
        return _OFF
    return _Open(name, attrs)


def enable(device=None) -> None:
    """Start recording. Spans are timed on ``device``'s current stream
    for a CUDA device (the card if there is one, by default), or on the
    host for the CPU."""
    global _on, _cuda
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    _cuda = torch.device(device).type == "cuda"
    _on = True


def disable() -> None:
    """Stop recording. Spans already open still record when they close,
    and finished spans wait for :func:`take`."""
    global _on
    _on = False


def take() -> List[Span]:
    """The spans finished since the last take, in the order they opened,
    with device times in ms from the first of them to open. The spans are
    cleared from the recorder. On the card this synchronises once and
    returns the events to the pool."""
    with _lock:
        done = _done[:]
        _done.clear()
    if not done:
        return []
    done.sort(key=lambda d: (d[0].host_start_ns, d[0].id))
    first, origin, _ = done[0]
    if origin is not None:
        torch.cuda.synchronize()
    for s, a, b in done:
        if origin is not None and a is not None:
            s.device_start_ms = origin.elapsed_time(a)
            s.device_end_ms = origin.elapsed_time(b)
        else:
            s.device_start_ms = (s.host_start_ns - first.host_start_ns) * 1e-6
            s.device_end_ms = (s.host_end_ns - first.host_start_ns) * 1e-6
        if a is not None:
            _pool.extend((a, b))
    return [s for s, _, _ in done]
