"""The reduction of a profiled span of the run to numbers.

A profile is reduced to two lists of spans in one clock (nanoseconds):
``device``, every operation that ran on the card (kernels, copies, sets)
as ``(start, end, name)``, and ``host``, every operation of the host
(PyTorch operators, CUDA runtime calls, the benchmark's own ranges) as
``(start, end, name)``.  The profiled window is the profiled units' own
span, synchronised at both ends (the benchmark's host range where the
host was traced, else the first device operation to the last), so its
idle share is taken over its own wall time and not over another call's.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Sequence, Tuple

Span = Tuple[int, int, str]
WINDOW_RANGE = "bench.profiled"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


def is_kernel(name: str) -> bool:
    return not name.startswith(COPY_PREFIXES)


def base_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters: ``void (anonymous namespace)::f<64,
    float>(int)`` is ``f``."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    cut = min((i for i in (name.find("<"), name.find("(")) if i >= 0), default=len(name))
    return name[:cut].rsplit("::", 1)[-1]


def named(*prefixes: str):
    """A test of a device operation's name: true where its base name
    (:func:`base_name`) starts with one of ``prefixes``."""
    def match(name: str) -> bool:
        return base_name(name).startswith(prefixes)
    return match


def saying(*words: str):
    """A test of a device operation's name: true where the name holds one
    of ``words``, case aside."""
    def match(name: str) -> bool:
        low = name.lower()
        return any(w in low for w in words)
    return match


def total_ns(ops: Iterable[Span]) -> int:
    return sum(b - a for a, b, _ in ops)


def _clip(spans: Iterable[Span], lo: int, hi: int) -> List[Tuple[int, int]]:
    out = []
    for a, b, _ in spans:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            out.append((a, b))
    out.sort()
    return out


def busy_ns(device: Sequence[Span], lo: int, hi: int) -> int:
    """Nanoseconds of ``[lo, hi]`` in which some device operation ran: the
    length of the union of the spans (overlapping kernels count once)."""
    busy, end = 0, lo
    for a, b in _clip(device, lo, hi):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def idle_gaps(device: Sequence[Span], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The stretches of ``[lo, hi]`` in which no device operation ran."""
    gaps, end = [], lo
    for a, b in _clip(device, lo, hi):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def name_gaps(gaps: Sequence[Tuple[int, int]], host: Sequence[Span],
              skip: str = WINDOW_RANGE) -> Dict[str, int]:
    """Idle nanoseconds by what the host was doing: each gap goes to the
    innermost host operation (the latest to start) that covers its middle,
    or to ``"host (no operator)"`` where none does."""
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    events = sorted((a, b, n) for a, b, n in host if n != skip)
    out: Dict[str, int] = {}
    active: List[Tuple[int, int, str]] = []  # (-start, end, name)
    i = 0
    for mid, length in mids:
        while i < len(events) and events[i][0] <= mid:
            a, b, n = events[i]
            heapq.heappush(active, (-a, b, n))
            i += 1
        # the latest-starting operation still open at ``mid``; one that
        # ended before ``mid`` ended before every later gap's middle too
        name = "host (no operator)"
        while active:
            if active[0][1] >= mid:
                name = active[0][2]
                break
            heapq.heappop(active)
        out[name] = out.get(name, 0) + length
    return out


def device_time_by_name(device: Sequence[Span], lo: int, hi: int) -> Dict[str, int]:
    """Nanoseconds of device operations by name, within ``[lo, hi]``."""
    out: Dict[str, int] = {}
    for a, b, n in device:
        if b > lo and a < hi:
            out[n] = out.get(n, 0) + min(b, hi) - max(a, lo)
    return out


def top(d: Dict[str, int], k: int = 10) -> List[Tuple[str, int]]:
    return sorted(d.items(), key=lambda kv: -kv[1])[:k]


def short(name: str, width: int = 120) -> str:
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    return name if len(name) <= width else name[:width - 3] + "..."


def profiled(rec, kind: str):
    """(profile, its units of ``kind``) of a traced run whose profile saw
    the device work; (None, []) where there is nothing to read."""
    p = rec.profile
    units = [u for u in p.units if u["kind"] == kind] if p and p.device else []
    return (p, units) if units else (None, [])


class Profile:
    """One profiled span of the run: the device and host spans, the
    window's bounds, and the units of work it covered (train steps, as
    the driver records them)."""

    def __init__(self, device: List[Span], host: List[Span], lo: int, hi: int,
                 units: list):
        self.device, self.host, self.lo, self.hi, self.units = device, host, lo, hi, units
        self.gaps: Dict[str, int] = name_gaps(idle_gaps(device, lo, hi), host) if host else {}

    @property
    def window_ns(self) -> int:
        return self.hi - self.lo

    def busy_ns(self) -> int:
        return busy_ns(self.device, self.lo, self.hi)

    def kernels(self, match=None) -> List[Span]:
        """Device kernels inside the window (copies and sets left out),
        those whose name ``match`` accepts where it is given."""
        return [s for s in self.device if is_kernel(s[2]) and s[1] > self.lo
                and s[0] < self.hi and (match is None or match(s[2]))]

    def breakdown(self) -> dict:
        ops = device_time_by_name(self.device, self.lo, self.hi)
        return {"device_ops": [[short(n), t * 1e-9] for n, t in top(ops)],
                "idle_gaps": [[short(n), t * 1e-9] for n, t in top(self.gaps)]}


def _annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag()) if flag is not None else event.name() == WINDOW_RANGE


def from_profiler(prof, units: list) -> Profile:
    """A :class:`Profile` from a finished ``torch.profiler.profile``: its
    raw events (the kineto results, without building PyTorch's event
    tree).  The window is the host range named :data:`WINDOW_RANGE` where
    the host was traced, else the span from the first device operation to
    the last."""
    device, host = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        b = a + e.duration_ns()
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            host.append((a, b, name))
            if name == WINDOW_RANGE:
                window = (a, b)
        elif not _annotation(e):  # a range's image on the device's timeline
            device.append((a, b, name))
    if window is None and device:
        window = (min(a for a, _, _ in device), max(b for _, b, _ in device))
    if window is None:
        raise RuntimeError("the profile holds neither a window range nor device work")
    return Profile(device, host, window[0], window[1], units)
