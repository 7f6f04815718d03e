"""Measured dispatch cutovers for the scan paths.

Dispatch decisions in the scan stack depend on machine-specific constant
factors, not asymptotics, so hard-coding them is wrong on every host but the
one they were tuned on:

* numpy per-atom scan vs. the fused device kernel launch (fixed launch,
  upload and readback overhead vs. better per-row throughput), likewise for
  fused membership and run-space RLE launches,
* serial partition scan vs. thread-pool fan-out (pool round-trip overhead
  vs. parallel speedup on the surviving rows),
* in-situ encoded scan vs. decode-then-scan (per-atom Python + searchsorted
  overhead vs. one amortized decode),
* a disk-tier stage compared straight through its memmap vs. loaded into
  RAM first (page-table setup vs. one full read).

Each is measured lazily, once per process, on small synthetic workloads,
cached under a lock, and overridable via environment for CI and tests
(``PREDTRACE_DEVICE_CUTOVER``, ``PREDTRACE_PARALLEL_CUTOVER``,
``PREDTRACE_INSITU_CUTOVER``, ``PREDTRACE_MEMBER_CUTOVER``,
``PREDTRACE_RLE_CUTOVER``, ``PREDTRACE_DISK_CUTOVER`` — integer row
thresholds).  Every timed device launch ends in its mask readback, which
waits for the device, so host clocks time the whole launch.

Probes are *invalidatable*: each cached measurement is a :class:`Probe`
stamped with its wall-clock time and a confidence that decays every time the
cost model's feedback loop reports that observed actuals disagree with the
probe-seeded estimates by more than 3x (``core/cost.py``).  A disagreement
(:func:`note_disagreement`) drops the probe, so the next consult re-measures
— a probe taken while the host was under load no longer poisons every later
decision for the life of the process.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

_LOCK = threading.RLock()

NEVER = 1 << 62  # cutover value meaning "the alternative path never wins"


@dataclass
class Probe:
    """One cached cutover measurement with provenance.

    ``confidence`` starts at 1.0 for a fresh measurement and halves for each
    prior disagreement of its family (a probe re-taken after being
    contradicted is trusted less, so the cost model hands over to observed
    actuals sooner); ``source`` is ``"measured"`` or ``"env"``."""

    value: int
    measured_at: float          # time.time() stamp
    source: str                 # "measured" | "env"
    confidence: float = 1.0
    remeasures: int = 0         # disagreement-driven re-measurements before it

    def as_dict(self) -> Dict[str, object]:
        return {"value": self.value, "measured_at": self.measured_at,
                "source": self.source, "confidence": self.confidence,
                "remeasures": self.remeasures}


# disagreement counters per probe family ("device" / "parallel" / ...):
# bumped by note_disagreement, consumed as the confidence of the next probe
_disagreements: Dict[str, int] = {}


def _family_confidence(kind: str) -> float:
    return 0.5 ** _disagreements.get(kind, 0)


def _mk_probe(kind: str, value: int, source: str = "measured") -> Probe:
    return Probe(value=value, measured_at=time.time(), source=source,
                 confidence=1.0 if source == "env" else _family_confidence(kind),
                 remeasures=_disagreements.get(kind, 0))


def _best_s(fn: Callable[[], object], repeat: int = 5) -> float:
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measured_crossover(
    host_fn: Callable[[int], object],
    alt_fn: Callable[[int], object],
    sizes: Tuple[int, int],
    repeat: int = 5,
) -> float:
    """Rows at which ``alt_fn`` starts beating ``host_fn``.

    Fits cost(n) = a + b*n to two timed sizes per path and solves for the
    crossing.  Returns ``inf`` when the alternative's marginal cost is not
    lower (it never wins), 0 when it wins even at the small size.
    """
    n1, n2 = sizes
    # warm both paths (first-use builds, allocations) before timing
    host_fn(n1), alt_fn(n1), host_fn(n2), alt_fn(n2)
    h1, h2 = _best_s(lambda: host_fn(n1), repeat), _best_s(lambda: host_fn(n2), repeat)
    a1, a2 = _best_s(lambda: alt_fn(n1), repeat), _best_s(lambda: alt_fn(n2), repeat)
    bh = (h2 - h1) / (n2 - n1)
    ba = (a2 - a1) / (n2 - n1)
    if ba >= bh:  # alternative is not cheaper per row
        return float("inf")
    ah, aa = h1 - bh * n1, a1 - ba * n1
    n_star = (aa - ah) / (bh - ba)
    return max(n_star, 0.0)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    try:
        return int(v)
    except ValueError:
        return None


# --------------------------------------------------------------------------- #
# device fused-scan cutover (rows x atoms work product)
# --------------------------------------------------------------------------- #

_device_cutovers: dict = {}


def device_scan_probe(key: str, launch: Callable[[np.ndarray, np.ndarray], np.ndarray],
                      n_atoms: int = 4, batch: int = 1) -> Probe:
    """Measured rows*atoms*batch product below which the numpy per-atom path
    beats a fused device launch, as a stamped :class:`Probe`.
    ``launch(slab, thr)`` must run the backend's real launch path (slab
    [C, n] int32, thr [batch, n_atoms] int32) so the measurement includes
    padding, upload, and readback overheads.
    """
    env = _env_int("PREDTRACE_DEVICE_CUTOVER")
    if env is not None:
        return _mk_probe("device", env, source="env")
    with _LOCK:
        if key in _device_cutovers:
            return _device_cutovers[key]
        rng = np.random.default_rng(11)
        # both probe sizes must be large enough to sit in the linear regime
        # of each path (fixed launch overhead amortized)
        sizes = (1 << 17, 1 << 21)
        slabs = {n: rng.integers(-1000, 1000, (n_atoms, n)).astype(np.int32) for n in sizes}
        thr = rng.integers(-1000, 1000, (batch, n_atoms)).astype(np.int32)
        ops = [np.greater_equal, np.less, np.greater, np.less_equal]

        def host(n: int) -> np.ndarray:
            slab = slabs[n]
            outs = []
            for k in range(batch):  # numpy answers a batch one binding at a time
                m = ops[0](slab[0], thr[k, 0])
                for j in range(1, n_atoms):
                    m &= ops[j % len(ops)](slab[j], thr[k, j])
                outs.append(m)
            return outs[-1]

        def dev(n: int) -> np.ndarray:
            return launch(slabs[n], thr)

        try:
            rows = measured_crossover(host, dev, sizes)
        except Exception:
            rows = float("inf")
        cut = NEVER if rows == float("inf") else int(
            min(max(rows * n_atoms * batch * 1.25, 1 << 12), NEVER)
        )
        probe = _mk_probe("device", cut)
        _device_cutovers[key] = probe
        return probe


# --------------------------------------------------------------------------- #
# parallel fan-out cutover (total surviving rows)
# --------------------------------------------------------------------------- #

_parallel_cutovers: dict = {}
PARALLEL_FLOOR = 16384  # never fan out below this, whatever the measurement says


def parallel_scan_probe(pool, workers: int) -> Probe:
    """Measured total-row threshold below which serial beats pool fan-out,
    as a stamped :class:`Probe`: break-even where the pool's submit/join
    round-trip overhead equals the scan time it can save (≈ (W-1)/W of the
    serial cost), doubled for safety.
    """
    env = _env_int("PREDTRACE_PARALLEL_CUTOVER")
    if env is not None:
        return _mk_probe("parallel", env, source="env")
    key = id(pool)
    with _LOCK:
        if key in _parallel_cutovers:
            return _parallel_cutovers[key]

        def _noop(_):
            return None

        list(pool.map(_noop, range(workers)))  # warm the pool threads
        overhead = _best_s(lambda: list(pool.map(_noop, range(workers))))
        n = 1 << 16
        arr = np.arange(n, dtype=np.int64)
        row_cost = _best_s(lambda: (arr > 5) & (arr < n)) / n
        savable = max(1.0 - 1.0 / max(workers, 2), 0.5)
        rows = 2.0 * overhead / max(row_cost * savable, 1e-12)
        cut = int(min(max(rows, PARALLEL_FLOOR), 1 << 24))
        probe = _mk_probe("parallel", cut)
        _parallel_cutovers[key] = probe
        return probe


def parallel_scan_cutover(pool, workers: int) -> int:
    """Cutover value of :func:`parallel_scan_probe`."""
    return parallel_scan_probe(pool, workers).value


# --------------------------------------------------------------------------- #
# in-situ vs decode-then-scan cutover (stage rows)
# --------------------------------------------------------------------------- #

_insitu_cutover: Optional[Probe] = None


def insitu_scan_probe() -> Probe:
    """Measured stage-row threshold below which decode-then-scan beats the
    in-situ encoded path (whose per-atom Python dispatch + searchsorted setup
    dominates tiny stages), as a stamped :class:`Probe`.  Compares a
    dictionary-encoded compare against a plain numpy compare on the decoded
    column; the decode itself is amortized (stages cache their decoded
    table), so it is not charged here.
    """
    global _insitu_cutover
    env = _env_int("PREDTRACE_INSITU_CUTOVER")
    if env is not None:
        return _mk_probe("insitu", env, source="env")
    with _LOCK:
        if _insitu_cutover is not None:
            return _insitu_cutover
        rng = np.random.default_rng(13)
        sizes = (1 << 10, 1 << 16)
        data = {}
        for n in sizes:
            raw = rng.integers(0, 200, n).astype(np.int64) * 10
            values = np.unique(raw)
            codes = np.searchsorted(values, raw).astype(np.uint16)
            data[n] = (raw, values, codes)

        def insitu(n: int) -> np.ndarray:
            raw, values, codes = data[n]
            # dict code-space compare: searchsorted + present check + code cmp
            v = 550
            lo = int(values.searchsorted(v, side="left"))
            present = lo < len(values) and values[lo] == v
            if present:
                return codes == lo
            return np.zeros(n, bool)

        def decoded(n: int) -> np.ndarray:
            raw = data[n][0]
            return raw == 550

        try:
            rows = measured_crossover(decoded, insitu, sizes)
        except Exception:
            rows = float("inf")
        # below the crossover the decoded path wins; clamp to a sane band
        # (inf = the in-situ slope never wins -> always prefer decode)
        if rows == float("inf"):
            cut = 1 << 20
        else:
            cut = int(min(max(rows, 256), 1 << 20))
        _insitu_cutover = _mk_probe("insitu", cut)
        return _insitu_cutover


# --------------------------------------------------------------------------- #
# disk-tier (memmap) scan cutover (stage rows)
# --------------------------------------------------------------------------- #

_disk_cutover: Optional[Probe] = None


def disk_scan_probe() -> Probe:
    """Measured stage-row threshold below which loading a spilled payload
    fully into RAM and comparing beats comparing straight through the
    memmap (whose open + page-table setup dominates tiny stages), as a
    stamped :class:`Probe` (``PREDTRACE_DISK_CUTOVER`` pins it).

    The measurement runs with warm pages, so it prices the steady state of
    a repeatedly-scanned disk-tier stage; the cold page-fault slope is what
    the ``disk_insitu`` route's seeded ratio charges, refined online from
    observed actuals like every other route."""
    global _disk_cutover
    env = _env_int("PREDTRACE_DISK_CUTOVER")
    if env is not None:
        return _mk_probe("disk", env, source="env")
    with _LOCK:
        if _disk_cutover is not None:
            return _disk_cutover
        import shutil
        import tempfile

        rng = np.random.default_rng(23)
        sizes = (1 << 12, 1 << 18)
        tmpdir = tempfile.mkdtemp(prefix="predtrace-probe-")
        rows = float("inf")
        try:
            paths = {}
            for n in sizes:
                p = os.path.join(tmpdir, f"probe_{n}.npy")
                np.save(p, rng.integers(0, 1000, n).astype(np.int64))
                paths[n] = p
            mmaps = {n: np.load(p, mmap_mode="r") for n, p in paths.items()}

            def loaded(n: int) -> np.ndarray:
                return np.load(paths[n]) > 500

            def mapped(n: int) -> np.ndarray:
                return np.asarray(mmaps[n] > 500)

            try:
                rows = measured_crossover(loaded, mapped, sizes)
            except Exception:
                rows = float("inf")
            del mmaps
        finally:
            shutil.rmtree(tmpdir, ignore_errors=True)
        if rows == float("inf"):
            cut = 1 << 20
        else:
            cut = int(min(max(rows, 256), 1 << 20))
        _disk_cutover = _mk_probe("disk", cut)
        return _disk_cutover


# --------------------------------------------------------------------------- #
# fused-membership cutover (rows x set-atoms work product)
# --------------------------------------------------------------------------- #

_member_cutovers: dict = {}


def member_scan_probe(key: str,
                      launch: Callable[[np.ndarray, np.ndarray], np.ndarray]) -> Probe:
    """Measured row count below which a host ``np.isin`` probe beats the
    fused in-grid membership search, as a stamped :class:`Probe`
    (``PREDTRACE_MEMBER_CUTOVER`` pins it).  ``launch(values, vset)`` must run
    the backend's real fused-membership launch (slab build, set-slab upload,
    readback included) so the crossover prices the whole path, not the kernel
    alone."""
    env = _env_int("PREDTRACE_MEMBER_CUTOVER")
    if env is not None:
        return _mk_probe("member", env, source="env")
    with _LOCK:
        if key in _member_cutovers:
            return _member_cutovers[key]
        rng = np.random.default_rng(17)
        sizes = (1 << 16, 1 << 20)
        vals = {n: rng.integers(-(10 ** 6), 10 ** 6, n).astype(np.int32)
                for n in sizes}
        vset = np.unique(rng.integers(-(10 ** 6), 10 ** 6, 512)).astype(np.int32)

        def host(n: int) -> np.ndarray:
            return np.isin(vals[n], vset)

        def dev(n: int) -> np.ndarray:
            return launch(vals[n], vset)

        try:
            rows = measured_crossover(host, dev, sizes)
        except Exception:
            rows = float("inf")
        cut = NEVER if rows == float("inf") else int(
            min(max(rows * 1.25, 1 << 12), NEVER)
        )
        probe = _mk_probe("member", cut)
        _member_cutovers[key] = probe
        return probe


# --------------------------------------------------------------------------- #
# run-space RLE cutover (encoded-stage rows)
# --------------------------------------------------------------------------- #

_rle_cutovers: dict = {}


def rle_scan_probe(key: str,
                   launch: Callable[[np.ndarray, np.ndarray, int], np.ndarray]) -> Probe:
    """Measured row count below which the host per-run compare-and-repeat
    beats launching the kernel over the run lane, as a stamped :class:`Probe`
    (``PREDTRACE_RLE_CUTOVER`` pins it).  ``launch(run_values, run_lengths,
    thr)`` must run the backend's real run-space path — run-lane launch plus
    the ``np.repeat`` expansion of the surviving runs."""
    env = _env_int("PREDTRACE_RLE_CUTOVER")
    if env is not None:
        return _mk_probe("rle", env, source="env")
    with _LOCK:
        if key in _rle_cutovers:
            return _rle_cutovers[key]
        rng = np.random.default_rng(19)
        sizes = (1 << 17, 1 << 21)
        data = {}
        for n in sizes:
            runs = max(n >> 4, 1)  # ~16-row runs: the regime RLE encodes for
            rv = rng.integers(-1000, 1000, runs).astype(np.int32)
            rl = np.full(runs, n // runs, dtype=np.int64)
            rl[-1] += n - int(rl.sum())
            data[n] = (rv, rl)

        def host(n: int) -> np.ndarray:
            rv, rl = data[n]
            return np.repeat(rv >= 0, rl)

        def dev(n: int) -> np.ndarray:
            rv, rl = data[n]
            return launch(rv, rl, 0)

        try:
            rows = measured_crossover(host, dev, sizes)
        except Exception:
            rows = float("inf")
        cut = NEVER if rows == float("inf") else int(
            min(max(rows * 1.25, 1 << 12), NEVER)
        )
        probe = _mk_probe("rle", cut)
        _rle_cutovers[key] = probe
        return probe


# --------------------------------------------------------------------------- #
# host scan cost baseline + probe invalidation
# --------------------------------------------------------------------------- #

_host_row_cost: Optional[float] = None


def host_row_cost() -> float:
    """Measured seconds per row x atom of a vectorized host compare — the
    baseline slope every cost-model route is seeded relative to
    (``PREDTRACE_HOST_ROW_NS`` overrides, in nanoseconds per row)."""
    global _host_row_cost
    env = os.environ.get("PREDTRACE_HOST_ROW_NS")
    if env:
        try:
            return max(float(env), 1e-3) * 1e-9
        except ValueError:
            pass
    with _LOCK:
        if _host_row_cost is None:
            n = 1 << 16
            arr = np.arange(n, dtype=np.int64)
            _host_row_cost = float(
                min(max(_best_s(lambda: arr > 5) / n, 1e-11), 1e-7)
            )
        return _host_row_cost


def note_disagreement(kind: str) -> int:
    """The cost model observed actuals persistently disagreeing (>3x) with
    estimates seeded from this probe family (``"device"`` / ``"parallel"`` /
    ``"insitu"`` / ``"member"`` / ``"rle"`` / ``"disk"``): drop the cached probe so the next
    consult re-measures, and decay the family's confidence.  Returns the disagreement count."""
    with _LOCK:
        n = _disagreements.get(kind, 0) + 1
        _disagreements[kind] = n
        invalidate(kind)
        return n


def invalidate(kind: Optional[str] = None) -> None:
    """Drop cached probes of one family (or all, ``kind=None``) so the next
    consult re-measures under current load."""
    global _insitu_cutover, _disk_cutover, _host_row_cost
    with _LOCK:
        if kind in (None, "device"):
            _device_cutovers.clear()
        if kind in (None, "parallel"):
            _parallel_cutovers.clear()
        if kind in (None, "insitu"):
            _insitu_cutover = None
        if kind in (None, "member"):
            _member_cutovers.clear()
        if kind in (None, "rle"):
            _rle_cutovers.clear()
        if kind in (None, "disk"):
            _disk_cutover = None
        if kind is None:
            _host_row_cost = None


def probe_info() -> Dict[str, object]:
    """Snapshot of every cached probe (value, timestamp, confidence,
    re-measurement count) plus the per-family disagreement counters."""
    with _LOCK:
        out: Dict[str, object] = {
            "device": {k: p.as_dict() for k, p in _device_cutovers.items()},
            "parallel": {str(k): p.as_dict()
                         for k, p in _parallel_cutovers.items()},
            "insitu": (None if _insitu_cutover is None
                       else _insitu_cutover.as_dict()),
            "member": {k: p.as_dict() for k, p in _member_cutovers.items()},
            "rle": {k: p.as_dict() for k, p in _rle_cutovers.items()},
            "disk": (None if _disk_cutover is None
                     else _disk_cutover.as_dict()),
            "disagreements": dict(_disagreements),
            "host_row_cost_s": _host_row_cost,
        }
    return out


def reset_for_tests() -> None:
    """Drop all cached measurements and disagreement counters (tests
    re-measure or use env overrides)."""
    global _insitu_cutover, _disk_cutover, _host_row_cost
    with _LOCK:
        _device_cutovers.clear()
        _parallel_cutovers.clear()
        _insitu_cutover = None
        _member_cutovers.clear()
        _rle_cutovers.clear()
        _disk_cutover = None
        _host_row_cost = None
        _disagreements.clear()
