"""Cluster runtime: heartbeats, straggler mitigation, elastic scaling (the
port's own copy of the reference's ``runtime/controller.py``).

The interfaces are production-shaped; the transport is a simulated in-process
backend (one process).  On a real fleet the same controller
runs against a GRPC/etcd backend — the decision logic (what to do on a missed
heartbeat, when to declare a straggler, how to re-mesh) is all here and is
what the tests exercise.

Policies implemented:
* **Heartbeat failure detection**: a worker missing ``miss_limit``
  consecutive beats is declared dead -> controller triggers
  checkpoint-restore onto the surviving devices
  (``CheckpointManager.restore`` with a target ``device``).
* **Straggler mitigation**: per-step durations are tracked; a worker slower
  than ``straggler_factor`` x median for ``window`` steps is flagged; the
  mitigation hook (default: re-shard it out, same path as failure) runs.
* **Elastic scale up/down**: ``plan_remesh`` picks the largest valid
  (pod, data, model) mesh for the surviving world size, preferring to shrink
  the data axis first (keeps TP intact so checkpoints reshard cheaply).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


@dataclass
class WorkerState:
    worker_id: int
    last_beat: float = field(default_factory=time.monotonic)
    missed: int = 0
    step_times: List[float] = field(default_factory=list)
    alive: bool = True
    straggler: bool = False


@dataclass
class RemeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_workers: Tuple[int, ...]


class ClusterController:
    def __init__(
        self,
        n_workers: int,
        beat_interval: float = 1.0,
        miss_limit: int = 3,
        straggler_factor: float = 2.0,
        straggler_window: int = 5,
        on_failure: Optional[Callable[[RemeshPlan], None]] = None,
    ):
        self.workers = {i: WorkerState(i) for i in range(n_workers)}
        self.beat_interval = beat_interval
        self.miss_limit = miss_limit
        self.straggler_factor = straggler_factor
        self.straggler_window = straggler_window
        self.on_failure = on_failure
        self.events: List[str] = []

    # ---- heartbeat path -------------------------------------------------- #
    def beat(self, worker_id: int, step_time: Optional[float] = None, now: Optional[float] = None):
        w = self.workers[worker_id]
        w.last_beat = now if now is not None else time.monotonic()
        w.missed = 0
        if step_time is not None:
            w.step_times.append(step_time)
            if len(w.step_times) > 50:
                w.step_times = w.step_times[-50:]

    def sweep(self, now: Optional[float] = None) -> Optional[RemeshPlan]:
        """Periodic check: mark missed beats, declare failures/stragglers."""
        now = now if now is not None else time.monotonic()
        changed = False
        for w in self.workers.values():
            if not w.alive:
                continue
            if now - w.last_beat > self.beat_interval:
                w.missed += 1
                w.last_beat = now
                if w.missed >= self.miss_limit:
                    w.alive = False
                    changed = True
                    self.events.append(f"worker {w.worker_id} dead (missed {w.missed} beats)")
        self._detect_stragglers()
        if changed:
            plan = self.plan_remesh()
            if self.on_failure:
                self.on_failure(plan)
            return plan
        return None

    def _detect_stragglers(self):
        alive = [w for w in self.workers.values() if w.alive and len(w.step_times) >= self.straggler_window]
        if len(alive) < 2:
            return
        med = sorted(sum(w.step_times[-self.straggler_window :]) / self.straggler_window for w in alive)[
            len(alive) // 2
        ]
        for w in alive:
            mean = sum(w.step_times[-self.straggler_window :]) / self.straggler_window
            was = w.straggler
            w.straggler = mean > self.straggler_factor * med
            if w.straggler and not was:
                self.events.append(
                    f"worker {w.worker_id} straggling ({mean:.3f}s vs median {med:.3f}s)"
                )

    # ---- elastic re-mesh -------------------------------------------------- #
    def plan_remesh(self, model_axis: int = 16, pod_size: int = 256) -> RemeshPlan:
        """Largest valid mesh on the surviving workers: keep the ``model``
        axis (TP resharding is the expensive direction), shrink ``data``, then
        drop to single-pod."""
        alive = sorted(w.worker_id for w in self.workers.values() if w.alive)
        dropped = tuple(sorted(set(self.workers) - set(alive)))
        n = len(alive)
        pods = max(n // pod_size, 1)
        per_pod = n // pods
        data = max(per_pod // model_axis, 1)
        if pods > 1:
            return RemeshPlan((pods, data, model_axis), ("pod", "data", "model"), dropped)
        return RemeshPlan((data, model_axis), ("data", "model"), dropped)

    def stragglers(self) -> List[int]:
        return [w.worker_id for w in self.workers.values() if w.straggler]

    def alive(self) -> List[int]:
        return [w.worker_id for w in self.workers.values() if w.alive]
