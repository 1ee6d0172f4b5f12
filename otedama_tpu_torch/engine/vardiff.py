"""Per-worker variable difficulty, vardiff (counterpart of
``otedama_tpu/engine/vardiff.py``, copied whole).

Reference parity: internal/stratum/unified_stratum.go:950-1003
``DifficultyManager.AdjustForClient`` (share-rate window -> difficulty
up/down) and internal/pool/difficulty_adjuster.go. Same semantics, cleaner
math: aim for a target share interval, retarget on a fixed cadence, clamp
the step factor, and bound the result.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class VardiffConfig:
    target_share_seconds: float = 10.0   # aim: one share every N seconds
    retarget_seconds: float = 60.0       # how often to reconsider
    min_difficulty: float = 0.001
    max_difficulty: float = 1e9
    max_step: float = 4.0                # clamp per-retarget change factor
    window: int = 32                     # shares remembered


@dataclasses.dataclass
class _WorkerWindow:
    difficulty: float
    share_times: list[float] = dataclasses.field(default_factory=list)
    last_retarget: float = dataclasses.field(default_factory=time.time)


class VardiffManager:
    """Tracks share cadence per worker and proposes difficulty updates."""

    def __init__(self, config: VardiffConfig | None = None, initial_difficulty: float = 1.0):
        self.config = config or VardiffConfig()
        self.initial_difficulty = initial_difficulty
        self._workers: dict[str, _WorkerWindow] = {}

    def difficulty(self, worker: str) -> float:
        return self._ensure(worker).difficulty

    def _ensure(self, worker: str) -> _WorkerWindow:
        if worker not in self._workers:
            self._workers[worker] = _WorkerWindow(self.initial_difficulty)
        return self._workers[worker]

    def seed(self, worker: str, difficulty: float) -> None:
        """Adopt an externally recovered difficulty as this worker's
        baseline (session resume / region handoff): future retargets
        step FROM it instead of snapping the worker back toward
        ``initial_difficulty`` — the reset the resume token exists to
        prevent."""
        w = self._ensure(worker)
        w.difficulty = min(
            max(difficulty, self.config.min_difficulty),
            self.config.max_difficulty,
        )
        w.last_retarget = time.time()

    def record_share(self, worker: str, when: float | None = None) -> None:
        w = self._ensure(worker)
        w.share_times.append(when if when is not None else time.time())
        if len(w.share_times) > self.config.window:
            del w.share_times[: -self.config.window]

    def maybe_retarget(self, worker: str, now: float | None = None) -> float | None:
        """Returns the new difficulty if it changed, else None."""
        cfg = self.config
        w = self._ensure(worker)
        now = now if now is not None else time.time()
        if now - w.last_retarget < cfg.retarget_seconds:
            return None
        window_start = w.last_retarget
        w.last_retarget = now
        recent = [t for t in w.share_times if t >= window_start]
        elapsed = max(now - window_start, 1e-9)
        actual_rate = len(recent) / elapsed                 # shares/s
        desired_rate = 1.0 / cfg.target_share_seconds
        if actual_rate == 0:
            factor = 1.0 / cfg.max_step                     # no shares: ease off
        else:
            factor = actual_rate / desired_rate
            factor = min(max(factor, 1.0 / cfg.max_step), cfg.max_step)
        new = min(max(w.difficulty * factor, cfg.min_difficulty), cfg.max_difficulty)
        # suppress noise: require a >= 20% move
        if abs(new - w.difficulty) / w.difficulty < 0.2:
            return None
        w.difficulty = new
        return new

    def forget(self, worker: str) -> None:
        self._workers.pop(worker, None)
