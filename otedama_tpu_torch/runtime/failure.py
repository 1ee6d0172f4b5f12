"""Failure detection + pluggable recovery strategies (counterpart of
``otedama_tpu/runtime/failure.py``).

The failure signals are device-pipeline level — hashrate collapse, batch
stalls, backend exceptions, share starvation, and the device supervision
states of ``runtime/supervision.py`` — and recovery acts on backends and
the engine (restart the engine, acknowledge a quarantine the engine
already opened, drop a dead device). ``RecoveryManager`` is the component
health registry with a restart policy.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import logging
import time
from typing import Awaitable, Callable, Protocol

log = logging.getLogger("otedama.runtime.failure")


class FailureType(enum.Enum):
    HASHRATE_DROP = "hashrate-drop"
    BATCH_STALL = "batch-stall"
    BACKEND_ERROR = "backend-error"
    SHARE_STARVATION = "share-starvation"
    COMPONENT_DEAD = "component-dead"
    # device supervision (runtime/supervision.py via the engine): a
    # device whose call blew its watchdog deadline and entered
    # quarantine, and a device whose reintegration probe budget ran out
    DEVICE_HUNG = "device-hung"
    DEVICE_LOST = "device-lost"


@dataclasses.dataclass
class Failure:
    type: FailureType
    component: str
    detail: str
    detected_at: float = dataclasses.field(default_factory=time.time)


class RecoveryStrategy(Protocol):
    """What the detector runs for a failure type it classified."""

    name: str

    def handles(self, failure: Failure) -> bool: ...
    async def recover(self, failure: Failure) -> bool: ...


@dataclasses.dataclass
class CallbackStrategy:
    """Adapter: wrap an async callable as a strategy."""

    name: str
    types: tuple[FailureType, ...]
    fn: Callable[[Failure], Awaitable[bool]]

    def handles(self, failure: Failure) -> bool:
        return failure.type in self.types

    async def recover(self, failure: Failure) -> bool:
        return await self.fn(failure)


@dataclasses.dataclass
class DetectorConfig:
    check_interval: float = 10.0
    # hashrate below this fraction of the rolling peak = failure
    hashrate_drop_fraction: float = 0.25
    # no batch completion for this long = stall
    stall_seconds: float = 60.0
    max_recovery_attempts: int = 3
    recovery_cooldown: float = 60.0


class FailureDetector:
    """Watches engine snapshots, classifies failures, runs strategies."""

    def __init__(self, engine, config: DetectorConfig | None = None):
        self.engine = engine
        self.config = config or DetectorConfig()
        self.strategies: list[RecoveryStrategy] = []
        self.failures: list[Failure] = []
        self.recoveries = 0
        self.failed_recoveries = 0
        self._peak_hashrate = 0.0
        self._last_hashes = 0
        self._last_progress = time.time()
        self._last_recovery: dict[str, float] = {}
        # device-state edge detection: DEVICE_HUNG/DEVICE_LOST fire on
        # TRANSITIONS, not on every pass over a still-quarantined device
        self._device_states: dict[str, str | None] = {}
        self._task: asyncio.Task | None = None

    def add_strategy(self, strategy: RecoveryStrategy) -> None:
        self.strategies.append(strategy)

    # -- detection -----------------------------------------------------------

    def check(self, now: float | None = None) -> list[Failure]:
        """One detection pass over the engine snapshot."""
        now = now if now is not None else time.time()
        found: list[Failure] = []
        snap = self.engine.snapshot()
        hashrate = snap.get("hashrate", 0.0)
        hashes = snap.get("hashes", 0)

        if hashes > self._last_hashes:
            self._last_progress = now
        self._last_hashes = hashes

        if hashrate > self._peak_hashrate:
            self._peak_hashrate = hashrate
        elif (
            self._peak_hashrate > 0
            and hashrate < self._peak_hashrate * self.config.hashrate_drop_fraction
            and snap.get("state") == "running"
        ):
            found.append(Failure(
                FailureType.HASHRATE_DROP, "engine",
                f"hashrate {hashrate:.0f} < {self.config.hashrate_drop_fraction:.0%}"
                f" of peak {self._peak_hashrate:.0f}",
            ))

        if (
            snap.get("state") == "running"
            and snap.get("current_job")
            and now - self._last_progress > self.config.stall_seconds
        ):
            found.append(Failure(
                FailureType.BATCH_STALL, "engine",
                f"no hashes for {now - self._last_progress:.0f}s",
            ))

        # device supervision states (engine snapshot devices carry the
        # per-device state machine): emit on entry into quarantine/death
        for name, d in snap.get("devices", {}).items():
            state = d.get("state") if isinstance(d, dict) else None
            prev = self._device_states.get(name)
            if state == prev:
                continue
            self._device_states[name] = state
            if (state in ("quarantined", "probing")
                    and prev not in ("quarantined", "probing", "dead")):
                found.append(Failure(
                    FailureType.DEVICE_HUNG, name,
                    d.get("last_error") or f"device {state}",
                ))
            elif state == "dead" and prev != "dead":
                found.append(Failure(
                    FailureType.DEVICE_LOST, name,
                    d.get("last_error") or "probe budget exhausted",
                ))
        self.failures.extend(found)
        del self.failures[:-256]
        return found

    # -- recovery ------------------------------------------------------------

    async def handle(self, failure: Failure) -> bool:
        key = f"{failure.type.value}:{failure.component}"
        now = time.time()
        if now - self._last_recovery.get(key, 0.0) < self.config.recovery_cooldown:
            return False
        self._last_recovery[key] = now
        for strategy in self.strategies:
            if not strategy.handles(failure):
                continue
            for attempt in range(self.config.max_recovery_attempts):
                try:
                    if await strategy.recover(failure):
                        self.recoveries += 1
                        log.info(
                            "recovered %s via %s (attempt %d)",
                            failure.type.value, strategy.name, attempt + 1,
                        )
                        return True
                except Exception:
                    log.exception("strategy %s raised", strategy.name)
            log.warning("strategy %s exhausted for %s", strategy.name, failure.type.value)
        self.failed_recoveries += 1
        return False

    # -- loop -----------------------------------------------------------------

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.check_interval)
            try:
                for failure in self.check():
                    log.warning("failure detected: %s (%s)", failure.type.value, failure.detail)
                    await self.handle(failure)
            except Exception:
                log.exception("failure check crashed")

    def snapshot(self) -> dict:
        return {
            "failures_detected": len(self.failures),
            "recoveries": self.recoveries,
            "failed_recoveries": self.failed_recoveries,
            "peak_hashrate": self._peak_hashrate,
            "recent": [
                {"type": f.type.value, "component": f.component, "detail": f.detail}
                for f in self.failures[-5:]
            ],
        }


class RecoveryManager:
    """Component health registry with restart policy: components register
    an async health probe and an async restart; the manager polls and
    restarts unhealthy components with exponential backoff."""

    @dataclasses.dataclass
    class _Entry:
        name: str
        probe: Callable[[], Awaitable[bool]]
        restart: Callable[[], Awaitable[None]]
        healthy: bool = True
        restarts: int = 0
        backoff: float = 1.0
        next_attempt: float = 0.0

    def __init__(self, check_interval: float = 10.0, max_backoff: float = 300.0):
        self.check_interval = check_interval
        self.max_backoff = max_backoff
        self._components: dict[str, RecoveryManager._Entry] = {}
        self._task: asyncio.Task | None = None

    def register(self, name: str, probe, restart) -> None:
        self._components[name] = self._Entry(name, probe, restart)

    async def check_all(self, now: float | None = None) -> dict[str, bool]:
        now = now if now is not None else time.time()
        out = {}
        for entry in self._components.values():
            try:
                entry.healthy = bool(await entry.probe())
            except Exception:
                entry.healthy = False
            out[entry.name] = entry.healthy
            if entry.healthy:
                entry.backoff = 1.0
                continue
            if now < entry.next_attempt:
                continue
            log.warning("component %s unhealthy; restarting", entry.name)
            try:
                await entry.restart()
                entry.restarts += 1
            except Exception:
                log.exception("restart of %s failed", entry.name)
            entry.next_attempt = now + entry.backoff
            entry.backoff = min(entry.backoff * 2, self.max_backoff)
        return out

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.check_interval)
            await self.check_all()

    def snapshot(self) -> dict:
        return {
            name: {"healthy": e.healthy, "restarts": e.restarts}
            for name, e in self._components.items()
        }
