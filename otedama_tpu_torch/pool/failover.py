"""Upstream pool failover with health-scored strategy selection
(counterpart of ``otedama_tpu/pool/failover.py``, copied whole).

Reference parity: internal/pool/advanced_failover.go:17-225 (upstream set,
health checks: connectivity/latency/reject-rate :713-760, composite scoring
:761, strategies :788-858). Strategies: PRIORITY (ordered list),
PERFORMANCE (best composite score), ROUND_ROBIN, LOAD_BALANCED (weighted by
score). Health probes are TCP connects (the stratum client itself reports
reject rates).
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import logging
import time

from otedama_tpu_torch.utils import faults

log = logging.getLogger("otedama.pool.failover")


class FailoverStrategy(enum.Enum):
    PRIORITY = "priority"
    PERFORMANCE = "performance"
    ROUND_ROBIN = "round-robin"
    LOAD_BALANCED = "load-balanced"


@dataclasses.dataclass
class UpstreamPool:
    name: str
    host: str
    port: int
    priority: int = 0                 # lower = preferred (PRIORITY strategy)
    weight: float = 1.0               # LOAD_BALANCED share
    # live health state
    reachable: bool = True
    latency: float = 0.0              # seconds, EMA
    rejects: int = 0
    accepts: int = 0
    last_check: float = 0.0
    consecutive_failures: int = 0

    @property
    def reject_rate(self) -> float:
        total = self.accepts + self.rejects
        return self.rejects / total if total else 0.0

    def health_score(self) -> float:
        """Composite score in [0, 1]: connectivity gate, then latency and
        reject-rate penalties (reference scoring :761-787)."""
        if not self.reachable:
            return 0.0
        latency_score = 1.0 / (1.0 + self.latency * 10.0)   # 100ms -> 0.5
        reject_score = 1.0 - min(self.reject_rate * 5.0, 1.0)  # 20% rejects -> 0
        return 0.5 * latency_score + 0.5 * reject_score


class FailoverManager:
    def __init__(
        self,
        pools: list[UpstreamPool],
        strategy: FailoverStrategy = FailoverStrategy.PRIORITY,
        check_interval: float = 30.0,
        failure_threshold: int = 3,
    ):
        if not pools:
            raise ValueError("need at least one upstream pool")
        self.pools = pools
        self.strategy = strategy
        self.check_interval = check_interval
        self.failure_threshold = failure_threshold
        self._rr_index = 0
        self._task: asyncio.Task | None = None

    # -- selection ----------------------------------------------------------

    def select(self) -> UpstreamPool:
        healthy = [p for p in self.pools if p.reachable] or self.pools
        if self.strategy == FailoverStrategy.PRIORITY:
            return min(healthy, key=lambda p: p.priority)
        if self.strategy == FailoverStrategy.PERFORMANCE:
            return max(healthy, key=lambda p: p.health_score())
        if self.strategy == FailoverStrategy.ROUND_ROBIN:
            pool = healthy[self._rr_index % len(healthy)]
            self._rr_index += 1
            return pool
        if self.strategy == FailoverStrategy.LOAD_BALANCED:
            # deterministic weighted pick: highest weight*score, ties by least
            # recently used via round-robin offset
            return max(
                healthy, key=lambda p: (p.weight * max(p.health_score(), 1e-6))
            )
        raise ValueError(self.strategy)  # pragma: no cover

    def record_share_result(self, pool: UpstreamPool, accepted: bool) -> None:
        if accepted:
            pool.accepts += 1
        else:
            pool.rejects += 1

    def record_connection_failure(self, pool: UpstreamPool) -> None:
        pool.consecutive_failures += 1
        if pool.consecutive_failures >= self.failure_threshold:
            pool.reachable = False
            log.warning("upstream %s marked unreachable", pool.name)

    # -- health checking ----------------------------------------------------

    async def check_pool(self, pool: UpstreamPool) -> bool:
        t0 = time.monotonic()
        try:
            # fault point inside the timed+caught section so injected
            # unreachability (error) takes the real failure path and
            # injected latency (delay) lands in the measured EMA —
            # exactly how strategy selection sees a degraded upstream
            d = faults.hit("pool.failover.check", pool.name, faults.POINT)
            if d is not None and d.delay:
                await asyncio.sleep(d.delay)
            _, writer = await asyncio.wait_for(
                asyncio.open_connection(pool.host, pool.port), timeout=5.0
            )
            writer.close()
            dt = time.monotonic() - t0
            pool.latency = dt if pool.latency == 0 else 0.3 * dt + 0.7 * pool.latency
            pool.reachable = True
            pool.consecutive_failures = 0
        except (OSError, asyncio.TimeoutError, faults.FaultInjectedError):
            self.record_connection_failure(pool)
        pool.last_check = time.time()
        return pool.reachable

    async def check_all(self) -> None:
        await asyncio.gather(*(self.check_pool(p) for p in self.pools))

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

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
            await self.check_all()
            await asyncio.sleep(self.check_interval)

    def snapshot(self) -> list[dict]:
        return [
            {
                "name": p.name,
                "host": f"{p.host}:{p.port}",
                "reachable": p.reachable,
                "latency_ms": round(p.latency * 1000, 2),
                "reject_rate": round(p.reject_rate, 4),
                "score": round(p.health_score(), 4),
            }
            for p in self.pools
        ]
