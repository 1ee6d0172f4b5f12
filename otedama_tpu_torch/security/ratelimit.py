"""Token-bucket rate limiting + connection guard (counterpart of
``otedama_tpu/security/ratelimit.py``, copied whole).

Reference parity: internal/security/access_control.go:37-62 (token bucket
per client) and the DDoS layer's connection-rate checks. Pure stdlib,
monotonic-clock based, safe to call from asyncio handlers (no awaits).
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class TokenBucket:
    capacity: float
    refill_per_second: float
    tokens: float = dataclasses.field(default=-1.0)
    updated: float = dataclasses.field(default_factory=time.monotonic)

    def __post_init__(self):
        if self.tokens < 0:
            self.tokens = self.capacity

    def allow(self, cost: float = 1.0, now: float | None = None) -> bool:
        now = now if now is not None else time.monotonic()
        self.tokens = min(
            self.capacity, self.tokens + (now - self.updated) * self.refill_per_second
        )
        self.updated = now
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


class RateLimiter:
    """Per-key token buckets with bounded key cardinality (LRU eviction)."""

    def __init__(self, rate_per_minute: float = 600.0, burst: float | None = None,
                 max_keys: int = 65536):
        self.rate_per_second = rate_per_minute / 60.0
        self.burst = burst if burst is not None else max(1.0, rate_per_minute / 10.0)
        self.max_keys = max_keys
        self._buckets: dict[str, TokenBucket] = {}
        self.denied = 0

    def allow(self, key: str, cost: float = 1.0) -> bool:
        bucket = self._buckets.get(key)
        if bucket is None:
            if len(self._buckets) >= self.max_keys:
                # evict oldest-updated half; bounded memory under key floods
                by_age = sorted(self._buckets.items(), key=lambda kv: kv[1].updated)
                for k, _ in by_age[: self.max_keys // 2]:
                    del self._buckets[k]
            bucket = self._buckets[key] = TokenBucket(self.burst, self.rate_per_second)
        ok = bucket.allow(cost)
        if not ok:
            self.denied += 1
        return ok


class ConnectionGuard:
    """Per-IP concurrent connection + connect-rate guard (DDoS layer)."""

    def __init__(self, max_concurrent_per_ip: int = 64,
                 connects_per_minute: float = 120.0, max_keys: int = 65536):
        self.max_concurrent = max_concurrent_per_ip
        self._active: dict[str, int] = {}
        self._rate = RateLimiter(connects_per_minute, max_keys=max_keys)
        self.rejected = 0

    def acquire(self, ip: str) -> bool:
        if self._active.get(ip, 0) >= self.max_concurrent or not self._rate.allow(ip):
            self.rejected += 1
            return False
        self._active[ip] = self._active.get(ip, 0) + 1
        return True

    def release(self, ip: str) -> None:
        n = self._active.get(ip, 0) - 1
        if n <= 0:
            self._active.pop(ip, None)
        else:
            self._active[ip] = n
