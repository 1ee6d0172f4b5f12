"""Per-IP DDoS protection for the stratum/API listeners (counterpart of
``otedama_tpu/security/ddos.py``, copied whole).

Reference parity: internal/security/ddos_protection.go (per-IP limiter +
block list + pattern detection) and threat_detector.go's connection checks.
Redesigned to the three guards that matter for a mining listener:

- connection guard: concurrent-connection and connect-rate caps per IP
  (delegates to security.ratelimit.ConnectionGuard);
- bandwidth guard: a sliding-window byte budget per IP — a client
  spraying megabytes of junk lines gets cut off even if each line is
  cheap to reject;
- strike/ban ledger: protocol violations (malformed JSON, oversized
  lines, junk submissions) accumulate strikes; past the threshold the IP
  is banned for ``ban_seconds`` and connects are refused outright.

All clocks are injectable for tests.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

from otedama_tpu_torch.security.ratelimit import ConnectionGuard


@dataclasses.dataclass
class DDoSConfig:
    max_concurrent_per_ip: int = 32
    connects_per_minute: float = 120.0
    bytes_per_window: int = 1 << 20      # 1 MiB ...
    window_seconds: float = 10.0         # ... per 10 s sliding window
    strikes_before_ban: int = 10
    ban_seconds: float = 600.0
    strike_decay_seconds: float = 300.0


class DDoSProtection:
    def __init__(self, config: DDoSConfig | None = None):
        self.config = config or DDoSConfig()
        self.guard = ConnectionGuard(
            max_concurrent_per_ip=self.config.max_concurrent_per_ip,
            connects_per_minute=self.config.connects_per_minute,
        )
        # ip -> deque[(timestamp, nbytes)]; running totals kept alongside so
        # per-line accounting stays O(1) amortized (re-summing the deque
        # would make the guard itself a quadratic CPU-exhaustion vector)
        self._bytes: dict[str, deque] = {}
        self._bytes_total: dict[str, int] = {}
        # ip -> deque[timestamp] of strikes
        self._strikes: dict[str, deque] = {}
        self._bans: dict[str, float] = {}  # ip -> ban expiry
        self.stats = {
            "refused_banned": 0,
            "refused_connect": 0,
            "bandwidth_cut": 0,
            "strikes": 0,
            "bans": 0,
        }
        self._connects_since_cleanup = 0

    # -- connection lifecycle -------------------------------------------------

    def allow_connect(self, ip: str, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        # opportunistic housekeeping: rotating-source floods must not turn
        # the per-IP tables themselves into a memory-exhaustion vector
        self._connects_since_cleanup += 1
        if self._connects_since_cleanup >= 256:
            self._connects_since_cleanup = 0
            self.cleanup(now=now)
        if self.banned(ip, now=now):
            self.stats["refused_banned"] += 1
            return False
        if not self.guard.acquire(ip):
            self.stats["refused_connect"] += 1
            return False
        return True

    def release(self, ip: str) -> None:
        self.guard.release(ip)

    # -- bandwidth ------------------------------------------------------------

    def track_bytes(self, ip: str, n: int, now: float | None = None) -> bool:
        """Record ``n`` received bytes; False = budget exceeded, cut the
        connection (and strike — sustained flooding becomes a ban)."""
        now = time.monotonic() if now is None else now
        dq = self._bytes.setdefault(ip, deque())
        dq.append((now, n))
        total = self._bytes_total.get(ip, 0) + n
        cutoff = now - self.config.window_seconds
        while dq and dq[0][0] < cutoff:
            total -= dq.popleft()[1]
        self._bytes_total[ip] = total
        if total > self.config.bytes_per_window:
            self.stats["bandwidth_cut"] += 1
            self.strike(ip, "bandwidth", now=now)
            return False
        return True

    # -- strikes / bans -------------------------------------------------------

    def strike(self, ip: str, reason: str = "", now: float | None = None) -> bool:
        """Record one protocol violation; True if the IP is now banned."""
        now = time.monotonic() if now is None else now
        dq = self._strikes.setdefault(ip, deque())
        cutoff = now - self.config.strike_decay_seconds
        while dq and dq[0] < cutoff:
            dq.popleft()
        dq.append(now)
        self.stats["strikes"] += 1
        if len(dq) >= self.config.strikes_before_ban:
            self._bans[ip] = now + self.config.ban_seconds
            self.stats["bans"] += 1
            dq.clear()
            return True
        return False

    def banned(self, ip: str, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        expiry = self._bans.get(ip)
        if expiry is None:
            return False
        if now >= expiry:
            del self._bans[ip]
            return False
        return True

    # -- housekeeping ---------------------------------------------------------

    def cleanup(self, now: float | None = None) -> None:
        """Drop idle per-IP state (called periodically by the owner)."""
        now = time.monotonic() if now is None else now
        cutoff = now - max(self.config.window_seconds * 2,
                           self.config.strike_decay_seconds)
        for ip in list(self._bytes):
            dq = self._bytes[ip]
            total = self._bytes_total.get(ip, 0)
            while dq and dq[0][0] < cutoff:
                total -= dq.popleft()[1]
            if dq:
                self._bytes_total[ip] = total
            else:
                del self._bytes[ip]
                self._bytes_total.pop(ip, None)
        for ip in list(self._strikes):
            dq = self._strikes[ip]
            while dq and dq[0] < cutoff:
                dq.popleft()
            if not dq:
                del self._strikes[ip]
        for ip in list(self._bans):
            if now >= self._bans[ip]:
                del self._bans[ip]

    def snapshot(self) -> dict:
        return {
            **self.stats,
            "active_bans": len(self._bans),
            "tracked_ips": len(self._bytes),
        }
