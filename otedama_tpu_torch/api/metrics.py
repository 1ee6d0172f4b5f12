"""Prometheus metrics registry (text exposition format, no client library;
counterpart of ``otedama_tpu/api/metrics.py``).

Reference parity: internal/monitoring/unified_monitoring.go:48-77 — the
same metric family names are kept so the reference's Grafana dashboards and
alert rules (docs/en/DEPLOYMENT_GUIDE.md:569-573 `otedama_hashrate`) work
against this implementation unchanged.
"""

from __future__ import annotations

import contextlib
import threading
import time


def _fmt_labels(labels: dict[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{str(v).replace(chr(92), chr(92)*2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class MetricsRegistry:
    """Thread-safe gauge/counter registry rendering Prometheus text format."""

    def __init__(self):
        # reentrant: ``atomic()`` holds it across a batch of per-op
        # calls (which each take it again) so a concurrent render never
        # observes a half-rebuilt family
        self._lock = threading.RLock()
        # name -> (help, type, {labelstr: value})
        self._metrics: dict[str, tuple[str, str, dict[str, float]]] = {}

    @contextlib.contextmanager
    def atomic(self):
        """Hold the registry lock across several mutations: a family
        rebuilt via clear_family + re-set must flip in one step with
        respect to a concurrent /metrics render, or scrape timing makes
        gauges vanish and counters appear to reset."""
        with self._lock:
            yield self

    def _slot(self, name: str, help_: str, type_: str) -> dict[str, float]:
        if name not in self._metrics:
            self._metrics[name] = (help_, type_, {})
        return self._metrics[name][2]

    def clear_family(self, name: str) -> None:
        """Drop every label set of a family (help/type kept). For
        families mirrored per-entity from an authoritative snapshot
        (e.g. per-device supervision series): an entity that left the
        snapshot — a pod replaced by its degraded rebuild — must not
        keep exporting its last value forever."""
        with self._lock:
            entry = self._metrics.get(name)
            if entry is not None:
                entry[2].clear()

    def gauge_set(self, name: str, value: float, labels: dict | None = None,
                  help_: str = "") -> None:
        with self._lock:
            self._slot(name, help_, "gauge")[_fmt_labels(labels)] = float(value)

    def counter_add(self, name: str, delta: float = 1.0,
                    labels: dict | None = None, help_: str = "") -> None:
        with self._lock:
            slot = self._slot(name, help_, "counter")
            key = _fmt_labels(labels)
            slot[key] = slot.get(key, 0.0) + float(delta)

    def counter_set(self, name: str, value: float, labels: dict | None = None,
                    help_: str = "") -> None:
        """For counters mirrored from an authoritative stats struct."""
        with self._lock:
            self._slot(name, help_, "counter")[_fmt_labels(labels)] = float(value)

    def histogram_set(
        self,
        name: str,
        bucket_counts: dict[float, float],
        sum_: float,
        count: float,
        labels: dict | None = None,
        help_: str = "",
    ) -> None:
        """Mirror a histogram from an authoritative stats struct.

        ``bucket_counts``: upper-bound -> CUMULATIVE count (le semantics);
        the +Inf bucket is added automatically from ``count``.
        """
        import math

        with self._lock:
            slot = self._slot(name, help_, "histogram")
            base = dict(labels or {})
            # keys carry the numeric le so render can emit buckets in
            # ascending order with +Inf last (required by the exposition
            # format; a string sort would put "+Inf" first)
            for le, v in sorted(bucket_counts.items()):
                slot[("bucket", float(le), _fmt_labels({**base, "le": f"{le:g}"}))] = float(v)
            slot[("bucket", math.inf, _fmt_labels({**base, "le": "+Inf"}))] = float(count)
            slot[("sum", math.inf, _fmt_labels(base))] = float(sum_)
            slot[("count", math.inf, _fmt_labels(base))] = float(count)

    def render(self) -> str:
        lines = []
        with self._lock:
            for name in sorted(self._metrics):
                help_, type_, series = self._metrics[name]
                if help_:
                    lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {type_}")
                def _order(kv):
                    key = kv[0]
                    if isinstance(key, tuple):  # (suffix, le, labelstr)
                        # buckets ascend by le with +Inf last, then _count,
                        # then _sum (both carry le=inf)
                        rank = {"bucket": 0, "count": 1, "sum": 2}[key[0]]
                        return (1, key[1], rank, key[2])
                    return (0, 0.0, 0, str(key))

                for key, value in sorted(series.items(), key=_order):
                    if isinstance(key, tuple):  # histogram component
                        suffix, _le, labelstr = key
                        full = f"{name}_{suffix}{labelstr}"
                    else:
                        full = f"{name}{key}"
                    if value == int(value) and abs(value) < 1e15:
                        lines.append(f"{full} {int(value)}")
                    else:
                        lines.append(f"{full} {value}")
        return "\n".join(lines) + "\n"


class SystemCollector:
    """Process-level gauges (the reference exports cpu/mem/goroutines;
    we export cpu/mem/threads/uptime from /proc — no psutil in the image)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.started = time.time()
        self._last_cpu: tuple[float, float] | None = None

    def collect(self) -> None:
        reg = self.registry
        reg.gauge_set("otedama_uptime_seconds", time.time() - self.started,
                      help_="Process uptime")
        try:
            with open("/proc/self/stat") as f:
                parts = f.read().split()
            utime, stime = int(parts[13]), int(parts[14])
            hz = 100.0
            cpu_seconds = (utime + stime) / hz
            now = time.time()
            if self._last_cpu is not None:
                dt = now - self._last_cpu[0]
                if dt > 0:
                    reg.gauge_set(
                        "otedama_cpu_usage_percent",
                        100.0 * (cpu_seconds - self._last_cpu[1]) / dt,
                        help_="Process CPU usage",
                    )
            self._last_cpu = (now, cpu_seconds)
            reg.gauge_set("otedama_threads", int(parts[19]),
                          help_="OS threads (the reference exports goroutines)")
        except (OSError, IndexError, ValueError):
            pass
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        kb = int(line.split()[1])
                        reg.gauge_set("otedama_memory_usage_bytes", kb * 1024,
                                      help_="Resident memory")
                        break
        except (OSError, IndexError, ValueError):
            pass
