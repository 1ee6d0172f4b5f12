"""Logging factory: rotation, module levels, audit trail, log analyzer,
queryable in-memory tail (counterpart of
``otedama_tpu/utils/logging_setup.py``).

Reference parity: internal/logging/config.go:8-70 (zap factory with
rotation + sampling + per-module levels), audit.go:13 (audit logger),
analyzer.go:16 (log pattern analyzer), api/log_routes.go (the query
surface — served here by ``MemoryLogHandler`` + api/server's
``/api/v1/logs`` routes). Stdlib logging equivalents.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import logging.handlers
import re
import threading
import time
from collections import Counter


@dataclasses.dataclass
class LogConfig:
    level: str = "info"
    file: str = ""
    max_bytes: int = 32 * 1024 * 1024
    backups: int = 5
    module_levels: dict = dataclasses.field(default_factory=dict)
    # drop repeated identical messages beyond N per interval (zap sampling)
    sample_after: int = 0
    sample_interval: float = 1.0


class _SamplingFilter(logging.Filter):
    def __init__(self, after: int, interval: float):
        super().__init__()
        self.after = after
        self.interval = interval
        self._window_start = 0.0
        self._counts: Counter = Counter()

    def filter(self, record: logging.LogRecord) -> bool:
        now = time.monotonic()
        if now - self._window_start > self.interval:
            self._window_start = now
            self._counts.clear()
        key = (record.name, record.levelno, record.msg)
        self._counts[key] += 1
        return self._counts[key] <= self.after


class MemoryLogHandler(logging.Handler):
    """Bounded in-memory tail of structured records — the data source for
    the ``/api/v1/logs`` query route (reference parity:
    internal/api/log_routes.go over internal/logging's buffer). One
    process-wide instance is installed by ``setup_logging`` and reachable
    via ``memory_log()``; cost per record is one dict append."""

    def __init__(self, capacity: int = 4096):
        super().__init__()
        self._records: collections.deque = collections.deque(maxlen=capacity)
        self._rlock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry = {
                "ts": record.created,
                "level": record.levelname,
                "component": record.name,
                "message": record.getMessage(),
            }
        except Exception:  # a bad %-format must never kill the app
            entry = {
                "ts": record.created,
                "level": record.levelname,
                "component": record.name,
                "message": str(record.msg),
            }
        with self._rlock:
            self._records.append(entry)

    def query(
        self,
        level: str | None = None,
        component: str | None = None,
        since: float | None = None,
        until: float | None = None,
        contains: str | None = None,
        limit: int = 200,
    ) -> list[dict]:
        """Newest-last filtered slice. ``level`` is a MINIMUM severity
        ("warning" returns warnings and errors); ``component`` matches
        the logger-name prefix ("otedama.stratum" catches its children)."""
        min_no = (
            logging.getLevelName(level.upper()) if level else 0
        )
        if not isinstance(min_no, int):  # unknown name -> no level filter
            min_no = 0
        needle = contains.lower() if contains else None
        with self._rlock:
            records = list(self._records)
        out = []
        for e in records:
            if logging.getLevelName(e["level"]) < min_no:
                continue
            if component and not e["component"].startswith(component):
                continue
            if since is not None and e["ts"] < since:
                continue
            if until is not None and e["ts"] > until:
                continue
            if needle and needle not in e["message"].lower():
                continue
            out.append(e)
        return out[-max(limit, 0):]


_MEMORY_HANDLER: MemoryLogHandler | None = None


def memory_log() -> MemoryLogHandler:
    """The process-wide log tail (installed on the root logger on first
    use, so the query API works even before ``setup_logging`` ran)."""
    global _MEMORY_HANDLER
    if _MEMORY_HANDLER is None:
        _MEMORY_HANDLER = MemoryLogHandler()
        logging.getLogger().addHandler(_MEMORY_HANDLER)
    return _MEMORY_HANDLER


def setup_logging(config: LogConfig | None = None) -> logging.Logger:
    config = config or LogConfig()
    root = logging.getLogger()
    root.setLevel(getattr(logging, config.level.upper(), logging.INFO))
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)-7s %(name)s: %(message)s"
    )
    handlers: list[logging.Handler] = [logging.StreamHandler()]
    if config.file:
        handlers.append(logging.handlers.RotatingFileHandler(
            config.file, maxBytes=config.max_bytes, backupCount=config.backups
        ))
    for h in handlers:
        h.setFormatter(fmt)
        if config.sample_after > 0:
            h.addFilter(_SamplingFilter(config.sample_after, config.sample_interval))
        root.addHandler(h)
    memory_log()  # queryable tail rides along unconditionally
    for module, level in config.module_levels.items():
        logging.getLogger(module).setLevel(
            getattr(logging, str(level).upper(), logging.INFO)
        )
    return root


class AuditLogger:
    """Append-only JSONL audit trail (who did what when)."""

    def __init__(self, path: str):
        self.path = path

    def record(self, actor: str, action: str, detail: str = "",
               outcome: str = "ok") -> None:
        entry = {
            "ts": time.time(),
            "actor": actor,
            "action": action,
            "detail": detail,
            "outcome": outcome,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")

    def query(self, actor: str | None = None, action: str | None = None,
              limit: int = 100) -> list[dict]:
        out = []
        try:
            with open(self.path) as f:
                for line in f:
                    try:
                        entry = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if actor and entry.get("actor") != actor:
                        continue
                    if action and entry.get("action") != action:
                        continue
                    out.append(entry)
        except FileNotFoundError:
            return []
        return out[-limit:]


class LogAnalyzer:
    """Pattern frequency + error-burst detection over log lines."""

    LINE_RE = re.compile(
        r"^\S+ \S+ (?P<level>\w+)\s+(?P<module>[\w.]+): (?P<message>.*)$"
    )

    def analyze(self, lines) -> dict:
        levels: Counter = Counter()
        modules: Counter = Counter()
        errors: Counter = Counter()
        for line in lines:
            m = self.LINE_RE.match(line.strip())
            if not m:
                continue
            levels[m["level"]] += 1
            modules[m["module"]] += 1
            if m["level"] in ("ERROR", "CRITICAL", "WARNING"):
                # normalize numbers/hex so identical error shapes group
                normalized = re.sub(r"0x[0-9a-fA-F]+|\d+", "#", m["message"])
                errors[normalized] += 1
        return {
            "levels": dict(levels),
            "top_modules": modules.most_common(10),
            "top_errors": errors.most_common(10),
        }
