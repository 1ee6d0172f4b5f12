"""Configuration schema: YAML file + env overrides + validation
(counterpart of ``otedama_tpu/config/schema.py``, with only the sections
the solo path reads: mining, work, the chain RPC fields of pool, logging).

Field names and defaults are the reference's; ``mining.device`` is the
port's own (the torch device the backend runs on). Precedence: env >
file > defaults. YAML parsing uses pyyaml when present, else a minimal
two-level parser.
"""

from __future__ import annotations

import dataclasses
import os

try:
    import yaml as _yaml  # type: ignore

    def _parse_yaml(text: str) -> dict:
        return _yaml.safe_load(text) or {}

except ImportError:  # pragma: no cover - exercised where pyyaml is absent

    def _parse_yaml(text: str) -> dict:
        return _mini_yaml(text)


def _coerce_scalar(s: str):
    s = s.strip()
    if not s:
        return None
    if s.startswith(("'", '"')) and s.endswith(s[0]) and len(s) >= 2:
        return s[1:-1]
    low = s.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~"):
        return None
    try:
        return int(s, 0)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def _mini_yaml(text: str) -> dict:
    """Two-level indented key/value YAML subset (enough for this schema)."""
    root: dict = {}
    stack: list[tuple[int, dict]] = [(0, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, _, value = line.strip().partition(":")
        while stack and indent < stack[-1][0]:
            stack.pop()
        container = stack[-1][1]
        if value.strip() == "":
            child: dict = {}
            container[key] = child
            stack.append((indent + 2, child))
        else:
            container[key] = _coerce_scalar(value)
    return root


@dataclasses.dataclass
class MiningConfig:
    enabled: bool = True
    algorithm: str = "sha256d"   # sha256d | sha256 | scrypt (litecoin)
    backend: str = "auto"        # auto (= cuda) | cuda | torch | python
    device: str = "cuda"         # torch device of the backend
    batch_size: int = 1 << 24
    worker_name: str = "otedama-tpu"
    # build and warm the kernel (one launch of the planned batch) before
    # the engine starts, so the first job mines instead of building
    precompile: bool = True
    # winner-table depth K of each launch's buffer; 0 = the kernel
    # default (16)
    winner_depth: int = 0
    # launches per engine group; 0 = the engine default (3)
    pipeline_depth: int = 0
    # -- device supervision (engine watchdog / quarantine / probes) ----------
    # bound on stop()/switch drains of in-flight device calls: calls
    # still running past it are abandoned so a wedged device can never
    # hang process exit or an algorithm switch
    drain_timeout: float = 30.0
    # watchdog deadline = per-(backend, call key) call-duration EWMA x
    # this multiplier (floored by watchdog_floor); <= 0 disables the
    # watchdog. A blown deadline quarantines the device; survivors
    # re-shard its extranonce2 block and keep mining
    watchdog_multiplier: float = 8.0
    watchdog_floor: float = 5.0
    # deadline for calls whose key has no EWMA yet (a first call may
    # build the kernel)
    watchdog_first_deadline: float = 1800.0
    # consecutive failed reintegration probes before a quarantined
    # device is marked DEAD (0 = probe forever)
    max_probes: int = 8


@dataclasses.dataclass
class PoolSettings:
    # the solo path reads only the chain node's RPC address; unset = the
    # in-process mock chain
    chain_rpc_url: str = ""
    chain_rpc_user: str = ""
    chain_rpc_password: str = ""


@dataclasses.dataclass
class WorkSettings:
    """Work-source tier: with ``enabled`` the template poll runs every
    ``poll_seconds``, else every 5 s."""

    enabled: bool = False
    poll_seconds: float = 2.0
    # hex scriptPubKey paid by locally built coinbases
    payout_script: str = ""
    # marker pushed in the coinbase scriptSig after the BIP34 height
    coinbase_tag: str = "/otedama/"


@dataclasses.dataclass
class LoggingConfig:
    level: str = "info"
    file: str = ""


@dataclasses.dataclass
class AppConfig:
    mining: MiningConfig = dataclasses.field(default_factory=MiningConfig)
    pool: PoolSettings = dataclasses.field(default_factory=PoolSettings)
    work: WorkSettings = dataclasses.field(default_factory=WorkSettings)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)


_SECTIONS = {
    "mining": MiningConfig,
    "pool": PoolSettings,
    "work": WorkSettings,
    "logging": LoggingConfig,
}


def _apply_dict(cfg: AppConfig, data: dict) -> None:
    for section, cls in _SECTIONS.items():
        sub = data.get(section)
        if not isinstance(sub, dict):
            continue
        target = getattr(cfg, section)
        for f in dataclasses.fields(cls):
            if f.name in sub and sub[f.name] is not None:
                setattr(target, f.name, sub[f.name])


def _apply_env(cfg: AppConfig, environ=None) -> None:
    """OTEDAMA_<SECTION>_<FIELD>=value overrides."""
    environ = environ if environ is not None else os.environ
    for key, value in environ.items():
        if not key.startswith("OTEDAMA_"):
            continue
        parts = key[len("OTEDAMA_"):].lower().split("_", 1)
        if len(parts) != 2:
            continue
        section, field = parts
        if section not in _SECTIONS:
            continue
        target = getattr(cfg, section)
        if not hasattr(target, field):
            continue
        current = getattr(target, field)
        coerced = _coerce_scalar(value)
        if isinstance(current, bool):
            coerced = bool(coerced)
        elif isinstance(current, int) and not isinstance(coerced, int):
            try:
                coerced = int(float(coerced))
            except (TypeError, ValueError):
                continue
        elif isinstance(current, float):
            try:
                coerced = float(coerced)
            except (TypeError, ValueError):
                continue
        elif isinstance(current, str):
            coerced = value
        setattr(target, field, coerced)


def load_config(path: str | None = None, environ=None) -> AppConfig:
    cfg = AppConfig()
    if path and os.path.exists(path):
        with open(path) as f:
            _apply_dict(cfg, _parse_yaml(f.read()))
    _apply_env(cfg, environ)
    errors = validate_config(cfg)
    if errors:
        raise ValueError("invalid config: " + "; ".join(errors))
    return cfg


def validate_config(cfg: AppConfig) -> list[str]:
    errors = []
    from otedama_tpu_torch.engine import algos

    try:
        algos.get(cfg.mining.algorithm)
    except KeyError:
        errors.append(f"unknown algorithm {cfg.mining.algorithm!r}")
    if cfg.mining.backend not in ("auto", "cuda", "torch", "python"):
        errors.append(f"unknown mining.backend {cfg.mining.backend!r}")
    if cfg.mining.batch_size <= 0 or cfg.mining.batch_size > (1 << 32):
        errors.append("mining.batch_size out of range")
    if not (0 <= cfg.mining.winner_depth <= 1024):
        errors.append("mining.winner_depth out of range (0 = auto, 1..1024)")
    if not (0 <= cfg.mining.pipeline_depth <= 64):
        errors.append("mining.pipeline_depth out of range (0 = auto, 1..64)")
    if cfg.mining.drain_timeout <= 0:
        errors.append("mining.drain_timeout must be positive")
    if cfg.mining.watchdog_floor <= 0:
        errors.append("mining.watchdog_floor must be positive")
    if cfg.mining.watchdog_first_deadline <= 0:
        errors.append("mining.watchdog_first_deadline must be positive")
    if cfg.mining.max_probes < 0:
        errors.append("mining.max_probes must be >= 0")
    if cfg.work.poll_seconds <= 0:
        errors.append("work.poll_seconds must be positive")
    try:
        bytes.fromhex(cfg.work.payout_script)
    except ValueError:
        errors.append("work.payout_script must be hex")
    return errors
