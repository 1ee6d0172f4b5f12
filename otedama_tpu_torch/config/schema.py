"""Configuration schema: YAML file + env overrides + validation
(counterpart of ``otedama_tpu/config/schema.py``, with the sections the
solo, pool, upstream, p2p and API paths read: mining, stratum, pool,
work, validation, p2p (with the durable chain store's ``chain_*``
knobs), api, logging and ``upstreams``).

Field names, defaults and validation rules are the reference's, but for
two: ``mining.device`` is the port's own (the torch device the backend
runs on), and ``api.enabled`` defaults to false (the reference: true),
so that no entry point opens a listening socket its caller did not ask
for; ``example_yaml()`` (``cli init``) turns it on. A setting whose code
has not been ported yet is refused by ``validate_config`` with the
ROADMAP item that brings it: the sharded and fleet front-ends and
Stratum V2 (A14), settlement and multi-region replication (A13).
Precedence: env > file > defaults. YAML parsing uses pyyaml when
present, else a minimal two-level parser.
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
    algorithm: str = "sha256d"   # sha256d | sha256 | scrypt | x11 | ethash
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
class StratumSettings:
    enabled: bool = False
    host: str = "0.0.0.0"
    port: int = 3333
    initial_difficulty: float = 1.0
    extranonce2_size: int = 4
    max_clients: int = 10000
    vardiff_target_seconds: float = 10.0
    # the reference's sharded front-end (acceptor worker processes behind
    # one port), Stratum V2 and fleet topology: carried so a config that
    # turns them on is refused by name (ROADMAP A14), never ignored
    workers: int = 0
    v2_enabled: bool = False
    fleet_listen: str = ""
    fleet_ledger: str = ""


@dataclasses.dataclass
class UpstreamConfig:
    url: str = ""                      # host:port
    username: str = ""
    password: str = "x"
    priority: int = 0


@dataclasses.dataclass
class PoolSettings:
    enabled: bool = False
    payout_scheme: str = "PPLNS"
    pplns_window: int = 10000
    fee_percent: float = 1.0
    minimum_payout: int = 100_000
    # per-payout network fee charged to the worker (atomic units); must
    # stay below minimum_payout or nothing is ever payable
    payout_fee: int = 1_000
    # SQLite path (":memory:" for a throwaway ledger) or a postgres:// DSN
    database: str = "otedama.db"
    # the chain node's RPC address; unset = the in-process mock chain
    chain_rpc_url: str = ""
    chain_rpc_user: str = ""
    chain_rpc_password: str = ""


@dataclasses.dataclass
class SettlementSettings:
    """The reference's crash-safe settlement engine: refused while enabled
    until ROADMAP A13 ports it."""

    enabled: bool = False


@dataclasses.dataclass
class RegionSettings:
    """The reference's multi-region replication: refused while enabled
    until ROADMAP A13 ports it."""

    enabled: bool = False


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
class P2PConfig:
    enabled: bool = False
    host: str = "0.0.0.0"
    port: int = 4333
    max_peers: int = 32
    bootstrap: list = dataclasses.field(default_factory=list)  # ["host:port"]
    # -- share chain consensus parameters (p2p/sharechain.py) ----------------
    # every node of one chain must agree on these, like a chain's genesis
    # rules: a share's claimed difficulty must be >= share_difficulty and
    # is verified against its PoW, never trusted
    share_difficulty: float = 1.0
    # PPLNS window in SHARES of the best chain (the pool.pplns_window knob
    # counts stratum submits; this one counts chain shares)
    pplns_window: int = 8192
    # deepest rewind a node will perform when a heavier fork appears;
    # deeper forks are refused and counted (payout-horizon protection)
    max_reorg_depth: int = 96
    # shares dated further than this into the future are rejected (one
    # clock-skewed peer must not pre-date work into everyone's window)
    max_time_skew: float = 300.0
    # intended share production cadence, seconds (capacity planning /
    # future retarget rule; not yet consensus-critical)
    share_interval: float = 10.0
    # shares per locator-sync response page (bounded catch-up after
    # partitions; clamped to the wire MAX_SYNC_PAGE)
    sync_page: int = 200
    # -- durable chain store (p2p/chainstore.py) -----------------------------
    # directory for WAL segments + settled archive + snapshots; empty =
    # in-memory only (a reboot forfeits the window and re-syncs from
    # peers)
    chain_dir: str = ""
    # MOST journal events the store's writer thread folds into one
    # group-fsync (1 = every best-chain event fsynced individually).
    # The commit path never waits on this — it enqueues and returns;
    # the knob shapes the watermark's advance granularity and the
    # crash-loss window (visible as otedama_chain_persist_lag)
    chain_fsync_interval: int = 64
    # segment file rotation threshold, bytes
    chain_segment_bytes: int = 8 << 20
    # durability contract consumers honour ("ack" | "async"):
    #   ack   = a ledger awaits the durability watermark between chain
    #           commit and db transaction, so a miner is never told
    #           "accepted" for a share the journal could lose;
    #   async = verdicts return after the in-memory link; a crash loses
    #           at most the exported persist lag
    chain_durability: str = "ack"
    # bounded event ring between the commit path and the writer thread;
    # a wedged disk that fills it DROPS further journal events (counted,
    # alarmed, healed from peers) instead of stalling the event loop
    chain_ring_max: int = 65536
    # write a snapshot each time the archived boundary advances this
    # many shares (bounds cold-boot replay to ~this + max_reorg_depth)
    chain_snapshot_interval: int = 8192
    # in-memory best-chain tail, shares: settled positions beyond it are
    # archived out of RAM, so pplns_window can reach millions of shares
    # with flat memory (the window is an incremental accumulator)
    chain_tail_shares: int = 16384


@dataclasses.dataclass
class ValidationSettings:
    """Device-batched share validation (runtime/validate.py): the pool
    ledger's batch path ``PoolManager.on_share_batch`` and the p2p gossip
    handlers (``SHARE_BATCH`` and locator-sync pages) verify share batches
    on the card, one dispatch per batch. The single-process stratum
    server books each share through ``on_share`` and never reaches it."""

    enabled: bool = False
    # batches under this many shares are validated on the host
    min_batch: int = 128
    # fraction of every device batch re-verified through the host oracle
    tripwire_rate: float = 0.05
    # seconds the device path stays quarantined after an injected fault
    quarantine_seconds: float = 60.0
    # the x11 tier: "cuda" (kernel B6 on mining.device, the plain version
    # on the CPU) or "numpy" (the host tier's lane-axis pipeline). The
    # reference's names are "jax" and "numpy", and its default "numpy"
    # only because its XLA compile takes minutes
    x11_chain: str = "cuda"


@dataclasses.dataclass
class ApiConfig:
    # off unless asked for (the reference: on); cli init's file turns it on
    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 8080
    rate_limit_per_minute: int = 600
    auth_secret: str = ""              # empty = admin endpoints disabled


@dataclasses.dataclass
class LoggingConfig:
    level: str = "info"
    file: str = ""


@dataclasses.dataclass
class AppConfig:
    mining: MiningConfig = dataclasses.field(default_factory=MiningConfig)
    stratum: StratumSettings = dataclasses.field(default_factory=StratumSettings)
    pool: PoolSettings = dataclasses.field(default_factory=PoolSettings)
    settlement: SettlementSettings = dataclasses.field(
        default_factory=SettlementSettings)
    work: WorkSettings = dataclasses.field(default_factory=WorkSettings)
    region: RegionSettings = dataclasses.field(default_factory=RegionSettings)
    validation: ValidationSettings = dataclasses.field(
        default_factory=ValidationSettings)
    p2p: P2PConfig = dataclasses.field(default_factory=P2PConfig)
    api: ApiConfig = dataclasses.field(default_factory=ApiConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)
    upstreams: list = dataclasses.field(default_factory=list)  # [UpstreamConfig]


_SECTIONS = {
    "mining": MiningConfig,
    "stratum": StratumSettings,
    "pool": PoolSettings,
    "settlement": SettlementSettings,
    "work": WorkSettings,
    "region": RegionSettings,
    "validation": ValidationSettings,
    "p2p": P2PConfig,
    "api": ApiConfig,
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
    ups = data.get("upstreams")
    if isinstance(ups, list):
        cfg.upstreams = [
            UpstreamConfig(**u) if isinstance(u, dict) else u for u in ups
        ]
    elif isinstance(ups, dict):
        # mini-yaml parses "upstreams:" with nested named entries
        cfg.upstreams = [
            UpstreamConfig(**v) for v in ups.values() if isinstance(v, dict)
        ]


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
        elif isinstance(current, list):
            # p2p.bootstrap: a comma-separated host:port list
            coerced = [v.strip() for v in value.split(",") if v.strip()]
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
    for name in ("stratum", "p2p", "api"):
        if not (0 <= getattr(cfg, name).port <= 65535):
            errors.append(f"{name}.port out of range")
    if cfg.stratum.initial_difficulty <= 0:
        errors.append("stratum.initial_difficulty must be positive")
    if not (0 <= cfg.stratum.workers <= 64):
        errors.append("stratum.workers out of range (0..64)")
    # settings whose code is not ported yet: refused by name, never
    # served in part
    if cfg.stratum.workers > 1:
        errors.append("stratum.workers > 1 needs the sharded stratum "
                      "front-end, not ported yet (ROADMAP A14)")
    for name in ("fleet_listen", "fleet_ledger"):
        if getattr(cfg.stratum, name):
            errors.append(f"stratum.{name} needs the fleet topology, not "
                          "ported yet (ROADMAP A14)")
    if cfg.stratum.v2_enabled:
        errors.append("stratum.v2_enabled needs Stratum V2, not ported yet "
                      "(ROADMAP A14)")
    if cfg.settlement.enabled:
        errors.append("settlement.enabled needs the settlement engine, not "
                      "ported yet (ROADMAP A13)")
    if cfg.region.enabled:
        errors.append("region.enabled needs multi-region replication, not "
                      "ported yet (ROADMAP A13)")
    if not (0 <= cfg.pool.fee_percent < 100):
        errors.append("pool.fee_percent out of range")
    if cfg.pool.pplns_window <= 0:
        errors.append("pool.pplns_window must be positive")
    if cfg.pool.payout_fee < 0:
        errors.append("pool.payout_fee must be >= 0")
    if cfg.pool.minimum_payout <= cfg.pool.payout_fee:
        errors.append(
            "pool.minimum_payout must exceed pool.payout_fee "
            "(otherwise no balance is ever payable)"
        )
    if cfg.validation.enabled and not (cfg.pool.enabled or cfg.p2p.enabled):
        errors.append("validation.enabled requires pool.enabled or "
                      "p2p.enabled (there is no share intake to validate "
                      "otherwise)")
    if cfg.validation.min_batch < 1:
        errors.append("validation.min_batch must be >= 1")
    if not (0.0 <= cfg.validation.tripwire_rate <= 1.0):
        errors.append("validation.tripwire_rate must be in [0, 1]")
    if cfg.validation.quarantine_seconds < 0:
        errors.append("validation.quarantine_seconds must be >= 0")
    if cfg.validation.x11_chain not in ("numpy", "cuda"):
        errors.append("validation.x11_chain must be 'numpy' or 'cuda'")
    if cfg.p2p.share_difficulty <= 0:
        errors.append("p2p.share_difficulty must be positive")
    if cfg.p2p.pplns_window <= 0:
        errors.append("p2p.pplns_window must be positive")
    if cfg.p2p.max_reorg_depth < 1:
        errors.append("p2p.max_reorg_depth must be >= 1")
    if cfg.p2p.max_time_skew <= 0:
        errors.append("p2p.max_time_skew must be positive")
    if cfg.p2p.share_interval <= 0:
        errors.append("p2p.share_interval must be positive")
    if cfg.p2p.sync_page < 1:
        errors.append("p2p.sync_page must be >= 1")
    if cfg.p2p.chain_fsync_interval < 1:
        errors.append("p2p.chain_fsync_interval must be >= 1")
    if cfg.p2p.chain_segment_bytes < 4096:
        errors.append("p2p.chain_segment_bytes must be >= 4096")
    if cfg.p2p.chain_snapshot_interval < 1:
        errors.append("p2p.chain_snapshot_interval must be >= 1")
    if cfg.p2p.chain_tail_shares < cfg.p2p.max_reorg_depth:
        errors.append(
            "p2p.chain_tail_shares must be >= p2p.max_reorg_depth "
            "(the mutable suffix must stay in memory)"
        )
    if cfg.p2p.chain_durability not in ("ack", "async"):
        errors.append("p2p.chain_durability must be 'ack' or 'async'")
    if cfg.p2p.chain_ring_max < cfg.p2p.chain_fsync_interval:
        errors.append(
            "p2p.chain_ring_max must be >= p2p.chain_fsync_interval "
            "(the writer must be able to assemble one fsync group)"
        )
    if cfg.work.poll_seconds <= 0:
        errors.append("work.poll_seconds must be positive")
    try:
        bytes.fromhex(cfg.work.payout_script)
    except ValueError:
        errors.append("work.payout_script must be hex")
    return errors


def example_yaml() -> str:
    """The example config ``cli init`` writes: every section the port
    reads, at its defaults, with the API turned on."""
    return """\
# otedama-tpu-torch configuration
mining:
  enabled: true
  algorithm: sha256d     # sha256d | sha256 | scrypt | x11 | ethash
  backend: auto          # auto (= cuda) | cuda | torch | python
  device: cuda           # torch device of the backend
  batch_size: 16777216
  worker_name: otedama-tpu
  precompile: true       # build and warm the kernel before the engine starts
  winner_depth: 0        # winner-table depth K (0 = the kernel default, 16)
  pipeline_depth: 0      # launches per engine group (0 = the default, 3)
  drain_timeout: 30.0    # abandon in-flight device calls past this on stop/switch
  watchdog_multiplier: 8.0   # deadline = call-duration EWMA x this (<=0 = off)
  watchdog_floor: 5.0        # minimum watchdog deadline, seconds
  watchdog_first_deadline: 1800.0  # deadline while a call key has no EWMA
  max_probes: 8          # failed reintegration probes before DEAD (0 = forever)

stratum:
  enabled: false
  host: 0.0.0.0
  port: 3333
  initial_difficulty: 1.0
  extranonce2_size: 4
  max_clients: 10000
  vardiff_target_seconds: 10.0

pool:
  enabled: false
  payout_scheme: PPLNS
  pplns_window: 10000
  fee_percent: 1.0
  minimum_payout: 100000  # atomic units; balances below it carry forward
  payout_fee: 1000        # per-payout network fee charged to the worker
  database: otedama.db    # SQLite path, ":memory:" or a postgres:// DSN

work:
  enabled: false       # originate jobs from a chain node (pool.chain_rpc_url,
                       # or the in-process mock chain)
  poll_seconds: 2.0    # template refresh cadence
  payout_script: ""    # hex scriptPubKey for locally built coinbases
  coinbase_tag: /otedama/  # scriptSig marker after the BIP34 height push

validation:
  enabled: false       # device-batched share validation (needs pool or p2p)
  min_batch: 128       # batches under this many shares verify on the host
  tripwire_rate: 0.05  # host-oracle sample per device batch (corruption trap)
  quarantine_seconds: 60.0  # device-path timeout after an injected fault

p2p:
  enabled: false
  port: 4333
  max_peers: 32
  share_difficulty: 1.0   # chain share difficulty floor (PoW-verified)
  pplns_window: 8192      # PPLNS window in chain shares
  max_reorg_depth: 96     # deepest fork rewind a node will perform
  max_time_skew: 300.0    # reject shares dated further into the future
  share_interval: 10.0    # intended share cadence, seconds
  sync_page: 200          # shares per locator-sync page
  chain_dir: ""           # durable chain store directory (empty = memory only)
  chain_fsync_interval: 64     # max journal events per writer group-fsync
  chain_segment_bytes: 8388608 # segment rotation threshold
  chain_snapshot_interval: 8192  # shares archived between snapshots
  chain_tail_shares: 16384     # in-memory best-chain tail (bounds RAM)
  chain_durability: ack   # ack = a ledger awaits the journal watermark before
                          # any verdict/db row; async = ack immediately,
                          # crash loss bounded by the persist-lag export
  chain_ring_max: 65536   # bounded commit->writer event ring

api:
  enabled: true
  host: 127.0.0.1
  port: 8080

logging:
  level: info
"""
