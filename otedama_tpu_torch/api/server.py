"""REST + WebSocket + Prometheus API server (counterpart of
``otedama_tpu/api/server.py``; it serves the port's own copies of the web
pages, under ``otedama_tpu_torch/web``).

Reference parity: internal/api/server.go:334-407 (route table) — the
/api/v1 surface below mirrors the reference's resource names; /metrics
serves the Prometheus family of unified_monitoring.go; /ws pushes periodic
stats snapshots (monitoring/unified_monitoring.go:403-530 WS broadcast).

Decoupling: the server renders *snapshot providers* (name -> callable), so
any subsystem (engine, pool, p2p, switcher) plugs in without the API
importing it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import logging
import time
from typing import Callable

from otedama_tpu_torch.api.http import HttpServer, Request, Response, WebSocket
from otedama_tpu_torch.api.metrics import MetricsRegistry, SystemCollector
from otedama_tpu_torch.security.auth import AuthManager, TokenError
from otedama_tpu_torch.security.ratelimit import RateLimiter

log = logging.getLogger("otedama.api")


class _BadQuery(ValueError):
    """Malformed query-string parameter (rendered as a 400)."""


@dataclasses.dataclass
class ApiConfig:
    host: str = "127.0.0.1"
    port: int = 8080
    rate_limit_per_minute: float = 600.0
    ws_push_seconds: float = 2.0
    auth_secret: str = ""            # empty = admin/control routes disabled


class ApiServer:
    def __init__(self, config: ApiConfig | None = None,
                 registry: MetricsRegistry | None = None):
        self.config = config or ApiConfig()
        self.registry = registry or MetricsRegistry()
        self.system_collector = SystemCollector(self.registry)
        self.providers: dict[str, Callable[[], dict]] = {}
        self.controls: dict[str, Callable] = {}   # name -> async control fn
        # fn(actor, action, limit) -> list[dict]; the app wires the pool
        # db's query_audit here (utils.logging_setup.AuditLogger.query is
        # signature-compatible if a file-based trail is ever configured);
        # unwired -> /api/v1/logs/audit answers 404
        self.audit_source: Callable | None = None
        # settlement operator surface (the app wires the settlement
        # engine): fn() -> list of {worker, balance, paid_total}, and
        # fn(limit) -> {pending, recent} payout intents. Unwired ->
        # /api/v1/balances and /api/v1/payouts answer 404.
        self.balances_source: Callable[[], list] | None = None
        self.payouts_source: Callable[[int], dict] | None = None
        # readiness source for /health: a callable returning at least
        # {"status": "ok" | "degraded" | "unready"} (the app wires the
        # engine's device_health). ok/degraded answer 200 — degraded
        # means serving at reduced capacity, still serving — while
        # unready (no device able to mine) answers 503 so orchestrators
        # rotate traffic away. Unwired -> the legacy always-ok health.
        self.health_source: Callable[[], dict] | None = None
        self.auth: AuthManager | None = (
            AuthManager(self.config.auth_secret) if self.config.auth_secret else None
        )
        self.limiter = RateLimiter(self.config.rate_limit_per_minute)
        self.http = HttpServer(self.config.host, self.config.port)
        self.started_at = time.time()
        self._install_routes()

    # -- wiring ---------------------------------------------------------------

    def add_provider(self, name: str, fn: Callable[[], dict]) -> None:
        self.providers[name] = fn

    def add_control(self, name: str, fn: Callable) -> None:
        """Async fn(params: dict) -> dict; exposed as POST /api/v1/control/{name},
        requires auth when configured."""
        self.controls[name] = fn

    async def start(self) -> None:
        await self.http.start()

    async def stop(self) -> None:
        await self.http.stop()

    @property
    def port(self) -> int:
        return self.http.port

    # -- routes ---------------------------------------------------------------

    def _install_routes(self) -> None:
        h = self.http
        h.middleware(self._rate_limit)
        h.route("GET", "/health", self._health)
        h.route("GET", "/api/v1/status", self._status)
        h.route("GET", "/api/v1/stats", self._status)
        h.route("GET", "/api/v1/stats/{name}", self._stats_one)
        h.route("GET", "/api/v1/algorithms", self._algorithms)
        h.route("GET", "/api/v1/controls", self._list_controls)
        # settlement operator surface (reference parity: the payout
        # routes of internal/api/server.go)
        h.route("GET", "/api/v1/balances", self._balances)
        h.route("GET", "/api/v1/payouts", self._payouts)
        # log query surface (reference parity: internal/api/log_routes.go
        # over internal/logging/analyzer.go)
        h.route("GET", "/api/v1/logs", self._logs)
        h.route("GET", "/api/v1/logs/analyze", self._logs_analyze)
        h.route("GET", "/api/v1/logs/audit", self._logs_audit)
        h.route("GET", "/metrics", self._metrics)
        h.route("POST", "/api/v1/auth/login", self._login)
        h.route("POST", "/api/v1/control/{name}", self._control)
        h.websocket("/ws", self._ws_stats)
        # web UI (reference parity: web/static dashboard + web/admin pages);
        # all three pages are self-contained HTML, served from the package
        h.route("GET", "/", self._page("static/index.html"))
        h.route("GET", "/admin", self._page("admin/index.html"))
        h.route("GET", "/admin/login", self._page("admin/login.html"))

    @staticmethod
    def _page(rel: str):
        """Handler serving one self-contained page from otedama_tpu_torch/web.
        Content is read per request (tiny files) so a deploy-time edit to
        the page shows up without a restart."""
        import pathlib

        path = pathlib.Path(__file__).resolve().parent.parent / "web" / rel

        async def handler(request: Request) -> Response:
            try:
                body = path.read_text(encoding="utf-8")
            except OSError:
                return Response.error(404, f"page {rel} not installed")
            return Response(200, body, "text/html; charset=utf-8")

        return handler

    async def _list_controls(self, request: Request) -> Response:
        """Names only (invocation still requires auth) — feeds the admin UI."""
        return Response.json(sorted(self.controls))

    async def _rate_limit(self, request: Request) -> Response | None:
        if not self.limiter.allow(request.peer):
            return Response.error(429, "rate limited")
        return None

    async def _health(self, request: Request) -> Response:
        body = {
            "status": "ok",
            "uptime_seconds": round(time.time() - self.started_at, 1),
        }
        if self.health_source is not None:
            try:
                body.update(self.health_source())
            except Exception as e:  # a broken source is NOT healthy
                log.exception("health source failed")
                return Response.json(
                    {"status": "error", "error": str(e)}, 500
                )
        status = 200 if body.get("status") in ("ok", "degraded") else 503
        return Response.json(body, status)

    def _snapshot(self) -> dict:
        out = {}
        for name, fn in self.providers.items():
            try:
                out[name] = fn()
            except Exception as e:  # one broken provider must not kill /status
                log.exception("provider %s failed", name)
                out[name] = {"error": str(e)}
        return out

    async def _status(self, request: Request) -> Response:
        return Response.json({"timestamp": time.time(), **self._snapshot()})

    async def _stats_one(self, request: Request) -> Response:
        name = request.params["name"]
        fn = self.providers.get(name)
        if fn is None:
            return Response.error(404, f"no stats provider {name!r}")
        return Response.json(fn())

    async def _balances(self, request: Request) -> Response:
        """Carried worker balances + lifetime paid totals (?worker=
        filters to one) — the settlement engine's balance table."""
        if self.balances_source is None:
            return Response.error(404, "no settlement engine wired")
        try:
            balances = self.balances_source()
        except Exception as e:
            log.exception("balances source failed")
            return Response.error(500, f"balances source failed: {e}")
        worker = request.query.get("worker")
        if worker:
            balances = [b for b in balances if b.get("worker") == worker]
        return Response.json({"count": len(balances), "balances": balances})

    async def _payouts(self, request: Request) -> Response:
        """Pending payout intents + recent outcomes (?limit=) from the
        idempotency-keyed ledger."""
        if self.payouts_source is None:
            return Response.error(404, "no settlement engine wired")
        try:
            limit = min(max(int(request.query.get("limit", "100")), 1), 1000)
        except ValueError:
            return Response.error(400, "limit must be an integer")
        try:
            out = self.payouts_source(limit)
        except Exception as e:
            log.exception("payouts source failed")
            return Response.error(500, f"payouts source failed: {e}")
        return Response.json(out)

    async def _algorithms(self, request: Request) -> Response:
        from otedama_tpu_torch.engine import algos

        out = []
        for name in algos.names():
            spec = algos.get(name)
            out.append({
                "name": spec.name,
                "implemented": spec.implemented(),
                "backends": list(spec.backends),
                "memory_hard": spec.memory_hard,
                "chained": spec.chained,
            })
        return Response.json(out)

    async def _metrics(self, request: Request) -> Response:
        self.system_collector.collect()
        return Response(
            200, self.registry.render(),
            "text/plain; version=0.0.4; charset=utf-8",
        )

    # -- log query surface ----------------------------------------------------

    def _authorize_logs(self, request: Request) -> Response | None:
        """Logs and the audit trail carry actor names and operational
        detail: when auth is configured, they require a ``logs.read``
        token (operator/admin). With no auth_secret the API is a
        loopback-default single-user surface and stays open — same
        posture as /api/v1/status."""
        if self.auth is None:
            return None
        header = request.headers.get("authorization", "")
        token = header[7:] if header.lower().startswith("bearer ") else ""
        try:
            self.auth.authorize(token, "logs.read")
        except TokenError as e:
            return Response.error(401, str(e))
        return None

    @staticmethod
    def _float_q(request: Request, key: str) -> float | None:
        raw = request.query.get(key)
        if raw is None or raw == "":
            return None
        try:
            return float(raw)
        except ValueError:
            raise _BadQuery(f"{key} must be a unix timestamp, got {raw!r}")

    async def _logs(self, request: Request) -> Response:
        """Structured log tail with filters:
        ?level=warning&component=otedama.stratum&since=<ts>&until=<ts>
        &q=<substring>&limit=200."""
        from otedama_tpu_torch.utils.logging_setup import memory_log

        denied = self._authorize_logs(request)
        if denied is not None:
            return denied
        q = request.query
        try:
            since = self._float_q(request, "since")
            until = self._float_q(request, "until")
            limit = int(q.get("limit", "200"))
        except (_BadQuery, ValueError) as e:
            return Response.error(400, str(e))
        records = memory_log().query(
            level=q.get("level"),
            component=q.get("component"),
            since=since,
            until=until,
            contains=q.get("q"),
            limit=min(max(limit, 1), 2000),
        )
        return Response.json({"count": len(records), "logs": records})

    async def _logs_analyze(self, request: Request) -> Response:
        """Pattern/burst analysis over the in-memory tail
        (internal/logging/analyzer.go parity)."""
        from otedama_tpu_torch.utils.logging_setup import LogAnalyzer, memory_log

        denied = self._authorize_logs(request)
        if denied is not None:
            return denied
        records = memory_log().query(limit=4096)
        lines = (
            f"x x {e['level']}    {e['component']}: {e['message']}"
            for e in records
        )
        out = LogAnalyzer().analyze(lines)
        out["window_records"] = len(records)
        return Response.json(out)

    async def _logs_audit(self, request: Request) -> Response:
        """Audit-trail query (?actor=&action=&limit=) over the wired
        audit source (the pool db's audit_log; 404 when no source is
        wired — miner mode keeps no audit trail)."""
        denied = self._authorize_logs(request)
        if denied is not None:
            return denied
        if self.audit_source is None:
            return Response.error(404, "no audit source wired")
        q = request.query
        try:
            limit = min(max(int(q.get("limit", "100")), 1), 2000)
        except ValueError:
            return Response.error(400, "limit must be an integer")
        try:
            entries = self.audit_source(
                q.get("actor") or None, q.get("action") or None, limit
            )
        except Exception as e:
            log.exception("audit source failed")
            return Response.error(500, f"audit source failed: {e}")
        return Response.json({"count": len(entries), "audit": entries})

    async def _login(self, request: Request) -> Response:
        from otedama_tpu_torch.security import validation as val

        if self.auth is None:
            return Response.error(403, "auth disabled (no api.auth_secret)")
        try:
            body = request.json() or {}
            username = str(body.get("username", ""))
            # defense in depth ahead of auth/db: a username carrying an
            # injection payload is rejected without reaching the registry
            # (the threat class is reported, never the payload)
            threat = val.contains_injection(username)
            if threat is not None or len(username) > 128:
                return Response.error(401, f"bad username ({threat or 'length'})")
            token = self.auth.login(
                username,
                str(body.get("password", "")),
                str(body.get("totp", "")),
            )
        except (json.JSONDecodeError, TokenError) as e:
            return Response.error(401, str(e))
        return Response.json({"token": token})

    async def _control(self, request: Request) -> Response:
        name = request.params["name"]
        fn = self.controls.get(name)
        if fn is None:
            return Response.error(404, f"no control {name!r}")
        if self.auth is None:
            return Response.error(403, "control requires api.auth_secret")
        header = request.headers.get("authorization", "")
        token = header[7:] if header.lower().startswith("bearer ") else ""
        try:
            claims = self.auth.authorize(token, "mining.control")
        except TokenError as e:
            return Response.error(401, str(e))
        try:
            params = request.json() or {}
        except json.JSONDecodeError:
            return Response.error(400, "bad json body")
        try:
            result = await fn(params)
        except Exception as e:
            log.exception("control %s failed", name)
            return Response.error(500, str(e))
        return Response.json({"ok": True, "by": claims.get("sub"), "result": result})

    async def _ws_stats(self, request: Request, ws: WebSocket) -> None:
        """Push stats snapshots until the client goes away.

        The reader runs as its own task (pings/close handling) — cancelling
        ``recv`` mid-frame would desync the stream, so it is never raced
        against a timeout."""
        reader = asyncio.create_task(self._ws_drain(ws))
        try:
            while not ws.closed:
                await ws.send_json({"timestamp": time.time(), **self._snapshot()})
                await asyncio.sleep(self.config.ws_push_seconds)
        except (ConnectionError, RuntimeError):
            pass
        finally:
            reader.cancel()
            try:
                await reader
            except (asyncio.CancelledError, Exception):
                pass

    @staticmethod
    async def _ws_drain(ws: WebSocket) -> None:
        try:
            while await ws.recv() is not None:
                pass
        except Exception:
            ws.closed = True

    # -- metric sync ----------------------------------------------------------

    # mirrors runtime.supervision.DeviceState VALUES as literals: the
    # API layer renders snapshot providers without importing subsystem
    # modules (decoupling rule at the top of this file); a test pins the
    # two in sync (test_device_supervision.test_device_state_names_in_sync)
    _DEVICE_STATES = ("healthy", "suspect", "quarantined", "probing", "dead")

    _DEVICE_FAMILIES = (
        "otedama_device_hashrate",
        "otedama_device_state",
        "otedama_device_quarantines_total",
        "otedama_device_searcher_restarts_total",
        "otedama_device_abandoned_calls_total",
        "otedama_device_call_seconds",
    )

    def sync_engine_metrics(self, snapshot: dict) -> None:
        """Map an engine snapshot onto the reference's metric names."""
        reg = self.registry
        reg.gauge_set("otedama_hashrate", snapshot.get("hashrate", 0.0),
                      help_="Total hashrate in H/s")
        # per-device families mirror the snapshot exactly: a device that
        # left it (degraded-mesh replacement/removal) must not keep a
        # latched quarantined=1 series paging forever. Atomic so a
        # concurrent scrape never sees the cleared-but-unrebuilt gap
        with reg.atomic():
            for family in self._DEVICE_FAMILIES:
                reg.clear_family(family)
            self._set_device_metrics(snapshot)
        shares = snapshot.get("shares", {})
        for status in ("found", "accepted", "rejected", "stale"):
            reg.counter_set("otedama_shares_total", shares.get(status, 0),
                            {"status": status}, help_="Share counters")
        reg.counter_set("otedama_blocks_found_total",
                        snapshot.get("blocks_found", 0), help_="Blocks found")
        reg.counter_set(
            "otedama_device_relayouts_total", snapshot.get("relayouts", 0),
            help_="Searcher-layout rebuilds (extranonce2 re-shards)",
        )

    def _set_device_metrics(self, snapshot: dict) -> None:
        reg = self.registry
        for device, d in snapshot.get("devices", {}).items():
            reg.gauge_set("otedama_device_hashrate", d.get("hashrate", 0.0),
                          {"device": device}, help_="Per-device hashrate")
            state = d.get("state")
            if state is None:
                continue  # unsupervised engine snapshot (older shape)
            # one-hot state family: the standard Prometheus enum shape,
            # alertable as otedama_device_state{state="quarantined"} == 1
            for s in self._DEVICE_STATES:
                reg.gauge_set(
                    "otedama_device_state", 1.0 if s == state else 0.0,
                    {"device": device, "state": s},
                    help_="Device supervision state (one-hot per state)",
                )
            reg.counter_set(
                "otedama_device_quarantines_total",
                d.get("quarantines", 0), {"device": device},
                help_="Watchdog quarantines per device",
            )
            reg.counter_set(
                "otedama_device_searcher_restarts_total",
                d.get("searcher_restarts", 0), {"device": device},
                help_="Searcher restarts after backend exceptions",
            )
            reg.counter_set(
                "otedama_device_abandoned_calls_total",
                d.get("abandoned_calls", 0), {"device": device},
                help_="Device calls abandoned past a watchdog/drain deadline",
            )
            hist = d.get("call_seconds") or {}
            if hist.get("count"):
                reg.histogram_set(
                    "otedama_device_call_seconds",
                    hist["buckets"],
                    hist["sum"],
                    hist["count"],
                    labels={"device": device},
                    help_="Device call durations (the watchdog's model input)",
                )

    def sync_rpc_pool_metrics(self, chains: dict) -> None:
        """Connection-pool telemetry for the blockchain RPC endpoints
        (utils/netpool) — the reuse/latency counters are how the pool's
        effect stays observable in production."""
        for endpoint, chain in chains.items():
            snapshot = getattr(chain, "pool_snapshot", None)
            if snapshot is None:
                continue  # e.g. MockChainClient: no network, no pool
            snap = snapshot()
            for key in ("requests", "reused", "opened", "retries",
                        "errors"):
                self.registry.counter_set(
                    f"otedama_rpc_{key}_total", snap[key],
                    {"endpoint": endpoint},
                    help_="Blockchain RPC connection-pool counters",
                )
            self.registry.gauge_set(
                "otedama_rpc_latency_ema_seconds",
                snap["latency_ema_ms"] / 1e3, {"endpoint": endpoint},
                help_="RPC request latency EMA",
            )
            self.registry.gauge_set(
                "otedama_rpc_idle_connections", snap["idle"],
                {"endpoint": endpoint},
                help_="Pooled keep-alive connections currently idle",
            )

    def sync_client_metrics(self, client) -> None:
        """Export the stratum client's measured share-accept latency
        distribution (BASELINE config 4; reference target <50 ms)."""
        if getattr(client, "latency_count", 0) <= 0:
            return
        self.registry.histogram_set(
            "otedama_share_latency_seconds",
            dict(client.latency_buckets),
            client.latency_sum,
            client.latency_count,
            help_="Share submit->verdict latency",
        )

    def sync_p2p_metrics(self, snapshot: dict) -> None:
        """Share-chain + overlay health from a P2PPool snapshot: chain
        height/tip work (is this node converged?), reorg and orphan
        pressure (is the overlay partitioning?), and verification rejects
        (is a peer feeding us garbage?)."""
        reg = self.registry
        chain = snapshot.get("chain", {})
        reg.gauge_set("otedama_p2p_peers", snapshot.get("peers", 0),
                      help_="Connected overlay peers")
        reg.gauge_set("otedama_p2p_chain_height", chain.get("height", 0),
                      help_="Best share-chain height")
        # tip work is an exact 256-bit int; the float cast is lossy but
        # monotone, which is all a convergence gauge needs
        reg.gauge_set("otedama_p2p_tip_work", float(chain.get("tip_work", 0)),
                      help_="Cumulative work of the best share-chain tip")
        reg.gauge_set("otedama_p2p_orphans", chain.get("orphans", 0),
                      help_="Shares held waiting for their parent")
        reg.gauge_set("otedama_p2p_reorg_depth_max",
                      chain.get("deepest_reorg", 0),
                      help_="Deepest reorg performed since start")
        reg.counter_set("otedama_p2p_reorgs_total", chain.get("reorgs", 0),
                        help_="Best-tip reorgs performed")
        reg.counter_set("otedama_p2p_reorgs_refused_total",
                        chain.get("reorgs_refused", 0),
                        help_="Forks refused for exceeding max reorg depth")
        reg.counter_set("otedama_p2p_shares_connected_total",
                        chain.get("shares_connected", 0),
                        help_="PoW-verified shares linked into the chain")
        reg.counter_set("otedama_p2p_shares_rejected_total",
                        snapshot.get("shares_rejected", 0),
                        help_="Gossiped shares failing verification")
        reg.counter_set("otedama_p2p_share_verify_failures_total",
                        snapshot.get("verify_failures", 0),
                        help_="Share verifications lost to internal/injected errors")
        with reg.atomic():
            reg.clear_family("otedama_p2p_share_rejects")
            for reason, count in snapshot.get("rejects", {}).items():
                reg.counter_set(
                    "otedama_p2p_share_rejects", count, {"reason": reason},
                    help_="Share rejections by verification failure reason",
                )

    def sync_region_metrics(self, snapshot: dict,
                            server_snapshot: dict | None = None) -> None:
        """Multi-region replication health from a RegionReplicator
        snapshot (+ the stratum server's handoff counters): is THIS
        region the settlement leader, is the commit path keeping up
        (pending commits draining, recommits healing fork races), and
        are handoffs landing (resumes accepted vs rejected)."""
        reg = self.registry
        reg.gauge_set("otedama_region_id", snapshot.get("region_id", 0),
                      help_="This front-end's region id / extranonce1 prefix")
        reg.gauge_set("otedama_region_is_leader",
                      1.0 if snapshot.get("is_leader") else 0.0,
                      help_="1 when this region is the elected settlement writer")
        reg.gauge_set("otedama_region_pending_commits",
                      snapshot.get("pending_commits", 0),
                      help_="Chain commits not yet settled-safe (reorg window)")
        reg.counter_set("otedama_region_commits_total",
                        snapshot.get("commits", 0),
                        help_="Accepted shares committed to the share chain")
        reg.counter_set("otedama_region_recommits_total",
                        snapshot.get("recommits", 0),
                        help_="Commits re-mined after falling off the best chain")
        reg.counter_set("otedama_region_commit_failures_total",
                        snapshot.get("commit_failures", 0),
                        help_="Chain commits that failed (share was rejected)")
        with reg.atomic():
            reg.clear_family("otedama_region_share_rejects")
            for reason, count in snapshot.get("share_rejects", {}).items():
                reg.counter_set(
                    "otedama_region_share_rejects", count,
                    {"reason": reason},
                    help_="Cross-region share rejections by reason",
                )
        if server_snapshot:
            reg.counter_set("otedama_region_resumes_accepted_total",
                            server_snapshot.get("resumes_accepted", 0),
                            help_="Miner sessions resumed from a signed token")
            reg.counter_set("otedama_region_resumes_rejected_total",
                            server_snapshot.get("resumes_rejected", 0),
                            help_="Resume tokens refused (fresh session instead)")

    def sync_settlement_metrics(self, snapshot: dict) -> None:
        """Settlement/payout pipeline health from a SettlementEngine
        snapshot: ledger progress (settled count, cursor vs horizon),
        money movement (credited/sent amounts), and the exactly-once
        alarms (failures, lost verdicts healed, wallet dedup hits)."""
        reg = self.registry
        reg.counter_set("otedama_settlement_settled_total",
                        snapshot.get("settlements_settled", 0),
                        help_="Settlements driven to the settled state")
        reg.counter_set("otedama_settlement_failures_total",
                        snapshot.get("settle_failures", 0),
                        help_="Settlement ticks aborted mid-pipeline (replayed)")
        reg.counter_set("otedama_settlement_resumed_total",
                        snapshot.get("resumes", 0),
                        help_="Half-applied settlements replayed after restart")
        reg.counter_set("otedama_settlement_credited_amount_total",
                        snapshot.get("credited_amount", 0),
                        help_="Atomic units credited to worker balances")
        reg.counter_set("otedama_settlement_horizon_violations_total",
                        snapshot.get("horizon_violations", 0),
                        help_="Settlements refused: cursor not on the local chain")
        reg.gauge_set("otedama_settlement_last_height",
                      snapshot.get("last_tip_height", 0),
                      help_="Chain position the ledger has consumed up to")
        reg.gauge_set("otedama_settlement_unsettled_shares",
                      snapshot.get("unsettled_shares", 0),
                      help_="Immutable shares awaiting settlement")
        totals = snapshot.get("payout_totals", {})
        sent = totals.get("sent", {})
        pending = totals.get("pending", {})
        reg.counter_set("otedama_payout_sent_total",
                        sent.get("count", 0),
                        help_="Payout intents paid out (exactly once)")
        reg.counter_set("otedama_payout_sent_amount_total",
                        sent.get("amount", 0),
                        help_="Atomic units paid out")
        reg.counter_set("otedama_payout_failed_total",
                        totals.get("failed", {}).get("count", 0),
                        help_="Payout intents whose send failed (retried via balance)")
        reg.gauge_set("otedama_payout_pending",
                      pending.get("count", 0),
                      help_="Payout intents awaiting submission")
        reg.gauge_set("otedama_payout_pending_amount",
                      pending.get("amount", 0),
                      help_="Atomic units awaiting submission")
        reg.counter_set("otedama_payout_verdicts_lost_total",
                        snapshot.get("submit_verdicts_lost", 0),
                        help_="Wallet sends whose verdict was lost pre-record")
        reg.counter_set("otedama_payout_duplicates_avoided_total",
                        snapshot.get("wallet_duplicates_avoided", 0),
                        help_="Re-submitted batches deduplicated by idempotency key")

    def sync_worksource_metrics(self, snapshot: dict) -> None:
        """Work-source tier health from a TemplateSource snapshot: the
        template lifecycle (age, refresh latency, rejects — a stale or
        rejected template means the job stream is serving old work) and
        the AuxPoW merged-mining funnel (chains tracked, aux blocks
        found/submitted/accepted/rejected, per chain)."""
        reg = self.registry
        reg.gauge_set("otedama_worksource_template_height",
                      snapshot.get("template_height", 0),
                      help_="Height of the last good template")
        reg.gauge_set("otedama_worksource_template_age_seconds",
                      snapshot.get("template_age_seconds", -1.0),
                      help_="Seconds since the last good template "
                            "(-1 = never fetched)")
        reg.gauge_set("otedama_worksource_refresh_seconds",
                      snapshot.get("refresh_ema_seconds", 0.0),
                      help_="Template refresh latency (EMA over polls)")
        reg.counter_set("otedama_worksource_templates_fetched_total",
                        snapshot.get("templates_fetched", 0),
                        help_="Templates fetched from the chain node")
        reg.counter_set("otedama_worksource_templates_rejected_total",
                        snapshot.get("templates_rejected", 0),
                        help_="Templates rejected as impossible "
                              "(last good job served on)")
        reg.counter_set("otedama_worksource_rpc_failures_total",
                        snapshot.get("rpc_failures", 0),
                        help_="Template fetches that failed at the RPC layer")
        reg.counter_set("otedama_worksource_jobs_emitted_total",
                        snapshot.get("jobs_emitted", 0),
                        help_="Jobs originated from local templates")
        reg.counter_set("otedama_worksource_clean_jobs_total",
                        snapshot.get("clean_jobs", 0),
                        help_="Emitted jobs that flushed miner work "
                              "(new tip)")
        reg.counter_set("otedama_worksource_race_refreshes_total",
                        snapshot.get("race_refreshes", 0),
                        help_="Same-height template refreshes "
                              "(template races / aux slate changes)")
        aux = snapshot.get("aux") or {}
        reg.gauge_set("otedama_worksource_aux_chains",
                      aux.get("chains", 0),
                      help_="Aux chains merged-mined against the parent")
        reg.counter_set("otedama_worksource_aux_refresh_failures_total",
                        aux.get("refresh_failures", 0),
                        help_="Aux work refreshes that failed or returned "
                              "invalid work (last good unit kept)")
        reg.counter_set("otedama_worksource_aux_found_total",
                        aux.get("found", 0),
                        help_="Parent shares that met an aux chain target")
        reg.counter_set("otedama_worksource_aux_submitted_total",
                        aux.get("submitted", 0),
                        help_="AuxPoW proofs submitted to aux chains")
        reg.counter_set("otedama_worksource_aux_accepted_total",
                        aux.get("accepted", 0),
                        help_="Aux blocks accepted by their chains")
        reg.counter_set("otedama_worksource_aux_rejected_total",
                        aux.get("rejected", 0),
                        help_="AuxPoW proofs rejected by their chains")
        for name, per in (aux.get("per_chain") or {}).items():
            labels = {"chain": name}
            reg.counter_set("otedama_worksource_aux_chain_accepted_total",
                            per.get("accepted", 0), labels=labels,
                            help_="Aux blocks accepted, per chain")
            reg.counter_set("otedama_worksource_aux_chain_rejected_total",
                            per.get("rejected", 0), labels=labels,
                            help_="AuxPoW proofs rejected, per chain")
            reg.gauge_set("otedama_worksource_aux_chain_height",
                          per.get("height", 0), labels=labels,
                          help_="Last known aux work height, per chain")

    def sync_chain_metrics(self, chain: dict) -> None:
        """Durable share-chain health from a ShareChain snapshot (the
        ``chain`` sub-dict of the P2P snapshot): the memory bound (tail
        vs archived), the durability gap (persist lag = best-chain
        events a kill -9 right now would lose), segment/snapshot
        pressure, and the boot replay cost."""
        reg = self.registry
        reg.gauge_set("otedama_chain_archived_height",
                      chain.get("archived_height", 0),
                      help_="Best-chain positions archived out of memory")
        reg.gauge_set("otedama_chain_tail_shares", chain.get("tail", 0),
                      help_="Best-chain positions held in memory")
        reg.gauge_set("otedama_chain_window_workers",
                      chain.get("acc_workers", 0),
                      help_="Workers in the incremental PPLNS window accumulator")
        reg.counter_set("otedama_chain_persist_failures_total",
                        chain.get("persist_failures", 0),
                        help_="Chain persistence operations that failed "
                              "(chain served on, durability degraded)")
        store = chain.get("store")
        if not store:
            return
        reg.gauge_set("otedama_chain_persist_lag", store.get("persist_lag", 0),
                      help_="Best-chain events linked but not yet covered by "
                            "the durability watermark (lost by a crash right "
                            "now; peers restore them)")
        reg.gauge_set("otedama_chain_persisted_height",
                      store.get("persisted_height", -1),
                      help_="Durability watermark: highest best-chain "
                            "position the journal fsync has covered")
        reg.gauge_set("otedama_chain_writer_ring_depth",
                      store.get("ring_depth", 0),
                      help_="Events queued between the commit path and the "
                            "journal writer thread")
        reg.gauge_set("otedama_chain_writer_degraded",
                      1.0 if store.get("degraded") else 0.0,
                      help_="1 while the journal writer's last pass hit an "
                            "IO failure (durability degraded, not wedged)")
        reg.gauge_set("otedama_chain_persist_lag_alarm",
                      1.0 if store.get("lag_alarm") else 0.0,
                      help_="1 while the persist lag has stayed above the "
                            "sustained-lag threshold (writer not keeping up)")
        reg.counter_set("otedama_chain_writer_errors_total",
                        store.get("writer_errors", 0),
                        help_="Writer-thread IO/fsync failures (the "
                              "watermark advanced degraded-but-visible)")
        reg.counter_set("otedama_chain_ring_dropped_total",
                        store.get("ring_dropped", 0),
                        help_="Journal events dropped because the writer "
                              "ring was full (wedged disk backpressure)")
        fb = store.get("fsync_batch") or {}
        if fb.get("count"):
            reg.histogram_set(
                "otedama_chain_fsync_batch_size",
                dict(zip(fb.get("bounds", []), fb.get("counts", []))),
                fb.get("sum", 0.0), fb.get("count", 0),
                help_="Best-chain events folded into each writer "
                      "group-fsync")
        reg.gauge_set("otedama_chain_snapshot_age_seconds",
                      store.get("snapshot_age_seconds", -1),
                      help_="Seconds since the last chain snapshot (-1 = none)")
        reg.gauge_set("otedama_chain_snapshot_height",
                      store.get("snapshot_height", -1),
                      help_="Archived boundary of the last chain snapshot")
        reg.gauge_set("otedama_chain_replay_seconds",
                      store.get("replay_seconds", 0.0),
                      help_="Journal replay duration of the last cold boot")
        reg.counter_set("otedama_chain_replayed_records_total",
                        store.get("replayed_records", 0),
                        help_="Journal events replayed on the last cold boot")
        reg.counter_set("otedama_chain_snapshot_failures_total",
                        store.get("snapshot_failures", 0),
                        help_="Chain snapshots refused or lost")
        for kind in ("journal", "archive"):
            log_ = store.get(kind, {})
            labels = {"log": kind}
            reg.gauge_set("otedama_chain_segments", log_.get("segments", 0),
                          labels=labels,
                          help_="Chain store segment files, by log")
            reg.gauge_set("otedama_chain_segment_bytes", log_.get("bytes", 0),
                          labels=labels,
                          help_="Chain store bytes on disk, by log")
            reg.counter_set("otedama_chain_appends_total",
                            log_.get("appends", 0), labels=labels,
                            help_="Records appended, by log")
            reg.counter_set("otedama_chain_fsyncs_total",
                            log_.get("fsyncs", 0), labels=labels,
                            help_="Batched fsyncs performed, by log")
            reg.counter_set("otedama_chain_torn_records_total",
                            log_.get("torn_records", 0), labels=labels,
                            help_="Torn/corrupt records detected at replay")

    def sync_validation_metrics(self, validator) -> None:
        """Device-batched share-validation health (runtime/validate.py
        ValidationBackend): the device/host split, the batch-size shape
        (is batching actually amortizing?), the executor queue depth
        (host-path backpressure), and the corruption alarms."""
        reg = self.registry
        snap = validator.snapshot()
        for path in ("device", "host"):
            reg.counter_set(
                "otedama_validation_shares_total",
                snap.get(f"validated_{path}", 0),
                labels={"path": path},
                help_="Shares validated, by execution path")
        reg.counter_set("otedama_validation_rejects_total",
                        snap.get("rejects", 0),
                        help_="Shares that failed batched validation")
        reg.counter_set("otedama_validation_device_errors_total",
                        snap.get("device_errors", 0),
                        help_="Device validation dispatch failures")
        reg.counter_set("otedama_validation_overflows_total",
                        snap.get("overflows", 0),
                        help_="Failure tables overflowed (batch re-verified on host)")
        reg.counter_set("otedama_validation_tripwire_checks_total",
                        snap.get("tripwire_checks", 0),
                        help_="Host-oracle tripwire samples")
        reg.counter_set("otedama_validation_tripwire_mismatches_total",
                        snap.get("tripwire_mismatches", 0),
                        help_="Device verdicts contradicted by the host oracle")
        reg.gauge_set("otedama_validation_device_ok",
                      1 if snap.get("device_ok") else 0,
                      help_="Device validation path live (0 = quarantined/off)")
        reg.gauge_set("otedama_validation_executor_queue_depth",
                      snap.get("executor_queue_depth", 0),
                      help_="Pending host validations on the shared executor")
        batches = validator.batch_sizes
        if batches.count > 0:
            reg.histogram_set(
                "otedama_validation_batch_size",
                batches.cumulative(), batches.sum, batches.count,
                help_="Shares per validation batch")
        for path, hist in (("device", validator.device_seconds),
                           ("host", validator.host_seconds)):
            if hist.count > 0:
                reg.histogram_set(
                    "otedama_validation_seconds",
                    hist.cumulative(), hist.sum, hist.count,
                    labels={"path": path},
                    help_="Validation batch latency, by execution path")

    def sync_native_metrics(self, snap: dict) -> None:
        """Native batch-path health (utils/native_batch.py): the
        native/python call split per op (is the fast path actually
        taken?), refused-load + faulted-call fallbacks, tripwire alarms
        (MUST stay 0 — a mismatch means the .so disagreed with the
        python oracle), and the batch-size shape the whole win rides
        on (windows/groups must clear the crossover constants)."""
        reg = self.registry
        for op, paths in snap.get("calls", {}).items():
            for path, count in paths.items():
                reg.counter_set(
                    "otedama_native_calls_total", count,
                    labels={"op": op, "path": path},
                    help_="Batch-op calls, by op and execution path")
        reg.counter_set("otedama_native_fallbacks_total",
                        snap.get("fallbacks", 0),
                        help_="Native paths degraded to python "
                              "(refused library or faulted call)")
        reg.counter_set("otedama_native_tripwire_mismatches_total",
                        snap.get("tripwire_mismatches", 0),
                        help_="Native outputs contradicted by the python "
                              "oracle (op permanently degraded)")
        reg.gauge_set("otedama_native_available",
                      1 if snap.get("available") else 0,
                      help_="Native batch library loaded and ABI-matched")
        tripped = snap.get("tripped", {})
        reg.gauge_set("otedama_native_tripped",
                      1 if any(tripped.values()) else 0,
                      help_="Any op pinned to python by a tripwire mismatch")
        for op, state in snap.get("batch_sizes", {}).items():
            if state.get("count", 0) > 0:
                reg.histogram_set(
                    "otedama_native_batch_size",
                    dict(zip(state["bounds"], state["counts"])),
                    state["sum"], state["count"], labels={"op": op},
                    help_="Records per native batch call, by op")

    def sync_pool_server_metrics(self, server=None, server_v2=None) -> None:
        """Export the POOL-side share-accept latency SLO histograms
        (submit-received -> verdict-written, per protocol). The client
        histogram above measures the wire-inclusive half from a miner's
        seat; these measure what the servers themselves owe the <50 ms
        target at four-digit connection counts."""
        for protocol, srv in (("v1", server), ("v2", server_v2)):
            hist = getattr(srv, "latency", None)
            if hist is None or hist.count <= 0:
                continue
            self.registry.histogram_set(
                "otedama_pool_share_latency_seconds",
                hist.cumulative(),
                hist.sum,
                hist.count,
                labels={"protocol": protocol},
                help_="Pool share submit-received->verdict-written latency",
            )
        if server_v2 is not None:
            # V2 scale seams: channel-resume handoffs and
            # duplicate refusals (local window + cross-worker bus +
            # chain-backed region index) — the counters an operator
            # watches during a worker crash or a region failover.
            # counters(), not snapshot(): the latency histogram was
            # already merged + exported above, and the sharded view's
            # snapshot would merge every worker's histogram AGAIN
            snap = server_v2.counters()
            reg = self.registry
            for verdict, key in (("accepted", "resumes_accepted"),
                                 ("rejected", "resumes_rejected")):
                reg.counter_set(
                    "otedama_sv2_channel_resumes_total",
                    snap.get(key, 0), {"verdict": verdict},
                    help_="SV2 channel-resume token verdicts",
                )
            reg.counter_set(
                "otedama_sv2_duplicates_refused_total",
                snap.get("duplicates_refused", 0),
                help_="SV2 shares refused as duplicates beyond the "
                      "channel-local window",
            )
            reg.gauge_set(
                "otedama_sv2_channels", snap.get("channels", 0),
                help_="Open SV2 channels",
            )
            reg.gauge_set(
                "otedama_sv2_channels_resumed",
                snap.get("channels_resumed", 0),
                help_="Open SV2 channels recovered via resume tokens",
            )
        # group-commit ledger shape (ShardSupervisor only): how many
        # shares each flush carried and how long it took — the knee of
        # the batched-commit curve, alarmed on like any latency SLO
        batches = getattr(server, "batch_sizes", None)
        if batches is not None and batches.count > 0:
            self.registry.histogram_set(
                "otedama_ledger_batch_size",
                batches.cumulative(),
                batches.sum,
                batches.count,
                help_="Shares per group-commit ledger flush",
            )
        flushes = getattr(server, "flush_latency", None)
        if flushes is not None and flushes.count > 0:
            self.registry.histogram_set(
                "otedama_ledger_flush_seconds",
                flushes.cumulative(),
                flushes.sum,
                flushes.count,
                help_="Group-commit ledger flush latency",
            )
        # fleet registry (a ledger host serving the TCP share bus):
        # membership and remote capacity — the first gauges an operator
        # reads when an acceptor host drops out of the fleet
        fleet_fn = getattr(server, "fleet_snapshot", None)
        fleet = (fleet_fn()
                 if fleet_fn is not None
                 and getattr(server, "fleet_address", None) is not None
                 else None)
        if fleet is not None:
            reg = self.registry
            hosts = fleet.get("hosts", {})
            reg.gauge_set(
                "otedama_fleet_hosts", len(hosts),
                help_="Acceptor hosts currently joined to this ledger")
            reg.gauge_set(
                "otedama_fleet_remote_workers",
                fleet.get("remote_workers", 0),
                help_="Acceptor worker links from remote fleet hosts")
            reg.counter_set(
                "otedama_fleet_hosts_joined_total",
                fleet.get("hosts_joined", 0),
                help_="Fleet host joins since start")
            reg.counter_set(
                "otedama_fleet_hosts_left_total",
                fleet.get("hosts_left", 0),
                help_="Fleet host departures (leave or crash) since start")
            for h, info in hosts.items():
                reg.gauge_set(
                    "otedama_fleet_host_workers_alive",
                    info.get("workers_alive", 0), {"host": str(h)},
                    help_="Live acceptor workers per fleet host")

    def sync_profit_metrics(self, snapshot: dict) -> None:
        """Profit orchestration telemetry from a ProfitOrchestrator
        snapshot: per-coin profitability, feed freshness/failures, and
        the switch state machine's verdict/hold counters."""
        reg = self.registry
        with reg.atomic():
            # label sets churn as coins/feeds come and go: a vanished
            # coin must not latch its last profit estimate forever
            reg.clear_family("otedama_profit_per_day")
            for coin, d in (snapshot.get("profit") or {}).items():
                reg.gauge_set(
                    "otedama_profit_per_day",
                    d.get("profit_per_day", 0.0), {"coin": coin},
                    help_="Estimated profit per day by coin (fiat)",
                )
        for name, d in (snapshot.get("feeds") or {}).items():
            labels = {"feed": name}
            age = d.get("age_seconds")
            if age is not None:
                reg.gauge_set("otedama_profit_feed_age_seconds", age,
                              labels, help_="Seconds since the feed last "
                              "delivered sane market data")
            reg.gauge_set("otedama_profit_feed_stale",
                          1.0 if d.get("stale") else 0.0, labels,
                          help_="1 when the feed is past its staleness "
                          "horizon (stale data holds, never switches)")
            reg.counter_set("otedama_profit_feed_failures_total",
                            d.get("failures", 0), labels,
                            help_="Feed fetch errors (retried with backoff)")
            reg.counter_set("otedama_profit_feed_rejected_total",
                            d.get("rejected", 0), labels,
                            help_="Corrupt market rows the sanitizer dropped")
        for verdict, n in (snapshot.get("switches") or {}).items():
            reg.counter_set("otedama_switches_total", n,
                            {"verdict": verdict},
                            help_="Algorithm switch outcomes by verdict")
        for reason, n in (snapshot.get("holds") or {}).items():
            reg.counter_set("otedama_switch_holds_total", n,
                            {"reason": reason},
                            help_="Switch decisions held, by reason")
        reg.counter_set("otedama_switch_failures_total",
                        snapshot.get("switch_failures", 0),
                        help_="Failed switch attempts (rolled back)")
        reg.gauge_set("otedama_switch_downtime_seconds",
                      snapshot.get("last_switch_downtime_seconds", 0.0),
                      help_="Mining downtime of the last committed switch")
        reg.gauge_set("otedama_profit_market_stale",
                      1.0 if snapshot.get("market_stale") else 0.0,
                      help_="1 when ALL market data is stale (HOLD)")
