"""Application composition root + lifecycle (counterpart of
``otedama_tpu/app.py``: ``_build_engine``, ``_on_share``, the
single-server pool side, the work source, the validator wiring, the
stratum listeners, ``_start_miner_side``'s upstream, loopback and chain
branches, upstream failover, precompile-then-start,
``_start_supervision``, ``_start_api``, ``_metrics_loop``, ``stop``,
``snapshot``). Modes:

- solo: the engine mines jobs from a ``TemplateSource`` polling a chain
  client — the node named by ``pool.chain_rpc_url`` through
  ``BitcoinRPCClient``, else the in-process mock chain — and every share
  that meets the network target is submitted to the chain as a block;
- pool (``pool.enabled``): a ``StratumServer`` serves miners jobs from a
  ``TemplateSource`` through ``PoolManager.job_from_template``; every
  accepted share is booked by ``PoolManager.on_share`` (one SQLite
  transaction) and a block goes through ``on_block`` to the chain. With
  mining on, the engine mines for the pool through a loopback
  ``StratumClient``;
- upstream (``upstreams``): the engine mines for outside pools through a
  ``StratumClient``, re-pointed by a ``FailoverManager``;
- p2p (``p2p.enabled``, with the pool: ``cli p2p``): a ``P2PPool`` node
  joins the gossip overlay and keeps the PoW-verified share chain,
  catching up by locator sync; gossip batches and sync pages verify
  through the one ``ValidationBackend`` (B2 for a sha256d chain, B5's
  verify path for a scrypt chain) when ``validation.enabled``. With
  ``p2p.chain_dir`` the chain is durable (``p2p/chainstore.py``): the
  node cold-boots from its segments and snapshot before it joins the
  overlay, so locator sync covers only what a crash cut off.

The books go to SQLite or PostgreSQL (``pool.database``). A
``FailureDetector`` and a ``RecoveryManager`` supervise the engine. With
``api.enabled`` an ``ApiServer`` serves ``/health`` (the engine's device
supervision), ``/metrics`` (synced every 5 s), ``/api/v1/status`` and the
web pages. The reference's sharded front-end, Stratum V2, settlement,
regions and merged mining are not ported yet (``config/schema.py``
refuses them by name), and neither are their API providers.
"""

from __future__ import annotations

import asyncio
import logging
import time

from otedama_tpu_torch.api.server import ApiConfig as ApiServerConfig
from otedama_tpu_torch.api.server import ApiServer
from otedama_tpu_torch.config.schema import AppConfig
from otedama_tpu_torch.engine.algo_manager import AlgorithmManager
from otedama_tpu_torch.engine.engine import EngineConfig, MiningEngine
from otedama_tpu_torch.engine.jobs import header_from_share
from otedama_tpu_torch.engine.types import Share
from otedama_tpu_torch.engine.vardiff import VardiffConfig
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.pool.blockchain import BitcoinRPCClient, MockChainClient
from otedama_tpu_torch.runtime.failure import (
    CallbackStrategy,
    FailureDetector,
    FailureType,
    RecoveryManager,
)
from otedama_tpu_torch.work.template import TemplateSource

log = logging.getLogger("otedama.app")


def parse_upstream_url(url: str, default_port: int = 3333) -> tuple[str, int]:
    """'pool.example.com', 'host:3333' and 'stratum+tcp://host:3333' all work."""
    rest = url.strip()
    if "://" in rest:
        rest = rest.split("://", 1)[1]
    rest = rest.rstrip("/")
    host, _, port_str = rest.rpartition(":")
    if not host:
        return rest, default_port
    try:
        return host, int(port_str)
    except ValueError:
        return rest, default_port


def _chain_client(cfg: AppConfig):
    """The chain client the config names: the node at
    ``pool.chain_rpc_url``, else the in-process mock chain."""
    if cfg.pool.chain_rpc_url:
        return BitcoinRPCClient(cfg.pool.chain_rpc_url, cfg.pool.chain_rpc_user,
                                cfg.pool.chain_rpc_password)
    return MockChainClient()


class Application:
    """``chain``: the chain client the solo miner or the pool works
    against; None builds the one the config names (the in-process mock
    chain when ``pool.chain_rpc_url`` is unset)."""

    def __init__(self, config: AppConfig | None = None, *, chain=None):
        self.config = config or AppConfig()
        self.algo_manager = AlgorithmManager(self.config.mining.backend,
                                             device=self.config.mining.device)
        self.engine: MiningEngine | None = None
        self._chain_arg = chain
        self.chain = None           # chain client (solo mode)
        self.client = None          # stratum client (upstream / loopback)
        self.server = None          # stratum server (pool mode)
        self.pool = None            # pool manager
        self.db = None
        self.validator = None       # device-batched share validation
        self.failover = None        # upstream failover manager
        self.p2p = None             # P2P share-chain node
        self.api: ApiServer | None = None
        self._upstream_auth: dict[str, tuple[str, str]] = {}
        self._active_upstream = None
        self.worksource: TemplateSource | None = None
        self.recovery: RecoveryManager | None = None
        self.failure_detector: FailureDetector | None = None
        # serialises engine restarts between the recovery manager and the
        # failure detector's strategies
        self._restart_lock = asyncio.Lock()
        self._tasks: list[asyncio.Task] = []
        self._started: list = []    # components in start order
        self.started_at = 0.0

    # -- construction ---------------------------------------------------------

    def _build_engine(self) -> MiningEngine:
        cfg = self.config.mining
        kwargs = {"winner_depth": cfg.winner_depth} if cfg.winner_depth else {}
        backend = self.algo_manager.backend_for(cfg.algorithm, **kwargs)
        return MiningEngine(
            backends={backend.name: backend},
            on_share=self._on_share,
            config=EngineConfig(
                worker_name=cfg.worker_name,
                algorithm=cfg.algorithm,
                batch_size=cfg.batch_size,
                pipeline_depth=cfg.pipeline_depth or EngineConfig.pipeline_depth,
                drain_timeout=cfg.drain_timeout,
                watchdog_multiplier=cfg.watchdog_multiplier,
                watchdog_floor=cfg.watchdog_floor,
                watchdog_first_deadline=cfg.watchdog_first_deadline,
                max_probes=cfg.max_probes,
            ),
        )

    async def _on_share(self, share: Share) -> None:
        """Upstream or loopback: submit to the pool and count its verdict.
        Solo: submit every share that meets the network target."""
        if self.client is not None:
            result = await self.client.submit(share)
            if self.engine is not None:
                if result.accepted:
                    self.engine.stats.shares_accepted += 1
                else:
                    self.engine.stats.shares_rejected += 1
            return
        if self.engine is not None:
            self.engine.stats.shares_accepted += 1
        job = self.worksource.get_job(share.job_id)
        if job is None:
            return
        if not tgt.hash_meets_target(share.digest, tgt.bits_to_target(job.nbits)):
            return
        header = header_from_share(job, share.extranonce2, share.ntime,
                                   share.nonce_word)
        outcome = await self.chain.submit_block(header)
        if outcome.accepted:
            log.info("solo block accepted: %s", outcome.block_hash[:24])
        else:
            log.warning("solo block rejected: %s", outcome.reason)

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        self.started_at = time.time()
        cfg = self.config
        if cfg.pool.enabled:
            await self._start_pool_side()
        if cfg.p2p.enabled:
            await self._start_p2p()
        if cfg.validation.enabled:
            # ONE backend for every batch producer: the ledger's batch
            # path and the gossip handlers share the stats surface and the
            # quarantine state. The single-process server books share by
            # share and never reaches it
            from otedama_tpu_torch.runtime.validate import ValidationBackend

            self.validator = ValidationBackend(
                min_batch=cfg.validation.min_batch,
                tripwire_rate=cfg.validation.tripwire_rate,
                quarantine_seconds=cfg.validation.quarantine_seconds,
                device=cfg.mining.device,
                x11_chain=cfg.validation.x11_chain,
            )
            if self.pool is not None:
                self.pool.validator = self.validator
            if self.p2p is not None:
                self.p2p.validator = self.validator
        # the listening sockets open only once every pool-side dependency
        # (the p2p chain included) is in place, before the first miner can
        # connect
        await self._start_stratum_listeners()
        if cfg.mining.enabled:
            await self._start_miner_side()
        if cfg.api.enabled:
            await self._start_api()
        await self._start_supervision()
        log.info("application started (%s)", ", ".join(
            name for name, on in (("mining", cfg.mining.enabled),
                                  ("pool", cfg.pool.enabled),
                                  ("p2p", cfg.p2p.enabled),
                                  ("api", cfg.api.enabled)) if on
        ) or "idle")

    async def _start_pool_side(self) -> None:
        from otedama_tpu_torch.db import connect_database
        from otedama_tpu_torch.pool.manager import PoolConfig, PoolManager
        from otedama_tpu_torch.pool.payouts import PayoutConfig, PayoutScheme
        from otedama_tpu_torch.stratum.server import ServerConfig, StratumServer

        cfg = self.config
        # the pool serves one chain whose algorithm never changes at run
        # time: its jobs keep this label whatever the miner side does
        self._pool_algorithm = cfg.mining.algorithm
        self.db = connect_database(cfg.pool.database)
        chain = self._chain_arg or _chain_client(cfg)
        pool_cfg = PoolConfig(payout=PayoutConfig(
            scheme=PayoutScheme(cfg.pool.payout_scheme.upper()),
            pplns_window=cfg.pool.pplns_window,
            pool_fee_percent=cfg.pool.fee_percent,
            minimum_payout=cfg.pool.minimum_payout,
            payout_fee=cfg.pool.payout_fee,
        ))
        self.pool = PoolManager(self.db, chain, config=pool_cfg)
        self.server = StratumServer(
            ServerConfig(
                host=cfg.stratum.host,
                port=cfg.stratum.port,
                extranonce2_size=cfg.stratum.extranonce2_size,
                initial_difficulty=cfg.stratum.initial_difficulty,
                max_clients=cfg.stratum.max_clients,
                vardiff=VardiffConfig(
                    target_share_seconds=cfg.stratum.vardiff_target_seconds
                ),
            ),
            on_share=self.pool.on_share,
            on_block=self.pool.on_block,
        )
        await self.pool.start()
        self._started.append(self.pool)
        self._start_worksource(chain, pool_cfg)

    async def _start_p2p(self) -> None:
        from otedama_tpu_torch.p2p.node import NodeConfig
        from otedama_tpu_torch.p2p.pool import P2PPool
        from otedama_tpu_torch.p2p.sharechain import ChainParams

        cfg = self.config.p2p
        bootstrap = []
        for entry in cfg.bootstrap:
            host, _, port = str(entry).rpartition(":")
            if host:
                bootstrap.append((host, int(port)))
        store = None
        if cfg.chain_dir:
            # durable share chain: WAL segments + settled archive +
            # snapshots under chain_dir; the node cold-boots from them
            # below, BEFORE joining the overlay, so locator sync only
            # covers what a crash cut off past the last durable record
            from otedama_tpu_torch.p2p.chainstore import (
                ChainStore,
                ChainStoreConfig,
            )

            store = ChainStore(ChainStoreConfig(
                path=cfg.chain_dir,
                segment_bytes=cfg.chain_segment_bytes,
                fsync_interval=cfg.chain_fsync_interval,
                snapshot_interval=cfg.chain_snapshot_interval,
                tail_shares=cfg.chain_tail_shares,
                durability=cfg.chain_durability,
                ring_max=cfg.chain_ring_max,
            ))
        self.p2p = P2PPool(
            NodeConfig(
                host=cfg.host, port=cfg.port, max_peers=cfg.max_peers,
                bootstrap=bootstrap,
            ),
            # the share chain mines/verifies the pool's own algorithm;
            # the consensus knobs come straight from config so every
            # node of one deployment agrees on them
            ChainParams(
                algorithm=self.config.mining.algorithm,
                min_difficulty=cfg.share_difficulty,
                window=cfg.pplns_window,
                max_reorg_depth=cfg.max_reorg_depth,
                max_time_skew=cfg.max_time_skew,
                share_interval=cfg.share_interval,
                sync_page=cfg.sync_page,
            ),
            store=store,
        )
        if store is not None:
            info = self.p2p.chain.load()
            log.info(
                "share chain restored from %s: height %d via %s "
                "(%d events replayed in %.3fs; durability mode %s)",
                cfg.chain_dir, info["height"], info["source"],
                info["replayed"] + info["reorgs_replayed"], info["seconds"],
                cfg.chain_durability,
            )
        await self.p2p.start()
        self._started.append(self.p2p)

    def _start_worksource(self, chain, pool_cfg) -> None:
        """The pool's own upstream: a TemplateSource originating jobs from
        the chain node through the pool manager."""
        cfg = self.config
        source = TemplateSource(
            chain, pool=self.pool,
            algorithm=self._pool_algorithm,
            poll_seconds=(cfg.work.poll_seconds if cfg.work.enabled
                          else pool_cfg.template_poll_seconds),
            extranonce2_size=cfg.stratum.extranonce2_size,
            payout_script=bytes.fromhex(cfg.work.payout_script),
            coinbase_tag=cfg.work.coinbase_tag.encode(),
        )
        source.add_sink(self._fan_out_job)
        self.worksource = source
        self._tasks.append(asyncio.create_task(source.run()))

    def _fan_out_job(self, job, clean: bool) -> None:
        """TemplateSource sink: every job goes to the stratum server."""
        if self.server is not None:
            self.server.set_job(job, clean=clean)

    async def _start_stratum_listeners(self) -> None:
        """Open the stratum listening socket (see start() for why this runs
        after the pool side is wired, not at server construction)."""
        if self.server is not None:
            await self.server.start()
            self._started.append(self.server)

    async def _start_miner_side(self) -> None:
        from otedama_tpu_torch.stratum.client import ClientConfig, StratumClient

        cfg = self.config
        self.engine = self._build_engine()
        if cfg.upstreams:
            from otedama_tpu_torch.pool.failover import (
                FailoverManager,
                UpstreamPool,
            )

            ups = []
            for u in cfg.upstreams:
                host, port = parse_upstream_url(u.url)
                ups.append(UpstreamPool(name=u.url, host=host, port=port,
                                        priority=u.priority))
            self.failover = FailoverManager(ups)
            selected = self.failover.select()
            self._upstream_auth = {
                u.url: (u.username, u.password) for u in cfg.upstreams
            }
            username, password = self._upstream_auth[selected.name]
            self.client = StratumClient(
                ClientConfig(
                    host=selected.host, port=selected.port,
                    username=username, password=password,
                    algorithm=cfg.mining.algorithm,
                ),
                on_job=self.engine.set_job,
            )
            self._active_upstream = selected
            await self.client.start()
            self.failover.start()
            self._started += [self.client, self.failover]
            self._tasks.append(asyncio.create_task(self._failover_loop()))
        elif self.server is not None:
            # pool mode with local mining: loop back to our own server
            self.client = StratumClient(
                ClientConfig(
                    host="127.0.0.1", port=self.server.port,
                    username=cfg.mining.worker_name,
                    algorithm=cfg.mining.algorithm,
                ),
                on_job=self.engine.set_job,
            )
            await self.client.start()
            self._started.append(self.client)
        else:
            # solo against a chain client
            self.chain = self._chain_arg or _chain_client(cfg)
            source = TemplateSource(
                self.chain, algorithm=cfg.mining.algorithm,
                poll_seconds=cfg.work.poll_seconds if cfg.work.enabled else 5.0,
                # solo shares carry no extranonce1: the gap is extranonce2
                # alone
                extranonce1_len=0,
                payout_script=bytes.fromhex(cfg.work.payout_script),
                coinbase_tag=cfg.work.coinbase_tag.encode(),
            )
            source.add_sink(lambda job, clean: self.engine.set_job(job))
            self.worksource = source
            self._tasks.append(asyncio.create_task(source.run()))
        if cfg.mining.precompile:
            # build + warm in the background: the job feed comes up
            # meanwhile (early jobs buffer in set_job) and the engine
            # starts only when warm, so its first launch mines
            self._tasks.append(
                asyncio.create_task(self._precompile_then_start_engine()))
        else:
            await self.engine.start()
        self._started.append(self.engine)

    async def _precompile_then_start_engine(self) -> None:
        loop = asyncio.get_running_loop()
        engine = self.engine
        for backend in engine.backends.values():
            count = engine.planned_batch(backend)
            try:
                await loop.run_in_executor(
                    None, lambda b=backend, c=count: b.precompile(count=c))
            except Exception:
                # no fallback: a kernel that does not build or launch
                # leaves the engine stopped, loudly
                log.exception("precompile of %s failed; the engine will not "
                              "start", backend.name)
                raise
        await engine.start()

    async def _connect_upstream(self, selected) -> None:
        """Re-point the stratum client at ``selected``, with session
        handoff: the old client's resume token rides along, so a pool
        sharing the session secret recovers our difficulty and extranonce
        lease instead of resetting the session."""
        from otedama_tpu_torch.stratum.client import ClientConfig, StratumClient

        old = self.client
        username, password = self._upstream_auth.get(
            selected.name, ("", "x"))
        self.client = StratumClient(
            ClientConfig(
                host=selected.host, port=selected.port,
                username=username, password=password,
                algorithm=self.config.mining.algorithm,
            ),
            on_job=self.engine.set_job,
        )
        if old is not None:
            self.client.resume_token = old.resume_token
        self._active_upstream = selected
        await self.client.start()
        # keep shutdown bookkeeping pointed at the live client
        self._started = [
            self.client if c is old else c for c in self._started
        ]
        if old is not None:
            await old.stop()

    async def _failover_loop(self) -> None:
        """Re-point the stratum client when a better upstream wins the
        health-scored selection."""
        while True:
            await asyncio.sleep(self.failover.check_interval)
            selected = self.failover.select()
            if selected is self._active_upstream:
                continue
            log.info("failing over to upstream %s", selected.name)
            await self._connect_upstream(selected)

    async def _start_api(self) -> None:
        """The API server with the providers of what the port carries:
        the reference also registers ``stratum_v2``, ``region``,
        ``worksource``, ``settlement``, ``profit``, ``backups``,
        ``native`` and ``compile``, whose subsystems are not ported."""
        from otedama_tpu_torch.utils import faults

        cfg = self.config.api
        self.api = ApiServer(ApiServerConfig(
            host=cfg.host, port=cfg.port,
            rate_limit_per_minute=cfg.rate_limit_per_minute,
            auth_secret=cfg.auth_secret,
        ))
        if self.engine is not None:
            self.api.add_provider("engine", self.engine.snapshot)
            # /health readiness follows device supervision: 200 while
            # serving (even degraded), 503 once no device can mine
            self.api.health_source = self.engine.device_health
        if self.client is not None:
            self.api.add_provider("upstream", lambda: dict(self.client.stats))
        if self.server is not None:
            self.api.add_provider("stratum", self.server.snapshot)
        if self.pool is not None:
            self.api.add_provider("pool", self.pool.snapshot)
        if self.p2p is not None:
            self.api.add_provider("p2p", self.p2p.snapshot)
        self.api.add_provider("benchmarks", self.algo_manager.snapshot)
        # chaos observability: per-point hit/fault counters of the active
        # fault injector ({"active": False} outside chaos runs)
        self.api.add_provider("fault_injection", faults.snapshot_active)
        if self.db is not None:
            # /api/v1/logs/audit reads the pool db's audit trail
            self.api.audit_source = self.db.query_audit
        await self.api.start()
        self._started.append(self.api)
        self._tasks.append(asyncio.create_task(self._metrics_loop()))

    def sync_metrics(self) -> None:
        """One pass of every metric sync the port has onto the API's
        registry (the metrics loop runs it every 5 s)."""
        api = self.api
        # chain-RPC pool telemetry is engine-independent: a pool-only
        # node still polls templates and submits blocks over the pooled
        # RPC connections
        chains = {
            name: c for name, c in (
                ("solo", self.chain),
                ("pool", getattr(self.pool, "chain", None)),
            ) if c is not None
        }
        if chains:
            api.sync_rpc_pool_metrics(chains)
        if self.server is not None:
            api.sync_pool_server_metrics(self.server)
        if self.p2p is not None:
            snap = self.p2p.snapshot()
            api.sync_p2p_metrics(snap)
            api.sync_chain_metrics(snap.get("chain", {}))
        if self.validator is not None:
            api.sync_validation_metrics(self.validator)
        if self.engine is not None:
            api.sync_engine_metrics(self.engine.snapshot())
            if self.client is not None:
                api.sync_client_metrics(self.client)

    async def _metrics_loop(self) -> None:
        while True:
            await asyncio.sleep(5.0)
            if self.api is not None:
                self.sync_metrics()

    async def _start_supervision(self) -> None:
        """Engine recovery (restart a dead engine) and the failure
        detector with its strategies, in the serve path."""
        self.recovery = RecoveryManager()
        if self.engine is not None:
            engine = self.engine
            lock = self._restart_lock

            async def engine_probe() -> bool:
                # transitional states are another supervisor's restart in
                # flight, not ill health; idle means the startup warmup
                # has not started the engine yet — "restarting" it would
                # start it cold
                return engine.state.value in (
                    "idle", "running", "starting", "stopping")

            async def engine_restart() -> None:
                async with lock:
                    if engine.state.value == "running":
                        return  # someone else already recovered it
                    await engine.stop()
                    await engine.start()

            self.recovery.register("engine", engine_probe, engine_restart)

            async def restart_engine_on_failure(failure) -> bool:
                # a hashrate drop / batch stall caused by capacity in
                # QUARANTINE belongs to the supervision layer (verified
                # probes): a blind restart would reset the wedged device
                # straight to HEALTHY and bypass oracle-verified
                # reintegration. DEAD is terminal, so a dead tombstone
                # does not stand this strategy down.
                states = engine.device_health()["device_states"]
                if any(s in ("quarantined", "probing")
                       for s in states.values()):
                    return False
                async with lock:
                    await engine.stop()
                    await engine.start()
                return True

            async def acknowledge_quarantine(failure) -> bool:
                """DEVICE_HUNG: the engine already quarantined the
                device, reassigned its extranonce2 block to the survivors
                and is probing for reintegration — report the failure
                handled."""
                sup = engine.supervisors.get(failure.component)
                return sup is not None and not sup.can_mine

            async def drop_dead_device(failure) -> bool:
                """DEVICE_LOST: drop the backend (closed under its
                tombstoned supervisor) as long as another device keeps
                mining."""
                sup = engine.supervisors.get(failure.component)
                if (sup is None or sup.state.value != "dead"
                        or failure.component not in engine.backends
                        or len(engine.backends) <= 1):
                    return False
                async with lock:
                    await engine.remove_backend(failure.component)
                return True

            self.failure_detector = FailureDetector(engine)
            for strategy in (
                CallbackStrategy(
                    "engine-restart",
                    (FailureType.BATCH_STALL, FailureType.HASHRATE_DROP),
                    restart_engine_on_failure),
                CallbackStrategy("device-quarantine",
                                 (FailureType.DEVICE_HUNG,),
                                 acknowledge_quarantine),
                CallbackStrategy("drop-dead-device",
                                 (FailureType.DEVICE_LOST,),
                                 drop_dead_device),
            ):
                self.failure_detector.add_strategy(strategy)
            await self.failure_detector.start()
            self._started.append(self.failure_detector)
            if self.api is not None:
                self.api.add_provider("failures",
                                      self.failure_detector.snapshot)
        await self.recovery.start()
        self._started.append(self.recovery)
        if self.api is not None:
            self.api.add_provider("recovery", self.recovery.snapshot)

    async def stop(self) -> None:
        for t in self._tasks:
            t.cancel()
        results = await asyncio.gather(*self._tasks, return_exceptions=True)
        for r in results:
            if isinstance(r, Exception):
                log.error("background task failed: %r", r)
        self._tasks.clear()
        for component in reversed(self._started):
            try:
                await component.stop()
            except Exception:
                log.exception("stopping %s failed", type(component).__name__)
        self._started.clear()
        if self.engine is not None:
            # the end of the engine's life: its card backends free their
            # device memory
            await self.engine.close()
        for chain in (self.chain, getattr(self.pool, "chain", None)):
            close = getattr(chain, "close", None)
            if close is not None:
                try:
                    close()  # release pooled keep-alive RPC sockets
                except Exception:
                    log.exception("chain client close failed")
        if self.db is not None:
            self.db.close()
        log.info("application stopped")

    def snapshot(self) -> dict:
        out = {"uptime_seconds": round(time.time() - self.started_at, 1)}
        if self.engine is not None:
            out["engine"] = self.engine.snapshot()
        if self.server is not None:
            out["stratum"] = self.server.snapshot()
        if self.pool is not None:
            out["pool"] = self.pool.snapshot()
        if self.p2p is not None:
            out["p2p"] = self.p2p.snapshot()
        if self.worksource is not None:
            out["worksource"] = self.worksource.snapshot()
        if self.failure_detector is not None:
            out["failures"] = self.failure_detector.snapshot()
        if self.recovery is not None:
            out["recovery"] = self.recovery.snapshot()
        return out
