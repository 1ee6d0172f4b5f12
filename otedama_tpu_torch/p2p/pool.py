"""Decentralized (P2P) pool mode: a verified share chain over flood gossip
(counterpart of ``otedama_tpu/p2p/pool.py``).

Reference parity: internal/mining/p2p_engine.go:14-110 (engine + network
composition), internal/p2p/handlers.go:70-447 (share/job/block handlers
with re-propagation). The reference's "ledger" message type sketched a
share chain but trusted claimed difficulties; this node runs the real
construction (p2p/sharechain.py): every gossiped share carries its 80-byte
PoW'd header, receivers verify the proof-of-work OFF the event loop (the
validation executor, like slow-algo stratum share checks) before linking,
tips are chosen by cumulative work, reorgs rewind/replay the PPLNS window,
and partition catch-up is locator-based paged sync. Invalid shares are
never linked AND never re-propagated — an honest overlay quarantines a
Byzantine peer's output at the first hop.

Where the port differs from the reference: when the validator raises,
``_verify_many`` checks nothing on the host. Each share it sent gets the
exception as its verdict and is neither linked nor relayed (counted in
``stats["verify_failures"]``); sync fetches the shares again later. The
port's ``ValidationBackend`` raises only on a real kernel fault, and a
host re-verification would hide a faulty verify kernel.
"""

from __future__ import annotations

import asyncio
import logging
import time

from otedama_tpu_torch.p2p import sharechain
from otedama_tpu_torch.p2p.messages import (
    MAX_SHARE_BATCH,
    MAX_SYNC_PAGE,
    MessageType,
    P2PMessage,
    parse_locator,
)
from otedama_tpu_torch.p2p.node import NodeConfig, P2PNode, Peer
from otedama_tpu_torch.p2p.sharechain import (
    ChainParams,
    Share,
    ShareChain,
    ShareFormatError,
    ShareInvalid,
)
from otedama_tpu_torch.utils import faults, pow_host

log = logging.getLogger("otedama.p2p.pool")

# fault-point support sets: share verification / sync steps are skippable
# (drop = the verdict or page is lost; delay = a slow verifier/link)
_VERIFY_FAULTS = faults.STEP
_SYNC_FAULTS = faults.STEP

# floor between orphan-triggered locator syncs to one peer: a burst of
# out-of-order arrivals must not turn into a sync-request storm
_ORPHAN_SYNC_INTERVAL = 2.0


class P2PPool:
    """A pool node in the gossip overlay, accounting on the share chain."""

    def __init__(self, config: NodeConfig | None = None,
                 params: ChainParams | None = None, store=None):
        self.node = P2PNode(config)
        # optional durable chain store (p2p/chainstore.py): callers run
        # ``chain.load()`` BEFORE start() so the node boots from its
        # segments+snapshot and locator sync only covers what a crash
        # cut off past the last durable record
        self.chain = ShareChain(params, store=store)
        self.blocks_seen: list[dict] = []
        self.jobs_seen: dict[str, dict] = {}
        self.stats = {
            "shares_accepted": 0,      # verified + linked (or orphaned)
            "shares_rejected": 0,      # failed verification (any reason)
            "verify_failures": 0,      # injected/internal verifier errors
            "sync_requests": 0,
            "sync_pages_sent": 0,
            "sync_pages_received": 0,
        }
        self.rejects: dict[str, int] = {}   # ShareInvalid.reason -> count
        # region-loss chaos: a severed node keeps verifying and linking
        # its OWN shares but neither floods nor answers/initiates sync
        # until healed — the local chain diverges exactly like a region
        # cut off at the network
        self.severed = False
        # device-batched PoW verification (runtime/validate.py): when
        # set, batch handlers (SHARE_BATCH gossip, sync pages, local
        # batch submits) run the structural checks per share on the host
        # and the N digest+compare checks as ONE device dispatch instead
        # of N executor hashes; None = the per-share executor fan-out
        self.validator = None
        self._verifying: set[bytes] = set()  # share ids in-flight on executor
        self._last_orphan_sync: dict[str, float] = {}
        self._last_prune = 0                 # shares_connected at last prune
        self.node.on(MessageType.SHARE, self._on_share)
        self.node.on(MessageType.SHARE_BATCH, self._on_share_batch)
        self.node.on(MessageType.BLOCK, self._on_block)
        self.node.on(MessageType.JOB, self._on_job)
        self.node.on(MessageType.SYNC_REQUEST, self._on_sync_request)
        self.node.on(MessageType.SYNC_RESPONSE, self._on_sync_response)

    async def start(self) -> None:
        await self.node.start()

    async def stop(self) -> None:
        await self.node.stop()
        if self.chain.store is not None:
            # final fsync + handle close; a hard kill skipping this is
            # exactly the crash load() replays
            try:
                self.chain.store.close()
            except Exception:
                log.exception("chain store close failed")

    def sever(self) -> None:
        """Cut this node off the overlay (region loss): close every peer
        link and suppress gossip/sync until ``heal()``. The node keeps
        serving local submits — a severed region's front-end does not
        know it is severed."""
        self.severed = True
        for peer in list(self.node.peers.values()):
            try:
                peer.writer.close()
            except Exception:
                pass

    def heal(self) -> None:
        """Rejoin the overlay (callers re-link/redial peers) and pull
        the survivors' suffix."""
        self.severed = False

    # -- local events -> gossip ---------------------------------------------

    async def announce_share(self, worker: str, difficulty: float,
                             job_id: str) -> Share:
        """Mine a share extending the local tip and flood it.

        Host-grinds the PoW on the default executor — the bootstrap/test
        path. Production nodes feed device-found headers through
        ``submit_share`` instead; either way the gossiped bytes carry a
        real proof, because receivers verify, not trust.
        """
        if difficulty < self.chain.params.min_difficulty:
            raise ValueError(
                f"difficulty {difficulty} below chain minimum "
                f"{self.chain.params.min_difficulty}"
            )
        prev = self.chain.tip if self.chain.tip is not None else sharechain.GENESIS
        loop = asyncio.get_running_loop()
        share = await loop.run_in_executor(
            None, lambda: sharechain.mine_share(
                prev, worker, job_id, difficulty,
                algorithm=self.chain.params.algorithm,
            ),
        )
        await self.submit_share(share)
        return share

    async def submit_share(self, share: Share) -> str:
        """Verify + link a locally-produced share, then flood it. The local
        node runs the same verification as receivers: a miner-side bug must
        not poison our own chain (or waste a broadcast)."""
        await self._verify_off_loop(share)
        status = self.chain.connect(share)
        if status in ("accepted", "orphan"):
            self.stats["shares_accepted"] += 1
            self._maybe_prune()
            if not self.severed:
                await self.node.broadcast(
                    P2PMessage(MessageType.SHARE, share.to_payload())
                )
        return status

    async def submit_share_batch(self, shares: list[Share]) -> list[str]:
        """Group-commit form of ``submit_share``: verify a
        lineage-ordered run of locally-produced shares CONCURRENTLY on
        the validation executor, link them in order, then flood the
        whole batch as ONE ``SHARE_BATCH`` message — one broadcast (and
        one dedup id, one drain sweep) per ledger batch instead of one
        per share. Raises (rejecting the batch) if any member fails
        verification: members are our own product, and a bad one means
        a producer bug, not peer noise."""
        if len(shares) > MAX_SHARE_BATCH:
            raise ValueError(
                f"share batch of {len(shares)} exceeds {MAX_SHARE_BATCH}")
        for verdict in await self._verify_many(shares):
            if isinstance(verdict, BaseException):
                raise verdict
        statuses = [self.chain.connect(s) for s in shares]
        fresh = [s for s, st in zip(shares, statuses)
                 if st in ("accepted", "orphan")]
        self.stats["shares_accepted"] += len(fresh)
        if fresh:
            self._maybe_prune()
        if fresh and not self.severed:
            await self.node.broadcast(P2PMessage(
                MessageType.SHARE_BATCH,
                {"shares": [s.to_payload() for s in fresh]},
            ))
        return statuses

    async def announce_block(self, block_hash: str, worker: str, height: int) -> None:
        block = {"hash": block_hash, "worker": worker, "height": height}
        self.blocks_seen.append(block)
        await self.node.broadcast(P2PMessage(MessageType.BLOCK, block))

    async def announce_job(self, job_params: list) -> None:
        """Gossip a stratum-format job (mining.notify params)."""
        self.jobs_seen[str(job_params[0])] = {"params": job_params, "ts": time.time()}
        await self.node.broadcast(P2PMessage(MessageType.JOB, {"params": job_params}))

    # -- verification plumbing ----------------------------------------------

    async def _verify_off_loop(self, share: Share) -> None:
        """Run full PoW verification on the validation executor (the same
        pool slow-algo stratum checks use) — scrypt/ethash share hashes
        take milliseconds to seconds and must not stall the gossip pump."""
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(
            pow_host.validation_executor(),
            sharechain.verify_share, share, self.chain.params,
        )

    async def _verify_many(
        self, shares: list[Share]
    ) -> list[BaseException | None]:
        """Batched verification: one entry per share — ``None``
        (verified), ``ShareInvalid``, or an internal error. With a
        ``validator`` the structural checks run per share on the loop
        (cheap: one commitment hash) and the N PoW digest+compare
        checks become ONE device dispatch (runtime/validate.py, which
        owns crossover/tripwire); if that dispatch raises, the error is
        the verdict of every share sent to it. Without a validator this
        is exactly the old concurrent executor fan-out."""
        if self.validator is None or len(shares) < 2:
            return list(await asyncio.gather(
                *(self._verify_off_loop(s) for s in shares),
                return_exceptions=True,
            ))
        from otedama_tpu_torch.runtime.validate import ShareCheck

        verdicts: list[BaseException | None] = [None] * len(shares)
        checks: list[ShareCheck] = []
        idxs: list[int] = []
        for i, s in enumerate(shares):
            try:
                target = sharechain.verify_share_claim(s, self.chain.params)
            except BaseException as e:
                verdicts[i] = e
                continue
            checks.append(ShareCheck(
                header=s.header, target=target, algorithm=s.algorithm,
                block_number=s.block_number,
            ))
            idxs.append(i)
        if not checks:
            return verdicts
        try:
            oks = await self.validator.verify_batch(checks)
        except Exception as e:
            # the validator raises only on a real kernel fault: no share
            # of the batch is verified, so none is linked or relayed
            log.exception("batched share verification failed; %d shares "
                          "left unverified", len(idxs))
            for i in idxs:
                verdicts[i] = e
            return verdicts
        for i, ok in zip(idxs, oks):
            if not ok:
                verdicts[i] = ShareInvalid(
                    "pow", "digest does not meet claimed target")
        return verdicts

    async def _on_share(self, node: P2PNode, peer: Peer, msg: P2PMessage) -> None:
        try:
            share = Share.from_payload(msg.payload)
        except ShareFormatError as e:
            self.stats["shares_rejected"] += 1
            self.rejects["format"] = self.rejects.get("format", 0) + 1
            log.warning("malformed share gossip from %s: %s",
                        peer.node_id[:12], e)
            return
        sid = share.share_id
        if sid in self.chain or sid in self._verifying:
            return  # already linked/held/in-flight: nothing to redo
        try:
            d = faults.hit("p2p.share.verify", sid.hex()[:12], _VERIFY_FAULTS)
        except faults.FaultInjectedError:
            self.stats["verify_failures"] += 1
            return
        if d is not None:
            if d.drop:
                self.stats["verify_failures"] += 1
                return
            if d.delay:
                await asyncio.sleep(d.delay)
        self._verifying.add(sid)
        try:
            await self._verify_off_loop(share)
        except ShareInvalid as e:
            self.stats["shares_rejected"] += 1
            self.rejects[e.reason] = self.rejects.get(e.reason, 0) + 1
            log.warning("rejected share %s from %s (%s)",
                        sid.hex()[:12], peer.node_id[:12], e)
            return  # invalid: never linked, never re-propagated
        except Exception:
            self.stats["verify_failures"] += 1
            log.exception("share verification failed internally")
            return
        finally:
            self._verifying.discard(sid)
        status = self.chain.connect(share)
        if status not in ("accepted", "orphan"):
            return  # duplicate, or stale (extends an archived ancestor)
        self.stats["shares_accepted"] += 1
        self._maybe_prune()
        if status == "orphan":
            # out-of-order arrival: ask the sender for our missing suffix
            # (rate-limited per peer so a burst is one request)
            self._request_sync_from(peer)
        # verified shares re-flood — orphans too: a peer further along may
        # hold the lineage we lack
        if not self.severed:
            await node.propagate(peer, msg)

    async def _on_share_batch(self, node: P2PNode, peer: Peer,
                              msg: P2PMessage) -> None:
        """One received ledger batch: the same per-share verification
        contract as single SHARE gossip (every member's PoW checked on
        the validation executor, CONCURRENTLY like a sync page; the
        ``p2p.share.verify`` fault point fires per member, so chaos
        schedules see the same per-share hit sequence either way),
        linked in payload order so the lineage connects without orphan
        churn. Only the verified members re-flood, rebuilt as a new
        batch — an invalid entry is never re-propagated and never drags
        its batchmates down."""
        entries = msg.payload.get("shares")
        if not isinstance(entries, list):
            return
        fresh: list[Share] = []
        tainted = len(entries) > MAX_SHARE_BATCH  # oversize: never re-flood whole
        for obj in entries[:MAX_SHARE_BATCH]:
            try:
                share = Share.from_payload(obj)
            except ShareFormatError as e:
                self.stats["shares_rejected"] += 1
                self.rejects["format"] = self.rejects.get("format", 0) + 1
                log.warning("malformed share in batch from %s: %s",
                            peer.node_id[:12], e)
                tainted = True
                continue
            sid = share.share_id
            if sid in self.chain or sid in self._verifying:
                continue
            try:
                d = faults.hit("p2p.share.verify", sid.hex()[:12],
                               _VERIFY_FAULTS)
            except faults.FaultInjectedError:
                self.stats["verify_failures"] += 1
                tainted = True  # unverified here: never re-flood as-is
                continue
            if d is not None:
                if d.drop:
                    self.stats["verify_failures"] += 1
                    tainted = True
                    continue
                if d.delay:
                    await asyncio.sleep(d.delay)
            fresh.append(share)
        if not fresh:
            return
        for s in fresh:
            self._verifying.add(s.share_id)
        try:
            verdicts = await self._verify_many(fresh)
        finally:
            for s in fresh:
                self._verifying.discard(s.share_id)
        verified: list[Share] = []
        saw_orphan = False
        # NB: ``tainted`` carries over from the parse loop — a
        # malformed/oversize/fault-skipped member taints the batch just
        # like a verification failure below, or the original message
        # (bad members included) would re-flood
        for share, verdict in zip(fresh, verdicts):
            if isinstance(verdict, ShareInvalid):
                self.stats["shares_rejected"] += 1
                self.rejects[verdict.reason] = (
                    self.rejects.get(verdict.reason, 0) + 1)
                log.warning("rejected batched share %s from %s (%s)",
                            share.share_id.hex()[:12], peer.node_id[:12],
                            verdict)
                tainted = True
                continue
            if isinstance(verdict, BaseException):
                self.stats["verify_failures"] += 1
                tainted = True
                continue
            status = self.chain.connect(share)
            if status not in ("accepted", "orphan"):
                continue  # duplicate or stale: never re-flooded
            self.stats["shares_accepted"] += 1
            saw_orphan = saw_orphan or status == "orphan"
            verified.append(share)
        if verified:
            self._maybe_prune()
            if saw_orphan:
                self._request_sync_from(peer)
            if not self.severed:
                if not tainted:
                    # every member verified: re-flood the ORIGINAL
                    # message so its flood id keeps deduplicating hops
                    await node.propagate(peer, msg)
                else:
                    # strip the invalid members — they are never
                    # re-propagated — and flood only the verified run
                    await node.propagate(peer, P2PMessage(
                        MessageType.SHARE_BATCH,
                        {"shares": [s.to_payload() for s in verified]},
                        sender=msg.sender,
                    ))

    async def _on_block(self, node: P2PNode, peer: Peer, msg: P2PMessage) -> None:
        self.blocks_seen.append(dict(msg.payload))
        await node.propagate(peer, msg)

    async def _on_job(self, node: P2PNode, peer: Peer, msg: P2PMessage) -> None:
        params = msg.payload.get("params")
        if isinstance(params, list) and params:
            self.jobs_seen[str(params[0])] = {"params": params, "ts": time.time()}
            await node.propagate(peer, msg)

    # -- locator sync --------------------------------------------------------

    def _sync_fault(self, peer: Peer) -> bool:
        """Shared p2p.sync fault point. True = this sync step is lost."""
        try:
            d = faults.hit("p2p.sync", peer.node_id[:12], _SYNC_FAULTS)
        except faults.FaultInjectedError:
            return True
        if d is not None and d.drop:
            return True
        return False

    def _request_sync_from(self, peer: Peer, *, force: bool = False) -> None:
        if self.severed:
            return
        now = time.monotonic()
        if not force:
            last = self._last_orphan_sync.get(peer.node_id, 0.0)
            if now - last < _ORPHAN_SYNC_INTERVAL:
                return
        self._last_orphan_sync[peer.node_id] = now
        # bounded: long-lived public nodes see endless peer churn, and a
        # rate-limit stamp must not outlive its peer by much
        while len(self._last_orphan_sync) > 1024:
            del self._last_orphan_sync[next(iter(self._last_orphan_sync))]
        if self._sync_fault(peer):
            return
        try:
            peer.send(P2PMessage(
                MessageType.SYNC_REQUEST,
                {"locator": self.chain.locator(),
                 "page": self.chain.params.sync_page},
                sender=self.node.node_id,
            ))
        except (ConnectionError, RuntimeError):
            pass

    async def request_sync(self) -> None:
        """Ask every peer for our missing best-chain suffix (partition
        heal, cold start). Paged: each response triggers the next request
        while the peer reports more."""
        for peer in list(self.node.peers.values()):
            self._request_sync_from(peer, force=True)

    async def _on_sync_request(self, node: P2PNode, peer: Peer,
                               msg: P2PMessage) -> None:
        if self.severed or self._sync_fault(peer):
            return
        self.stats["sync_requests"] += 1
        locator = parse_locator(msg.payload.get("locator", []))
        try:
            page = int(msg.payload.get("page", self.chain.params.sync_page))
        except (TypeError, ValueError):
            page = self.chain.params.sync_page
        page = max(1, min(page, MAX_SYNC_PAGE))
        shares, more = self.chain.shares_after(locator, page)
        self.stats["sync_pages_sent"] += 1
        peer.send(P2PMessage(
            MessageType.SYNC_RESPONSE,
            {
                "shares": [s.to_payload() for s in shares],
                "more": bool(more),
            },
            sender=node.node_id,
        ))

    async def _on_sync_response(self, node: P2PNode, peer: Peer,
                                msg: P2PMessage) -> None:
        if self.severed or self._sync_fault(peer):
            return
        entries = msg.payload.get("shares", [])
        if not isinstance(entries, list):
            return
        self.stats["sync_pages_received"] += 1
        # parse + dedup on the loop, verify the page CONCURRENTLY on the
        # validation executor (slow-algo chains hash for ms-to-s per
        # share; one-at-a-time would idle the pool's other threads), then
        # connect in page order so lineage links without orphan churn
        fresh: list[Share] = []
        for obj in entries[:MAX_SYNC_PAGE]:
            try:
                share = Share.from_payload(obj)
            except ShareFormatError:
                self.stats["shares_rejected"] += 1
                self.rejects["format"] = self.rejects.get("format", 0) + 1
                continue
            if share.share_id not in self.chain:
                fresh.append(share)
        verdicts = await self._verify_many(fresh)
        progressed = 0
        for share, verdict in zip(fresh, verdicts):
            if isinstance(verdict, ShareInvalid):
                self.stats["shares_rejected"] += 1
                self.rejects[verdict.reason] = (
                    self.rejects.get(verdict.reason, 0) + 1)
                continue
            if isinstance(verdict, BaseException):
                self.stats["verify_failures"] += 1
                continue
            if self.chain.connect(share) in ("accepted", "orphan"):
                self.stats["shares_accepted"] += 1
                progressed += 1
        if progressed:
            self._maybe_prune()
        if msg.payload.get("more") and progressed:
            # the pages arrive oldest-first, so our locator has advanced:
            # pull the next page until the peer runs dry. The progress
            # gate matters: a Byzantine {"shares": [], "more": true}
            # (or a page of junk) must not drive an unbounded
            # request/response ping-pong — with no progress we simply
            # stop, and the next orphan/manual sync retries elsewhere
            self._request_sync_from(peer, force=True)

    def _maybe_prune(self) -> None:
        """Periodic housekeeping on the connect path: side branches past
        the reorg horizon are dropped, and — with a chain store — the
        settled prefix is STAGED out of memory and snapshots are queued
        (``ShareChain.compact``). All disk work (archive appends, the
        O(tail) snapshot rewrite, fsyncs) happens on the store's writer
        thread; this call is dict work only, so the gossip pump never
        stalls behind persistence. Delta-gated, not modulo: orphan
        adoption and sync pages link several shares per call and would
        step over exact multiples."""
        if self.chain.shares_connected - self._last_prune >= 256:
            self._last_prune = self.chain.shares_connected
            self.chain.compact()

    # -- reporting ------------------------------------------------------------

    def weights(self) -> dict[str, float]:
        """PPLNS weights over the best chain's window — identical on every
        converged node, by construction (fork choice is deterministic and
        the window is walked in chain order)."""
        return self.chain.weights()

    def snapshot(self) -> dict:
        return {
            **self.node.snapshot(),
            **self.stats,
            "severed": self.severed,
            "chain": self.chain.snapshot(),
            "rejects": dict(self.rejects),
            "blocks_seen": len(self.blocks_seen),
            "jobs_seen": len(self.jobs_seen),
        }
