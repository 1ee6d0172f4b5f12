"""PoolManager: composes validator/jobs/payouts/submitter over persistence
(counterpart of ``otedama_tpu/pool/manager.py``).

The port leaves out the reference's multi-region ``replicator`` hook and
its ``work_source`` hook with ``_offer_aux`` (merged mining), and the
``defer_block_distribution`` switch that hands block rewards to the
settlement engine: they come with the regions, merged-mining and
settlement slices. Without them, a ledger batch
goes validator -> ``ledger.flush`` fault point -> one db transaction.

Reference parity: internal/pool/pool_manager.go:17-160 (composition root),
payout_processor.go:19-76 (batch payouts via WalletInterface). The stratum
server handles wire-level validation; the manager owns pool policy: share
accounting, block lifecycle, reward distribution, worker balances, payout
batching.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import logging
import time
from typing import Protocol

from otedama_tpu_torch.db import (
    BlockRepository,
    Database,
    PayoutRepository,
    ShareRepository,
    WorkerRepository,
)
from otedama_tpu_torch.engine.types import Job
from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.pool.blockchain import BlockchainClient, BlockTemplate
from otedama_tpu_torch.pool.payouts import (
    PayoutCalculator,
    PayoutConfig,
    PayoutScheme,
    stage_payable_workers,
)
from otedama_tpu_torch.pool.submitter import BlockSubmitter, SubmitterConfig
from otedama_tpu_torch.runtime.validate import ShareCheck
from otedama_tpu_torch.stratum.server import AcceptedShare
from otedama_tpu_torch.utils import faults

log = logging.getLogger("otedama.pool.manager")


class WalletInterface(Protocol):
    """Reference parity: internal/pool/payout_processor.go:59-66, plus an
    idempotency ``key``: a re-submitted batch carrying a key the wallet
    has already honoured must return the ORIGINAL tx id without moving
    coins again (the settlement engine's exactly-once hinge — a crash
    between send and record is indistinguishable from a lost verdict)."""

    async def send_many(self, outputs: dict[str, int],
                        key: str | None = None) -> str: ...
    async def get_balance(self) -> int: ...


class MockWallet:
    """In-memory wallet (reference test MockWallet, payout_system_test.go:265)."""

    def __init__(self, balance: int = 10**12):
        self.balance = balance
        self.sent: list[dict[str, int]] = []
        self._tx = itertools.count(1)
        self._by_key: dict[str, str] = {}
        self.duplicates_avoided = 0

    async def send_many(self, outputs: dict[str, int],
                        key: str | None = None) -> str:
        if key is not None and key in self._by_key:
            # idempotent re-submit: the batch already went out — answer
            # with the original tx, move nothing
            self.duplicates_avoided += 1
            return self._by_key[key]
        total = sum(outputs.values())
        if total > self.balance:
            raise RuntimeError("insufficient funds")
        self.balance -= total
        self.sent.append(dict(outputs))
        tx = f"mock-tx-{next(self._tx):08d}"
        if key is not None:
            self._by_key[key] = tx
        return tx

    async def get_balance(self) -> int:
        return self.balance


@dataclasses.dataclass
class PoolConfig:
    payout: PayoutConfig = dataclasses.field(default_factory=PayoutConfig)
    payout_interval: float = 3600.0
    template_poll_seconds: float = 5.0
    share_retention_seconds: float = 7 * 86400.0


class PoolManager:
    def __init__(
        self,
        db: Database,
        chain: BlockchainClient,
        wallet: WalletInterface | None = None,
        config: PoolConfig | None = None,
    ):
        self.db = db
        self.chain = chain
        self.wallet = wallet or MockWallet()
        self.config = config or PoolConfig()
        self.workers = WorkerRepository(db)
        self.shares = ShareRepository(db)
        self.blocks = BlockRepository(db)
        self.payout_repo = PayoutRepository(db)
        self.calculator = PayoutCalculator(self.config.payout)
        self.submitter = BlockSubmitter(chain, self.blocks, SubmitterConfig())
        # device-batched re-validation (runtime/validate.py): when set,
        # every ledger batch is re-verified on the card BEFORE anything
        # is booked — the authoritative
        # check at the single ledger owner, with host fallback and a
        # sampled host-oracle tripwire inside the backend itself
        self.validator = None
        # workers whose row this process has already ensured exists:
        # the per-share upsert only matters for a worker's FIRST share
        # (record_share refreshes last_seen on every share anyway), and
        # on the submit hot path at four-digit share rates that
        # redundant statement was a third of the ledger's db work.
        # Names only — bounded by the real worker population.
        self._known_workers: set[str] = set()
        self._job_counter = itertools.count(1)
        self._round_start = time.time()     # PROP round boundary
        self._current_reward = 0
        # reward is credited per found job, not per latest template: a
        # template refresh mid-round must not change the split of a block
        # found on the previous job
        self._job_rewards: dict[str, int] = {}
        # ledger-host accounting: every group-commit flush lands here,
        # whether its shares came from local workers or remote fleet
        # hosts — the counters a fleet-wide exactly-once audit compares
        # client verdicts against (tools/bench_fleet.py)
        self.ledger_stats = {
            "batches": 0, "shares_ok": 0, "shares_rejected": 0}
        self._tasks: list[asyncio.Task] = []

    # -- job production -----------------------------------------------------

    def job_from_template(self, t: BlockTemplate, algorithm: str = "sha256d") -> Job:
        self._current_reward = t.reward
        job_id = f"{next(self._job_counter):x}"
        self._job_rewards[job_id] = t.reward
        if len(self._job_rewards) > 512:
            for jid in list(self._job_rewards)[:-256]:
                del self._job_rewards[jid]
        return Job(
            job_id=job_id,
            prev_hash=t.prev_hash,
            coinb1=t.coinb1,
            coinb2=t.coinb2,
            merkle_branch=t.merkle_branch,
            version=t.version,
            nbits=t.nbits,
            ntime=t.ntime,
            clean=True,
            algorithm=algorithm,
            block_number=t.height,
        )

    async def next_job(self) -> Job:
        return self.job_from_template(await self.chain.get_block_template())

    # -- share intake (stratum server hook) ---------------------------------

    async def on_share(self, share: AcceptedShare) -> None:
        worker = share.worker_user
        # one transaction: a write failing mid-sequence (chaos: injected
        # db faults) must roll back the worker counters WITH the missing
        # share row — the servers turn the raised error into a reject, so
        # "every accept the miner saw is in the books exactly once" holds
        with self.db.transaction():
            if worker not in self._known_workers:
                self.workers.upsert(worker)
            self.workers.record_share(worker, True)
            self.shares.create(
                worker,
                share.job_id,
                share.difficulty,
                share.actual_difficulty,
                share.is_block,
                share.submitted_at,
            )
            credit = self.calculator.pps_credit(share.difficulty)
            if credit:
                self.workers.credit(worker, credit)
        # only after the commit: a rolled-back first share must retry
        # its upsert, not skip it
        self._known_workers.add(worker)

    # -- group-commit share intake (sharded front-end) -----------------------

    async def on_share_batch(
        self, batch: list[AcceptedShare]
    ) -> list[tuple[str, str]]:
        """Batched twin of :meth:`on_share` — the group-commit ledger's
        entry point. Semantics are per-share identical to N sequential
        ``on_share`` calls; only the amortization changes:

        - device re-validation first (``validator``): the whole batch is
          verified in one dispatch per algorithm group, and only a share
          that fails its exact PoW check is rejected;
        - the db work lands in ONE transaction. The happy path writes
          the batch as four grouped statements; if any statement fails
          (constraint violation, injected db fault) the batch rolls
          back to its savepoint and replays per share under individual
          savepoints, so ONLY the offending share is rejected and every
          other share's rows commit with the batch.

        Returns one ``(status, error)`` per input share: ``("ok", "")``
        or ``("err", reason)``. Never raises for per-share failures —
        the caller delivers each verdict to its own miner.
        """
        outcomes: list[tuple[str, str]] = [("ok", "")] * len(batch)
        live = list(range(len(batch)))
        if self.validator is not None:
            # device re-validation FIRST: a share that fails the exact
            # PoW check must never reach the books — it is Byzantine
            # input (a compromised worker process, bus corruption) that
            # per-share host validation would also have refused. Only
            # the offender rejects; batchmates proceed.
            verdicts = await self.validator.verify_batch([
                ShareCheck(
                    header=s.header,
                    target=tgt.difficulty_to_target(s.difficulty),
                    algorithm=s.algorithm,
                    block_number=s.block_number,
                )
                for s in batch
            ])
            live = []
            for i, ok in enumerate(verdicts):
                if ok:
                    live.append(i)
                else:
                    outcomes[i] = ("err", "share failed validation")
        if not live:
            return self._note_batch(outcomes)
        # ledger.flush: THE crash window of the group-commit pipeline —
        # after validation, before the batch's db transaction
        try:
            d = faults.hit("ledger.flush", supports=faults.STEP)
        except Exception as e:
            msg = str(e) or type(e).__name__
            for i in live:
                outcomes[i] = ("err", msg)
            return self._note_batch(outcomes)
        if d is not None:
            if d.delay:
                await asyncio.sleep(d.delay)
            if d.drop:
                # the db flush vanishes while the verdicts stand: shares
                # the books silently miss, which is exactly the audit
                # hole chaos runs exist to surface
                return self._note_batch(outcomes)
        try:
            self._flush_db_batch([(i, batch[i]) for i in live], outcomes)
        except Exception as e:
            # the transaction itself failed (BEGIN/COMMIT, not a
            # statement): nothing landed, every live share is rejected
            # and its miner resubmits once accounting recovers
            msg = str(e) or type(e).__name__
            for i in live:
                if outcomes[i][0] == "ok":
                    outcomes[i] = ("err", msg)
        return self._note_batch(outcomes)

    def _note_batch(
        self, outcomes: list[tuple[str, str]]
    ) -> list[tuple[str, str]]:
        st = self.ledger_stats
        st["batches"] += 1
        ok = sum(1 for status, _ in outcomes if status == "ok")
        st["shares_ok"] += ok
        st["shares_rejected"] += len(outcomes) - ok
        return outcomes

    def _flush_db_batch(
        self, entries: list[tuple[int, AcceptedShare]],
        outcomes: list[tuple[str, str]],
    ) -> None:
        """One db transaction for a whole batch: grouped statements on
        the happy path, per-share savepoint isolation on any failure."""
        shares = [s for _, s in entries]
        committed = shares
        with self.db.transaction():
            try:
                self.db.savepoint("ledger_batch")
                self._write_share_rows(shares)
                self.db.release("ledger_batch")
            except Exception:
                self.db.rollback_to("ledger_batch")
                committed = []
                for i, s in entries:
                    try:
                        self.db.savepoint("ledger_share")
                        self._write_share_rows([s])
                        self.db.release("ledger_share")
                        committed.append(s)
                    except Exception as e:
                        self.db.rollback_to("ledger_share")
                        outcomes[i] = ("err", str(e) or type(e).__name__)
        for s in committed:
            self._known_workers.add(s.worker_user)

    def _write_share_rows(self, shares: list[AcceptedShare]) -> None:
        """The statements one batch owes the db, grouped: one upsert for
        unseen workers, one share-count bump per worker, one insert for
        the share rows, one credit per PPS-credited worker. Row order is
        batch order, so PPLNS windows read exactly what N per-share
        inserts would have written."""
        unseen: list[str] = []
        counts: dict[str, int] = {}
        credits: dict[str, int] = {}
        for s in shares:
            w = s.worker_user
            if w not in self._known_workers and w not in counts:
                unseen.append(w)
            counts[w] = counts.get(w, 0) + 1
            credit = self.calculator.pps_credit(s.difficulty)
            if credit:
                credits[w] = credits.get(w, 0) + credit
        if unseen:
            self.workers.upsert_many(unseen)
        self.workers.record_shares_many(list(counts.items()))
        self.shares.create_many([
            (s.worker_user, s.job_id, s.difficulty, s.actual_difficulty,
             s.is_block, s.submitted_at)
            for s in shares
        ])
        if credits:
            self.workers.credit_many(list(credits.items()))

    async def on_block(self, header: bytes, job: Job, share: AcceptedShare) -> None:
        reward = self._job_rewards.get(job.job_id, self._current_reward)
        outcome = await self.submitter.submit(header, share.worker_user, reward)
        if not outcome.accepted:
            return
        self.distribute_block(reward, finder=share.worker_user)

    # -- reward distribution ------------------------------------------------

    def distribute_block(self, reward: int, finder: str | None = None) -> None:
        if self.config.payout.scheme == PayoutScheme.PROP:
            window = self.shares.since(self._round_start)
            self._round_start = time.time()
        else:
            window = self.shares.last_n(self.config.payout.pplns_window)
        result = self.calculator.calculate_block(reward, window, finder=finder)
        with self.db.transaction():
            # batched: a block touches every worker in the payout window,
            # and this runs on the submit path when a share solves a
            # block — per-worker statement round-trips here were the
            # dominant cost of a block under four-digit connection counts
            self.workers.upsert_many([p.worker for p in result.payouts])
            self.workers.credit_many(
                [(p.worker, p.amount) for p in result.payouts]
            )
        self.db.audit(
            "pool", "distribute_block",
            f"reward={reward} fee={result.pool_fee} workers={len(result.payouts)}",
        )
        log.info(
            "distributed block reward %d to %d workers (fee %d)",
            reward, len(result.payouts), result.pool_fee,
        )

    # -- payout processing --------------------------------------------------

    async def process_payouts(self) -> int:
        """Pay out all balances above the minimum. Returns count paid."""
        cfg = self.config.payout
        outputs: dict[str, int] = {}
        entries: list[tuple[str, str, int, int]] = []  # worker,address,amount,payout_id
        for name, address, payable in stage_payable_workers(
                self.workers.list(), cfg):
            pid = self.payout_repo.create(name, address, payable)
            entries.append((name, address, payable, pid))
            outputs[address] = outputs.get(address, 0) + payable
        if not outputs:
            return 0
        try:
            tx_id = await self.wallet.send_many(outputs)
        except Exception as e:
            log.error("payout batch failed: %s", e)
            for _, _, _, pid in entries:
                self.payout_repo.mark_failed(pid)
            return 0
        with self.db.transaction():
            for worker, _, amount, pid in entries:
                self.payout_repo.mark_sent(pid, tx_id)
                self.workers.debit_for_payout(worker, amount + cfg.payout_fee)
        self.db.audit("pool", "payout_batch", f"tx={tx_id} outputs={len(outputs)}")
        log.info("paid %d workers in tx %s", len(entries), tx_id)
        return len(entries)

    # -- background loops ---------------------------------------------------

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._tasks.append(loop.create_task(self._payout_loop()))
        self._tasks.append(loop.create_task(self._prune_loop()))
        self.submitter.start_confirmation_tracking()

    async def stop(self) -> None:
        await self.submitter.stop()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    async def _payout_loop(self) -> None:
        if self.config.payout_interval <= 0:
            # payouts are owned elsewhere (the crash-safe settlement
            # engine, pool/settlement.py) — two payers over one balance
            # table would double-spend it
            return
        while True:
            await asyncio.sleep(self.config.payout_interval)
            await self.process_payouts()

    async def _prune_loop(self) -> None:
        while True:
            await asyncio.sleep(3600.0)
            pruned = self.shares.prune_before(
                time.time() - self.config.share_retention_seconds
            )
            if pruned:
                log.info("pruned %d old shares", pruned)

    # -- reporting ----------------------------------------------------------

    def snapshot(self) -> dict:
        snap = {
            "workers": len(self.workers.list()),
            "shares": self.shares.count(),
            "blocks": len(self.blocks.list()),
            "scheme": self.config.payout.scheme.value,
            "ledger": dict(self.ledger_stats),
        }
        if self.validator is not None:
            snap["validation"] = self.validator.snapshot()
        return snap
