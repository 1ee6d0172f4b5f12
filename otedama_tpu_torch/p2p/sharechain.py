"""P2Pool-style share chain: PoW-checked shares, heaviest-work fork choice
(counterpart of ``otedama_tpu/p2p/sharechain.py``, with the durable chain
store of ``p2p/chainstore.py``).

Reference direction: the Go reference sketches a decentralized pool with a
"ledger" message type (internal/mining/p2p_engine.go, internal/p2p/
handlers.go) but trusts every peer's claimed difficulty. P2Pool solved this
in 2011 — shares form their own hash-linked chain at reduced difficulty, so
a share's weight is *proved* by its own PoW, two honest nodes converge on
one heaviest chain, and the PPLNS split is a pure function of that chain.
This module is that construction, asyncio/host-side:

- **Share format.** Each share is a real 80-byte header. The header's
  prev-hash field (bytes 4:36) is the parent SHARE's id — the hash link is
  inside the PoW'd bytes, not metadata. The merkle-root field (bytes
  36:68) is a commitment hash binding the claim metadata (worker, job id,
  timestamp, algorithm, block number), so a relay cannot re-assign a
  share to another worker without redoing its PoW. The nbits field
  encodes the share's claimed target: inflating the claimed difficulty
  changes the header, which changes the digest, which fails the PoW
  check. The share's id is ``sha256d(header)`` (bitcoin block-id rule,
  independent of the PoW algorithm).

- **Verification.** ``verify_share`` is a pure CPU function (commitment
  recompute + one ``pow_host.pow_digest`` call) safe to run on the
  validation executor, off the event loop — slow-algorithm chains (scrypt,
  ethash) hash for milliseconds to seconds per share.

- **Fork choice.** Cumulative work (exact integers, bitcoin chainwork
  formula) from genesis; ties break toward the lexicographically smaller
  share id, so converged record sets imply identical tips on every node
  — no coordination message exists or is needed.

- **Reorg-safe PPLNS.** The best chain is kept as an explicit id list;
  adopting a heavier tip rewinds to the fork point and replays, bounded
  by ``max_reorg_depth`` (a deeper fork is refused and counted — a pool
  must not let one burst rewrite splits beyond its payout horizon).
  ``weights()`` walks the window of that list in chain order, so every
  converged node computes a bit-identical split, by construction.

- **Sync.** Block-locator catch-up (exponentially spaced ids from the
  tip): a peer answers with the suffix after the highest common share, in
  bounded pages — replacing the old unordered timestamp dump.
"""

from __future__ import annotations

import dataclasses
import logging
import struct
import time
from collections import OrderedDict

from otedama_tpu_torch.kernels.target import (
    DIFF1_TARGET,
    bits_to_target,
    difficulty_to_target,
    target_to_bits,
    target_to_difficulty,
)
from otedama_tpu_torch.utils import pow_host

log = logging.getLogger("otedama.p2p.sharechain")

GENESIS = b"\x00" * 32
HEADER_VERSION = 0x20000000
COMMIT_TAG = b"otedama-sharechain-v1"
MAX_WORKER_LEN = 128
MAX_JOB_ID_LEN = 64
MAX_LOCATOR_LEN = 64


class ShareFormatError(ValueError):
    """Payload does not parse as a share (wire-shape problem)."""


class ShareInvalid(ValueError):
    """A parsed share that fails verification. ``reason`` is a stable
    counter key: commitment | difficulty | pow | time-future | algorithm."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"{reason}: {detail}" if detail else reason)
        self.reason = reason


@dataclasses.dataclass(frozen=True)
class ChainParams:
    """Consensus parameters every node of one chain must agree on."""

    algorithm: str = "sha256d"
    min_difficulty: float = 1.0     # floor on a share's claimed difficulty
    window: int = 8192              # PPLNS window, in shares
    max_reorg_depth: int = 96       # deepest rewind a node will perform
    max_time_skew: float = 300.0    # future-dated shares beyond this: reject
    max_orphans: int = 512          # out-of-order holding pen bound
    sync_page: int = 200            # shares per locator-sync response page
    # intended share production cadence, seconds. Not consensus-critical
    # yet (difficulty is fixed, not retargeted); benches and capacity
    # planning read it, and a future retarget rule will gate on it.
    share_interval: float = 10.0

    def max_target(self) -> int:
        """Largest (easiest) share target this chain accepts."""
        return difficulty_to_target(self.min_difficulty)


def tagged_sha256d(tag: bytes, *fields: bytes) -> bytes:
    """Domain-separated sha256d over NUL-joined fields.

    Every commitment in the system hashes under a distinct tag so a digest
    valid in one role can never be replayed in another (share-chain claim
    vs settlement key vs aux-chain slot).
    """
    return pow_host.sha256d(tag + b"\0" + b"\0".join(fields))


def commitment(worker: str, job_id: str, ts_ms: int, algorithm: str,
               block_number: int) -> bytes:
    """The 32-byte claim commitment carried in the header's merkle field."""
    return tagged_sha256d(
        COMMIT_TAG, worker.encode(), job_id.encode(),
        struct.pack("<Q", ts_ms), algorithm.encode(),
        struct.pack("<q", block_number),
    )


@dataclasses.dataclass(frozen=True)
class Share:
    """One verified-or-verifiable share chain entry."""

    header: bytes            # the 80 PoW'd bytes
    worker: str
    job_id: str
    ts_ms: int               # claim timestamp, milliseconds (committed)
    algorithm: str = "sha256d"
    block_number: int = 0    # DAG-class algorithms pick their epoch from it

    # -- derived views -------------------------------------------------------

    @property
    def share_id(self) -> bytes:
        return pow_host.sha256d(self.header)

    @property
    def prev_hash(self) -> bytes:
        return self.header[4:36]

    @property
    def nbits(self) -> int:
        return struct.unpack("<I", self.header[72:76])[0]

    @property
    def target(self) -> int:
        return bits_to_target(self.nbits)

    @property
    def difficulty(self) -> float:
        return target_to_difficulty(self.target)

    @property
    def work(self) -> int:
        """Exact expected-hashes work unit (bitcoin chainwork formula)."""
        return (1 << 256) // (self.target + 1)

    # -- wire ----------------------------------------------------------------

    def to_payload(self) -> dict:
        return {
            "header": self.header.hex(),
            "worker": self.worker,
            "job_id": self.job_id,
            "ts_ms": self.ts_ms,
            "algorithm": self.algorithm,
            "block_number": self.block_number,
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "Share":
        if not isinstance(payload, dict):
            raise ShareFormatError("share payload must be an object")
        try:
            header = bytes.fromhex(str(payload["header"]))
            worker = str(payload["worker"])
            job_id = str(payload["job_id"])
            ts_ms = int(payload["ts_ms"])
            algorithm = str(payload.get("algorithm", "sha256d"))
            block_number = int(payload.get("block_number", 0))
        except (KeyError, ValueError, TypeError) as e:
            raise ShareFormatError(f"malformed share payload: {e}") from e
        if len(header) != 80:
            raise ShareFormatError(f"header must be 80 bytes, got {len(header)}")
        if not worker or len(worker) > MAX_WORKER_LEN:
            raise ShareFormatError("worker name empty or too long")
        if len(job_id) > MAX_JOB_ID_LEN:
            raise ShareFormatError("job id too long")
        # bounds keep commitment()'s struct packing total: an absurd
        # value must be a clean wire reject (counted per-reason), not a
        # struct.error miscounted as an internal verifier failure
        if not (0 <= ts_ms < 1 << 62) or not (0 <= block_number < 1 << 31):
            raise ShareFormatError("timestamp or block number out of range")
        return cls(header, worker, job_id, ts_ms, algorithm, block_number)


def effective_difficulty(difficulty: float) -> float:
    """The difficulty a share mined at ``difficulty`` actually carries after
    the lossy compact-nbits round trip (what ``weights()`` will credit)."""
    return target_to_difficulty(
        bits_to_target(target_to_bits(difficulty_to_target(difficulty)))
    )


# PPLNS weights are accumulated in EXACT fixed-point integers (64
# fractional bits of difficulty) rather than floats: integer addition is
# associative, so an accumulator maintained incrementally across
# connects and reorgs equals the full window walk BIT-FOR-BIT on every
# node, regardless of the order history arrived in — float summation
# could never promise that, and byte-identical splits are the chain's
# whole contract. ``weights()`` divides back to a float only at the
# read edge.
WEIGHT_FRAC_BITS = 64
_WEIGHT_SCALE = 1 << WEIGHT_FRAC_BITS


def weight_units(target: int) -> int:
    """One share's exact integer PPLNS weight (fixed-point difficulty)."""
    if target <= 0:
        return 0
    return (DIFF1_TARGET << WEIGHT_FRAC_BITS) // target


def verify_share(share: Share, params: ChainParams,
                 now: float | None = None) -> None:
    """Full share verification — pure CPU, executor-safe. Raises
    ``ShareInvalid`` with a stable ``reason`` on any failure.

    Timestamp policy (clock-skew clamp): a share dated more than
    ``max_time_skew`` into the future is REJECTED — no honest clock can be
    there, and accepting it would let one skewed peer pre-date work.
    Past-dated shares are accepted however old: chain linkage orders the
    PPLNS window structurally, so an old timestamp carries no ordering
    power (sync after a partition legitimately delivers old shares); local
    consumers reading timestamps must clamp into ``[0, now + skew]``.
    """
    target = verify_share_claim(share, params, now)
    digest = pow_host.pow_digest(
        share.header, share.algorithm, block_number=share.block_number
    )
    if int.from_bytes(digest, "little") > target:
        raise ShareInvalid("pow", "digest does not meet claimed target")


def verify_share_claim(share: Share, params: ChainParams,
                       now: float | None = None) -> int:
    """The structural half of ``verify_share`` — commitment binding,
    difficulty floor, clock-skew clamp — WITHOUT the PoW digest (the
    expensive half). Returns the share's claimed target so batched
    verification (runtime/validate.py: one device dispatch hashes a
    whole gossip batch) can run the digest+compare elsewhere. Raises
    ``ShareInvalid`` exactly like ``verify_share`` for every
    non-digest defect."""
    if share.algorithm != params.algorithm:
        raise ShareInvalid(
            "algorithm",
            f"chain runs {params.algorithm!r}, share claims {share.algorithm!r}",
        )
    if share.header[36:68] != commitment(
        share.worker, share.job_id, share.ts_ms, share.algorithm,
        share.block_number,
    ):
        raise ShareInvalid("commitment", "header does not commit to claim")
    target = share.target
    if target <= 0 or target > params.max_target():
        raise ShareInvalid(
            "difficulty",
            f"target easier than chain minimum {params.min_difficulty}",
        )
    now = time.time() if now is None else now
    if share.ts_ms / 1000.0 > now + params.max_time_skew:
        raise ShareInvalid("time-future", "share dated beyond allowed skew")
    return target


def clamp_timestamp(ts_ms: int, now: float, skew: float) -> float:
    """Normalize a share timestamp for LOCAL, non-consensus use (stats,
    rate estimates): clamped into ``[0, now + skew]`` so one skewed peer
    cannot distort local telemetry. Consensus never reads timestamps."""
    return min(max(ts_ms / 1000.0, 0.0), now + skew)


def mine_share(prev_hash: bytes, worker: str, job_id: str,
               difficulty: float, algorithm: str = "sha256d",
               block_number: int = 0, ts_ms: int | None = None,
               max_tries: int = 1 << 28) -> Share:
    """Grind a valid share extending ``prev_hash`` on the host.

    Test/bootstrap path: production deployments derive share headers from
    device-found candidates. The claimed target is the compact-rounded
    ``difficulty`` (so the mined share's credited weight is
    ``effective_difficulty(difficulty)``).
    """
    if len(prev_hash) != 32:
        raise ValueError("prev_hash must be 32 bytes")
    ts_ms = int(time.time() * 1000) if ts_ms is None else int(ts_ms)
    nbits = target_to_bits(difficulty_to_target(difficulty))
    target = bits_to_target(nbits)
    commit = commitment(worker, job_id, ts_ms, algorithm, block_number)
    ntime = max(0, ts_ms // 1000)
    prefix = (
        struct.pack("<I", HEADER_VERSION) + prev_hash + commit
        + struct.pack("<I", ntime & 0xFFFFFFFF) + struct.pack("<I", nbits)
    )
    for nonce in range(max_tries):
        header = prefix + struct.pack(">I", nonce)
        digest = pow_host.pow_digest(header, algorithm,
                                     block_number=block_number)
        if int.from_bytes(digest, "little") <= target:
            return Share(header, worker, job_id, ts_ms, algorithm,
                         block_number)
    raise RuntimeError(
        f"no share found in {max_tries} tries at difficulty {difficulty}"
    )


def mine_share_chain(prev_hash: bytes, claims: list[tuple[str, str]],
                     difficulty: float, algorithm: str = "sha256d",
                     block_number: int = 0,
                     advance: list[bool] | None = None) -> list[Share]:
    """Grind a lineage-ordered RUN of shares in one host call — the
    group-commit ledger's batch form of ``mine_share``: share i+1
    extends share i, so a whole accepted-share batch costs one executor
    hop instead of one per share. ``claims`` is ``(worker, job_id)``
    per share; ``advance[i] = False`` grinds share i off the current
    tip WITHOUT advancing it (the region replicator's dropped-commit
    fault semantics: a share that will not be submitted must not become
    anyone's parent)."""
    prev = prev_hash
    out: list[Share] = []
    for i, (worker, job_id) in enumerate(claims):
        share = mine_share(prev, worker, job_id, difficulty,
                           algorithm=algorithm, block_number=block_number)
        out.append(share)
        if advance is None or advance[i]:
            prev = share.share_id
    return out


# -- the chain ----------------------------------------------------------------

@dataclasses.dataclass
class _Rec:
    share: Share
    height: int
    cumwork: int


class ShareChain:
    """The verified share DAG + its heaviest-chain view.

    Single-threaded by design: verification (the expensive part) runs on
    executor threads, but ``connect``/fork choice/window maintenance run
    on the event loop only — linking is dict work, and serializing it
    makes the reorg bookkeeping trivially race-free.

    With a ``store`` (p2p/chainstore.py) attached, the chain is durable
    and MEMORY-BOUNDED: every best-chain extension/reorg is enqueued
    onto the store's event ring (µs — the encode/CRC/write/fsync all
    happen on the store's dedicated writer thread), settled positions
    are archived out of RAM behind a fixed in-memory tail
    (``compact()`` stages them; the writer lands them), checkpointed
    snapshots make a reboot replay only the mutable tail (``load()``),
    and the PPLNS window — maintained as an exact integer per-worker
    accumulator, not an O(window) walk — can span millions of shares
    while memory holds only ``tail_shares`` records. Durability is a
    WATERMARK, not a blocking write: consumers that must not ack before
    the disk has the share (the group-commit ledger in
    ``chain.durability: ack`` mode) ``await wait_persisted()``; everyone
    else proceeds after the in-memory link with crash loss bounded by
    the exported persist lag. Without a store nothing changes except
    ``weights()`` getting O(workers) instead of O(window).
    """

    def __init__(self, params: ChainParams | None = None, store=None):
        self.params = params or ChainParams()
        # optional durable chain store (p2p/chainstore.py ChainStore)
        self.store = store
        # observer fired for EVERY share linked into the DAG (any
        # branch, own or synced) — the multi-region replicator builds
        # its cross-region submission index from it. Event-loop only,
        # must not raise, must not call back into the chain.
        self.on_connect: "Callable[[Share], None] | None" = None
        self.records: dict[bytes, _Rec] = {}
        self.orphans: dict[bytes, Share] = {}          # id -> share (FIFO)
        self._orphans_by_prev: dict[bytes, set[bytes]] = {}
        self.tip: bytes | None = None
        # the in-memory TAIL of the best chain: _chain[i] is the share at
        # absolute height _base + i; positions below _base live only in
        # the archive. _pos values are ABSOLUTE heights.
        self._chain: list[bytes] = []
        self._pos: dict[bytes, int] = {}               # id -> height on best
        self._base = 0                                 # archived prefix length
        self._base_tip: bytes = GENESIS                # share id at _base - 1
        self._base_cumwork = 0                         # cumwork at _base - 1
        # exact integer PPLNS window accumulator: worker -> weight units
        # over the last `window` best-chain shares, maintained on every
        # extend/rewind (checked against the full walk in tests)
        self._acc: dict[str, int] = {}
        # its twin AT the archived boundary: the window accumulator as
        # of position _base, advanced incrementally each compact() so a
        # snapshot captures it in O(workers) instead of re-deriving it
        # with an O(tail) walk on the event loop (kept equal to
        # _acc_at_base() by construction; crash-image tests pin it)
        self._acc_base: dict[str, int] = {}
        # read-ahead cache for window-edge archive lookups (the share
        # leaving the window advances sequentially with the tip)
        self._edge_cache: OrderedDict[int, tuple[str, int]] = OrderedDict()
        # archived ids remembered for duplicate detection (bounded by
        # store.config.dup_cache_shares) — records used to provide this
        # from genesis; without it a replayed ancient share would file
        # as an orphan and re-flood
        self._archived_ids: OrderedDict[bytes, None] = OrderedDict()
        # memo for archived share_id_at point reads (locator entries are
        # exponentially spaced and immutable once archived — without
        # this every locator() call re-reads segments off disk)
        self._id_cache: OrderedDict[int, bytes] = OrderedDict()
        self._replaying = False            # load() suppresses journaling
        # stats
        self.shares_connected = 0
        self.orphans_adopted = 0
        self.orphans_evicted = 0
        self.reorgs = 0
        self.deepest_reorg = 0
        self.reorgs_refused = 0
        self.stale_refused = 0
        self._persist_failures = 0

    # -- views ---------------------------------------------------------------

    @property
    def height(self) -> int:
        """Number of shares on the best chain (archived + in memory)."""
        return self._base + len(self._chain)

    @property
    def archived_height(self) -> int:
        """Best-chain positions archived out of memory (the in-memory
        tail starts here) — the public form of the store boundary that
        downstream consumers (regions' recommit sweep) reason about."""
        return self._base

    @property
    def tip_work(self) -> int:
        if self.tip is None:
            return 0
        rec = self.records.get(self.tip)
        return rec.cumwork if rec is not None else self._base_cumwork

    @property
    def persist_failures(self) -> int:
        """Chain-side staging failures + the store writer's journal/
        archive failures — one degraded-durability counter however the
        loss happened (the metric surface the store exports)."""
        total = self._persist_failures
        if self.store is not None:
            total += self.store.stats.get("persist_failures", 0)
        return total

    # -- durability watermark -------------------------------------------------

    def durability_barrier(self) -> int:
        """The store watermark value covering every best-chain event
        submitted so far (0 without a store)."""
        return self.store.barrier_seq() if self.store is not None else 0

    async def wait_persisted(self, seq: int | None = None) -> None:
        """Await the durability watermark covering ``seq`` (default:
        everything submitted so far). THE ack-mode primitive: the
        group-commit ledger calls this between its chain commit and its
        db transaction, so no miner is ever told "accepted" for a share
        a crash could take from the journal. Returns immediately without
        a store, and returns (rather than wedging) when the writer is
        degraded — failures are counted and alarmed, never blocking."""
        if self.store is None:
            return
        await self.store.wait_seq(
            self.store.barrier_seq() if seq is None else seq)

    def persisted_height(self) -> int:
        """Monotonic height watermark: the highest best-chain position
        ever covered by a journal fsync (+1 semantics match ``height``:
        positions <= this are durable). Without a store the whole chain
        counts (memory is all the durability there is). Downstream
        consumers — the region recommit sweep — use this to avoid
        forgetting a tracked commit before the journal can prove it."""
        if self.store is None:
            return self.height - 1
        return self.store.persisted_height

    def drain(self, timeout: float = 60.0) -> bool:
        """Thread-blocking flush of the store's writer pipeline (tests,
        benches, shutdown — never the event loop)."""
        if self.store is None:
            return True
        return self.store.drain(timeout)

    def __contains__(self, share_id: bytes) -> bool:
        return (share_id in self.records or share_id in self.orphans
                or (self._base > 0 and share_id == self._base_tip)
                or share_id in self._archived_ids)

    def weights(self) -> dict[str, float]:
        """PPLNS weights over the window of the best chain — identical
        on every converged node by construction. O(active workers): the
        window is an incrementally maintained exact integer accumulator,
        not a chain walk, so a million-share window costs the same as a
        thousand-share one."""
        return {w: u / _WEIGHT_SCALE for w, u in self._acc.items()}

    def weights_full(self) -> dict[str, float]:
        """The full-window walk oracle for ``weights()`` — O(window),
        reads archived segments as needed. Tests and audits assert the
        incremental accumulator equals this bit-for-bit."""
        acc: dict[str, int] = {}
        for share in self.chain_slice(max(0, self.height - self.params.window),
                                      self.height):
            acc[share.worker] = acc.get(share.worker, 0) + weight_units(
                share.target)
        return {w: u / _WEIGHT_SCALE for w, u in acc.items()}

    # -- settlement horizon --------------------------------------------------

    def settled_height(self) -> int:
        """Length of the IMMUTABLE prefix of the best chain. Forks deeper
        than ``max_reorg_depth`` are refused (``_maybe_adopt``), so a
        position below this can never be rewound — the settlement engine
        (pool/settlement.py) snapshots only below it, which is what makes
        settled credit un-reorgable by construction."""
        return max(0, self.height - self.params.max_reorg_depth)

    def share_id_at(self, height: int) -> bytes:
        """Best-chain share id at a 0-based chain position (archived
        positions are a memoized store point-read — archived ids are
        immutable, so the cache never invalidates)."""
        if height >= self._base:
            return self._chain[height - self._base]
        sid = self._id_cache.get(height)
        if sid is None:
            sid = self.store.read_share_id(height)
            self._id_cache[height] = sid
            while len(self._id_cache) > 512:
                self._id_cache.popitem(last=False)
        return sid

    def chain_slice(self, start: int, end: int) -> list[Share]:
        """Best-chain shares for positions ``[start, end)``, chain order.
        Positions below ``settled_height()`` are stable; callers slicing
        above it own the reorg risk. Archived positions stream from the
        store, so settlement cursors resume over segments a reboot (or
        long downtime) left behind."""
        end = min(end, self.height)
        if start >= end:
            return []
        out: list[Share] = []
        if start < self._base:
            out.extend(share for _h, _sid, share
                       in self.store.read_range(start, min(end, self._base)))
        if end > self._base:
            lo = max(start, self._base) - self._base
            out.extend(self.records[sid].share
                       for sid in self._chain[lo:end - self._base])
        return out

    def position_of(self, share_id: bytes) -> int | None:
        """Best-chain position of a share id (None when off-chain or
        archived out of the in-memory tail) — settlement uses
        ``on_best_chain_at`` for cursor checks, which also covers the
        archived prefix."""
        if self._base > 0 and share_id == self._base_tip:
            return self._base - 1
        return self._pos.get(share_id)

    def on_best_chain_at(self, share_id: bytes, height: int) -> bool:
        """True when ``share_id`` is the best-chain share at absolute
        position ``height`` — a point check that works for archived
        positions too (one store read), unlike ``position_of``."""
        if not (0 <= height < self.height):
            return False
        return self.share_id_at(height) == share_id

    # -- linking -------------------------------------------------------------

    def connect(self, share: Share) -> str:
        """Link one VERIFIED share. Returns ``accepted`` (linked, possibly
        adopting queued orphans), ``orphan`` (parent unknown — held),
        ``duplicate``, or ``stale`` (extends an ARCHIVED ancestor — by
        construction deeper than any permitted reorg, so it can never be
        adopted; refusing outright keeps replayed ancient lineages from
        churning the orphan pen or re-flooding). Never verifies: callers
        run ``verify_share`` first, off the loop."""
        sid = share.share_id
        if sid in self:
            return "duplicate"
        prev = share.prev_hash
        if prev in self._archived_ids and not (
                self._base > 0 and prev == self._base_tip):
            self.stale_refused += 1
            return "stale"
        if (prev != GENESIS and prev not in self.records
                and not (self._base > 0 and prev == self._base_tip)):
            while len(self.orphans) >= self.params.max_orphans:
                old_id, old = next(iter(self.orphans.items()))
                del self.orphans[old_id]
                waiting = self._orphans_by_prev.get(old.prev_hash)
                if waiting is not None:
                    waiting.discard(old_id)
                    if not waiting:
                        del self._orphans_by_prev[old.prev_hash]
                self.orphans_evicted += 1
            self.orphans[sid] = share
            self._orphans_by_prev.setdefault(prev, set()).add(sid)
            return "orphan"
        self._link(share)
        # adopt orphans that were waiting on this lineage, oldest first
        queue = [sid]
        while queue:
            parent = queue.pop(0)
            for oid in sorted(self._orphans_by_prev.pop(parent, ())):
                orphan = self.orphans.pop(oid, None)
                if orphan is not None:
                    self._link(orphan)
                    self.orphans_adopted += 1
                    queue.append(oid)
        return "accepted"

    def _link(self, share: Share) -> None:
        prev = share.prev_hash
        parent = self.records.get(prev)
        if parent is not None:
            height = parent.height + 1
            cumwork = parent.cumwork + share.work
        elif self._base > 0 and prev == self._base_tip:
            # extending the archived boundary share (fresh boot, empty tail)
            height = self._base
            cumwork = self._base_cumwork + share.work
        else:
            height = 0
            cumwork = share.work
        sid = share.share_id
        self.records[sid] = _Rec(share, height, cumwork)
        self.shares_connected += 1
        self._maybe_adopt(sid)
        if self.on_connect is not None:
            self.on_connect(share)

    def _maybe_adopt(self, sid: bytes) -> None:
        """Fork choice: heaviest cumulative work; ties break to the
        smaller id so every converged node picks the same tip."""
        rec = self.records[sid]
        if self.tip is not None:
            if (rec.cumwork, self.tip) <= (self.tip_work, sid):
                # strictly-more work wins; equal work wins only on a
                # smaller id (note the swapped ids in the comparison)
                return
        # walk the candidate's lineage back to the best chain (fork point)
        path: list[bytes] = []
        h = sid
        while h != GENESIS and h not in self._pos:
            if self._base > 0 and h == self._base_tip:
                break
            r = self.records.get(h)
            if r is None:
                return  # lineage pruned from under us: cannot adopt
            path.append(h)
            h = r.share.prev_hash
        if h in self._pos:
            fork_height = self._pos[h]
        elif h == GENESIS:
            if self._base > 0:
                # a from-genesis lineage while our prefix is archived
                # would rewind below the archive — structurally refused
                # (it is deeper than any permitted reorg by definition)
                self.reorgs_refused += 1
                return
            fork_height = -1
        else:                        # h == self._base_tip
            fork_height = self._base - 1
        depth = self.height - (fork_height + 1)
        if self.tip is not None and depth > self.params.max_reorg_depth:
            self.reorgs_refused += 1
            return
        if depth > 0 and self.tip is not None:
            self.reorgs += 1
            self.deepest_reorg = max(self.deepest_reorg, depth)
        if depth > 0:
            self._rewind_to(fork_height + 1)
        for h in reversed(path):
            self._append_best(h)
        self.tip = sid

    def _rewind_to(self, new_height: int) -> None:
        """Drop best-chain positions >= ``new_height`` (reorg rewind),
        maintaining the window accumulator and journaling the event.
        Rewound records stay linked as a side branch."""
        if self.store is not None and not self._replaying:
            self._persist("journal",
                          lambda: self.store.append_reorg(new_height))
        while self.height > new_height:
            old = self._chain.pop()
            del self._pos[old]
            self._pop_acc(self.records[old].share)

    def _append_best(self, sid: bytes) -> None:
        """Append one linked record to the best chain, maintaining the
        window accumulator and journaling the extension."""
        h = self.height
        self._pos[sid] = h
        self._chain.append(sid)
        rec = self.records[sid]
        self._push_acc(rec.share)
        if self.store is not None and not self._replaying:
            # inline rather than through _persist: this is THE hottest
            # persistence call and a closure allocation per connect was
            # measurable at bench rates (the submit only enqueues; real
            # IO failures surface on the writer thread, counted there)
            try:
                self.store.append_extend(h, rec.share, sid, rec.cumwork)
            except Exception as e:
                self._persist_failures += 1
                log.warning("chain journal persistence failed "
                            "(continuing in-memory): %s", e)

    def _persist(self, what: str, fn) -> None:
        """Run one store operation; a persistence failure NEVER poisons
        the in-memory chain — it is counted, logged, and visible as
        degraded durability (metrics), while consensus carries on."""
        try:
            fn()
        except Exception as e:
            self._persist_failures += 1
            log.warning("chain %s persistence failed (continuing "
                        "in-memory): %s", what, e)

    # -- PPLNS window accumulator ---------------------------------------------

    def _push_acc(self, share: Share) -> None:
        """Window maintenance for one best-chain append: the new share
        enters; the share falling off the window's far edge leaves. An
        unreadable archived edge (corrupt segment) degrades the
        accumulator VISIBLY (counted + logged) instead of crashing the
        connect path — consensus must outlive a bad disk sector."""
        self._acc[share.worker] = (
            self._acc.get(share.worker, 0) + weight_units(share.target))
        lo = self.height - self.params.window
        if lo > 0:
            try:
                worker, units = self._window_entry(lo - 1)
            except Exception as e:
                self._persist_failures += 1
                log.error("window-edge read failed at %d (weights "
                          "degraded until restored from peers): %s",
                          lo - 1, e)
                return
            self._acc_sub(worker, units)

    def _pop_acc(self, share: Share) -> None:
        """Window maintenance for one rewind: the popped share leaves;
        the share that re-enters at the far edge (if the window was
        full) comes back — possibly from the archive, bounded by
        ``max_reorg_depth`` reads per reorg."""
        self._acc_sub(share.worker, weight_units(share.target))
        lo = self.height + 1 - self.params.window
        if lo > 0:
            try:
                worker, units = self._window_entry(lo - 1)
            except Exception as e:
                self._persist_failures += 1
                log.error("window-edge read failed at %d (weights "
                          "degraded until restored from peers): %s",
                          lo - 1, e)
                return
            self._acc[worker] = self._acc.get(worker, 0) + units

    def _acc_sub(self, worker: str, units: int,
                 acc: dict[str, int] | None = None) -> None:
        acc = self._acc if acc is None else acc
        left = acc.get(worker, 0) - units
        if left == 0:
            acc.pop(worker, None)
        else:
            # a negative residue would be an accounting bug — keep it
            # visible in weights() rather than silently clamping
            acc[worker] = left

    def _window_entry(self, height: int) -> tuple[str, int]:
        """(worker, weight units) of the best-chain share at an absolute
        position — from memory, or from the archive via a sequential
        read-ahead cache (window edges advance with the tip, so one
        archive scan serves hundreds of connects)."""
        if height >= self._base:
            share = self.records[self._chain[height - self._base]].share
            return share.worker, weight_units(share.target)
        entry = self._edge_cache.get(height)
        if entry is None:
            try:
                for h, _sid, share in self.store.read_range(height,
                                                            height + 256):
                    self._edge_cache[h] = (share.worker,
                                           weight_units(share.target))
                    self._edge_cache.move_to_end(h)
            except Exception:
                pass  # partial read-ahead is fine; the point read decides
            while len(self._edge_cache) > 4096:
                self._edge_cache.popitem(last=False)
            entry = self._edge_cache.get(height)
            if entry is None:
                # a direct point read raises ChainStoreError on a truly
                # unreadable record — the caller degrades visibly
                share = self.store.read_share(height)
                entry = (share.worker, weight_units(share.target))
                self._edge_cache[height] = entry
        return entry

    # -- locator sync --------------------------------------------------------

    def locator(self) -> list[str]:
        """Block-locator hashes: dense near the tip, exponentially sparse
        toward genesis, genesis-most element always included. Entries
        below the archived boundary are store point-reads (a handful —
        the spacing is exponential)."""
        out: list[str] = []
        step, h = 1, self.height - 1
        while h >= 0:
            out.append(self.share_id_at(h).hex())
            if len(out) >= 10:
                step *= 2
            h -= step
        if self.height:
            first = self.share_id_at(0).hex()
            if out[-1] != first:
                out.append(first)
        return out

    def shares_after(self, locator_hex: list[str],
                     limit: int | None = None) -> tuple[list[Share], bool]:
        """The suffix of the best chain after the highest locator hash we
        recognize (or from genesis when none match), oldest first, at most
        ``limit`` shares. Returns ``(shares, more)``. Pages below the
        archived boundary stream from the store, so this node can fully
        bootstrap a peer (or its own wiped sibling) from disk. Locator
        entries pointing into our archived prefix are not matched by id
        (no id→height index is kept for the archive) — such a far-behind
        peer is served from genesis, which is correct, merely unsparing."""
        limit = self.params.sync_page if limit is None else max(1, int(limit))
        start = 0
        for hh in locator_hex[:MAX_LOCATOR_LEN]:
            try:
                pos = self.position_of(bytes.fromhex(str(hh)))
            except ValueError:
                continue
            if pos is not None:
                start = pos + 1
                break
        page = self.chain_slice(start, start + limit)
        return page, start + limit < self.height

    # -- housekeeping --------------------------------------------------------

    def prune_side_branches(self) -> int:
        """Drop records that can never matter again: off the best chain
        AND deeper below the tip than any permitted reorg. Best-chain
        records are kept until ``compact()`` archives them (with a
        store) — they serve locator sync from genesis either way."""
        if self.tip is None:
            return 0
        if len(self.records) == len(self._pos):
            # every linked record is ON the best chain: nothing to scan.
            # The full-records sweep below is O(tail) — paying it every
            # housekeeping pass when no fork ever happened was a
            # measurable slice of the durable connect path.
            return 0
        horizon = self.height - 1 - self.params.max_reorg_depth
        doomed = [
            sid for sid, rec in self.records.items()
            if sid not in self._pos and rec.height < horizon
        ]
        for sid in doomed:
            del self.records[sid]
        return len(doomed)

    def compact(self) -> int:
        """One housekeeping pass: prune dead side branches, STAGE the
        settled best-chain prefix out of memory behind the configured
        tail (the store's writer thread lands the records on disk), and
        queue a snapshot if the archived boundary advanced enough. This
        is what bounds memory: after a compact, RAM holds at most
        ``tail_shares`` + the reorg horizon + live side branches +
        whatever the writer has not flushed yet, regardless of window or
        chain length. Nothing here touches the disk on the calling
        thread — the event loop pays dict work only. No-op beyond
        pruning when no store is attached."""
        pruned = self.prune_side_branches()
        if self.store is None:
            return pruned
        new_base = max(self._base, min(
            self.settled_height(),
            self.height - self.store.config.tail_shares))
        count = new_base - self._base
        if count > 0:
            batch = []
            for i in range(count):
                sid = self._chain[i]
                rec = self.records[sid]
                batch.append((self._base + i, sid, rec.share, rec.cumwork))
            try:
                self.store.stage_archive(batch)
            except Exception as e:
                self._persist_failures += 1
                log.warning("chain archive staging failed "
                            "(keeping records in memory): %s", e)
            else:
                # advance the boundary accumulator over the archived
                # span: each share enters its window, the share falling
                # off that window's far edge leaves (mirror of
                # _push_acc, at the boundary instead of the tip)
                w = self.params.window
                for i, (h, _sid, share, _cw) in enumerate(batch):
                    self._acc_base[share.worker] = (
                        self._acc_base.get(share.worker, 0)
                        + weight_units(share.target))
                    lo = h + 1 - w
                    if lo > 0:
                        try:
                            worker, units = self._window_entry(lo - 1)
                        except Exception as e:
                            self._persist_failures += 1
                            log.error("boundary window-edge read failed "
                                      "at %d: %s", lo - 1, e)
                            continue
                        self._acc_sub(worker, units, self._acc_base)
                last = self._chain[count - 1]
                self._base_cumwork = self.records[last].cumwork
                self._base_tip = last
                for sid in self._chain[:count]:
                    del self.records[sid]
                    del self._pos[sid]
                    self._archived_ids[sid] = None
                del self._chain[:count]
                self._base += count
                cap = self.store.config.dup_cache_shares
                while len(self._archived_ids) > cap:
                    self._archived_ids.popitem(last=False)
                interval = self.store.config.snapshot_interval
                if self._base - max(self.store.snapshot_height, 0) >= interval:
                    # guarded like every other store operation: a failing
                    # snapshot submission must degrade durability visibly,
                    # never reject the share being connected right now
                    self._persist("snapshot", self.request_snapshot)
        return pruned

    # -- snapshots / cold boot ------------------------------------------------

    def _snapshot_job(self) -> tuple[dict, list | None] | None:
        """Capture the checkpoint INPUTS on the calling thread: the
        boundary state (per-worker window accumulator AT the boundary —
        the incrementally maintained ``_acc_base``, O(workers) to copy;
        tip/cumwork there) and, only when the store's height->seq map
        cannot name the replay boundary (pre-boot heights, dropped
        events), a copy-on-write view of the in-memory tail for the
        writer's fallback rewrite. The chain mutating afterwards cannot
        skew the captures, and the event ring's FIFO orders the
        snapshot after every event already submitted."""
        if self.store is None:
            return None
        state = {
            "height": self._base,
            "tip": self._base_tip.hex(),
            "cumwork": str(self._base_cumwork),
            "acc": {w: str(u) for w, u in self._acc_base.items()},
            "params": {"algorithm": self.params.algorithm,
                       "window": self.params.window},
        }
        tail: list | None = None
        if self._chain and not self.store.can_bound(self._base):
            tail = [(self._base + i, self.records[sid].share, sid,
                     self.records[sid].cumwork)
                    for i, sid in enumerate(self._chain)]
        elif not self._chain:
            tail = []
        return state, tail

    def request_snapshot(self) -> bool:
        """Queue a checkpoint onto the store's writer (non-blocking —
        the connect path's spelling). False when one is already in
        flight or the store refused the submission."""
        job = self._snapshot_job()
        if job is None:
            return False
        return self.store.submit_snapshot(*job) is not None

    def write_snapshot(self, timeout: float = 120.0) -> bool:
        """Blocking checkpoint (benches, tests, shutdown hooks — never
        the event loop): queue the snapshot and wait for the writer to
        land it. A failed snapshot leaves the previous one in force."""
        job = self._snapshot_job()
        if job is None:
            return False
        box = self.store.submit_snapshot(*job)
        if box is None:
            return False
        box["done"].wait(timeout)
        return bool(box.get("ok"))

    def _acc_at_base(self) -> dict[str, int]:
        """The window accumulator AS OF the archived boundary: the live
        accumulator minus the in-memory tail's contributions plus the
        archived shares that were still in-window back then. Both
        adjustment ranges are bounded by the tail length."""
        acc = dict(self._acc)
        h, base, w = self.height, self._base, self.params.window
        lo_now, lo_base = max(0, h - w), max(0, base - w)
        for share in self.chain_slice(max(lo_now, base), h):
            units = weight_units(share.target)
            left = acc.get(share.worker, 0) - units
            if left == 0:
                acc.pop(share.worker, None)
            else:
                acc[share.worker] = left
        for share in self.chain_slice(lo_base, min(lo_now, base)):
            acc[share.worker] = (
                acc.get(share.worker, 0) + weight_units(share.target))
        return acc

    def load(self) -> dict:
        """Cold boot from the attached store: restore the archived
        boundary from the snapshot (O(1)) — or, with a torn/absent
        snapshot, from the archive itself (O(window) accumulator walk,
        the honest degraded path) — then fold the journal suffix to the
        converged tip. Replay work is bounded by the unsnapshotted
        suffix + ``max_reorg_depth``, never chain length. Whatever a
        crash cut off past the last durable record comes back from
        peers via ordinary locator sync."""
        if self.store is None:
            raise ValueError("no chain store attached")
        if self.height or self.records or self._base:
            raise RuntimeError("load() requires an empty chain")
        t0 = time.perf_counter()
        snap = self.store.read_snapshot()
        source = "empty"
        if snap is not None:
            p = snap.get("params", {})
            if p.get("algorithm") != self.params.algorithm:
                raise ValueError(
                    f"chain store belongs to a {p.get('algorithm')!r} "
                    f"chain, this node runs {self.params.algorithm!r}")
            if (int(p.get("window", -1)) != self.params.window
                    or int(snap["height"]) > self.store.archived_height):
                # window changed (accumulator scale differs) or the
                # snapshot claims archive state we cannot see: rebuild
                # from the archive instead of trusting it
                snap = None
        after_seq = -1
        if snap is not None:
            self._base = int(snap["height"])
            self._base_tip = (bytes.fromhex(snap["tip"]) if self._base
                              else GENESIS)
            self._base_cumwork = int(snap["cumwork"])
            self._acc = {w: int(u) for w, u in snap.get("acc", {}).items()}
            after_seq = int(snap["journal_seq"])
            source = "snapshot"
        elif self.store.archived_height:
            S = self.store.archived_height
            self._base = S
            self._base_tip, last_share, self._base_cumwork = (
                self.store.read_record(S - 1))
            if last_share.algorithm != self.params.algorithm:
                # same refusal the snapshot path makes: a torn snapshot
                # must not let a foreign chain's archive restore silently
                raise ValueError(
                    f"chain store belongs to a {last_share.algorithm!r} "
                    f"chain, this node runs {self.params.algorithm!r}")
            for _h, _sid, share in self.store.read_range(
                    max(0, S - self.params.window), S):
                self._acc[share.worker] = (
                    self._acc.get(share.worker, 0)
                    + weight_units(share.target))
            source = "archive"
        # the restored accumulator IS the boundary accumulator (nothing
        # above _base is folded yet); keep its incremental twin in step
        self._acc_base = dict(self._acc)
        self.tip = self._base_tip if self._base else None
        # re-arm archived-id duplicate detection over the most recent
        # archived span (bounded by the cache cap, not chain length)
        cap = self.store.config.dup_cache_shares
        if self._base and cap:
            try:
                for _h, sid, _share in self.store.read_range(
                        max(0, self._base - cap), self._base):
                    self._archived_ids[sid] = None
            except Exception as e:
                log.warning("archived-id dup cache rebuild incomplete: %s", e)
        replayed = reorgs_replayed = skipped = 0
        self._replaying = True
        try:
            from otedama_tpu_torch.p2p import chainstore as cs

            for _seq, rtype, payload in self.store.iter_journal(after_seq):
                if rtype == cs.REC_REORG:
                    (nh,) = cs._REORG.unpack(payload)
                    if self._base <= nh < self.height:
                        self._rewind_to(nh)
                        self.tip = (self._chain[-1] if self._chain
                                    else (self._base_tip if self._base
                                          else None))
                        self.reorgs += 1
                        reorgs_replayed += 1
                    else:
                        skipped += 1
                    continue
                height, sid, share, _cumwork = cs.decode_extend(payload)
                expected_prev = (
                    self._chain[-1] if self._chain
                    else (self._base_tip if self._base else GENESIS))
                if (height != self.height
                        or share.prev_hash != expected_prev
                        or pow_host.sha256d(share.header) != sid):
                    # pre-snapshot event, a stale branch, or a hole left
                    # by a lost write: skip — whatever cannot be folded
                    # here comes back from peers
                    skipped += 1
                    continue
                # cumwork is re-derived, never trusted from disk — only
                # the PoW'd header bytes are authoritative
                parent = self.records.get(expected_prev)
                cumwork = (parent.cumwork if parent is not None
                           else self._base_cumwork) + share.work
                self.records[sid] = _Rec(share, height, cumwork)
                self._append_best(sid)
                self.tip = sid
                self.shares_connected += 1
                replayed += 1
                if self.on_connect is not None:
                    self.on_connect(share)
        finally:
            self._replaying = False
        dt = time.perf_counter() - t0
        self.store.stats["replayed_records"] = replayed + reorgs_replayed
        self.store.stats["replay_seconds"] = round(dt, 4)
        # everything restored from disk is durable by definition: seed
        # the watermark so ack-mode consumers and the recommit sweep
        # never wait on (or refuse to trust) pre-boot history
        self.store.note_boot(self.height)
        return {
            "source": source,
            "snapshot_height": self._base if source == "snapshot" else -1,
            "height": self.height,
            "replayed": replayed,
            "reorgs_replayed": reorgs_replayed,
            "skipped": skipped,
            "seconds": round(dt, 4),
        }

    def snapshot(self) -> dict:
        out = {
            "height": self.height,
            "tip": self.tip.hex() if self.tip is not None else "",
            "tip_work": self.tip_work,
            "records": len(self.records),
            "archived_height": self._base,
            "tail": len(self._chain),
            "acc_workers": len(self._acc),
            "orphans": len(self.orphans),
            "orphans_adopted": self.orphans_adopted,
            "orphans_evicted": self.orphans_evicted,
            "shares_connected": self.shares_connected,
            "reorgs": self.reorgs,
            "deepest_reorg": self.deepest_reorg,
            "reorgs_refused": self.reorgs_refused,
            "stale_refused": self.stale_refused,
            "persist_failures": self.persist_failures,
            "window": self.params.window,
            "min_difficulty": self.params.min_difficulty,
            "algorithm": self.params.algorithm,
        }
        if self.store is not None:
            out["store"] = self.store.snapshot()
        return out
