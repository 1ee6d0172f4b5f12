"""P2Pool-style share chain: PoW-checked shares, heaviest-work fork choice
(counterpart of ``otedama_tpu/p2p/sharechain.py``, without the durable
chain store: ``ShareChain`` keeps its chain in memory, exactly as the
reference does with ``store=None``, and refuses a store, naming the
ROADMAP item that carries ``p2p/chainstore.py``).

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
import struct
import time

from otedama_tpu_torch.kernels.target import (
    DIFF1_TARGET,
    bits_to_target,
    difficulty_to_target,
    target_to_bits,
    target_to_difficulty,
)
from otedama_tpu_torch.utils import pow_host


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


# the ROADMAP item that carries the durable chain store
CHAIN_STORE_ITEM = "ROADMAP A6c, with p2p/chainstore.py"


class ShareChain:
    """The verified share DAG + its heaviest-chain view, in memory.

    Single-threaded by design: verification (the expensive part) runs on
    executor threads, but ``connect``/fork choice/window maintenance run
    on the event loop only — linking is dict work, and serializing it
    makes the reorg bookkeeping trivially race-free.

    The PPLNS window is an exact integer per-worker accumulator maintained
    on every extend and rewind, so ``weights()`` is O(workers);
    ``weights_full()`` is the window walk it must equal bit for bit.
    """

    def __init__(self, params: ChainParams | None = None, store=None):
        if store is not None:
            raise ValueError(
                "ShareChain: the durable chain store is not ported yet "
                f"({CHAIN_STORE_ITEM}); the chain lives in memory")
        self.params = params or ChainParams()
        self.records: dict[bytes, _Rec] = {}
        self.orphans: dict[bytes, Share] = {}          # id -> share (FIFO)
        self._orphans_by_prev: dict[bytes, set[bytes]] = {}
        self.tip: bytes | None = None
        # the best chain: _chain[i] is the share at height i
        self._chain: list[bytes] = []
        self._pos: dict[bytes, int] = {}               # id -> height on best
        # exact integer PPLNS window accumulator: worker -> weight units
        # over the last `window` best-chain shares, maintained on every
        # extend/rewind (checked against the full walk in tests)
        self._acc: dict[str, int] = {}
        # stats
        self.shares_connected = 0
        self.orphans_adopted = 0
        self.orphans_evicted = 0
        self.reorgs = 0
        self.deepest_reorg = 0
        self.reorgs_refused = 0

    # -- views ---------------------------------------------------------------

    @property
    def height(self) -> int:
        """Number of shares on the best chain."""
        return len(self._chain)

    @property
    def tip_work(self) -> int:
        if self.tip is None:
            return 0
        return self.records[self.tip].cumwork

    def __contains__(self, share_id: bytes) -> bool:
        return share_id in self.records or share_id in self.orphans

    def weights(self) -> dict[str, float]:
        """PPLNS weights over the window of the best chain — identical
        on every converged node by construction. O(active workers): the
        window is an incrementally maintained exact integer accumulator,
        not a chain walk."""
        return {w: u / _WEIGHT_SCALE for w, u in self._acc.items()}

    def weights_full(self) -> dict[str, float]:
        """The full-window walk oracle for ``weights()`` — O(window).
        Tests and audits assert the incremental accumulator equals this
        bit-for-bit."""
        acc: dict[str, int] = {}
        for share in self.chain_slice(max(0, self.height - self.params.window),
                                      self.height):
            acc[share.worker] = acc.get(share.worker, 0) + weight_units(
                share.target)
        return {w: u / _WEIGHT_SCALE for w, u in acc.items()}

    def share_id_at(self, height: int) -> bytes:
        """Best-chain share id at a 0-based chain position."""
        return self._chain[height]

    def chain_slice(self, start: int, end: int) -> list[Share]:
        """Best-chain shares for positions ``[start, end)``, chain order."""
        end = min(end, self.height)
        return [self.records[sid].share
                for sid in self._chain[max(start, 0):end]]

    def position_of(self, share_id: bytes) -> int | None:
        """Best-chain position of a share id (None when off-chain)."""
        return self._pos.get(share_id)

    # -- linking -------------------------------------------------------------

    def connect(self, share: Share) -> str:
        """Link one VERIFIED share. Returns ``accepted`` (linked, possibly
        adopting queued orphans), ``orphan`` (parent unknown — held) or
        ``duplicate``. Never verifies: callers run ``verify_share`` first,
        off the loop."""
        sid = share.share_id
        if sid in self:
            return "duplicate"
        prev = share.prev_hash
        if prev != GENESIS and prev not in self.records:
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
        parent = self.records.get(share.prev_hash)
        if parent is not None:
            height = parent.height + 1
            cumwork = parent.cumwork + share.work
        else:
            height = 0
            cumwork = share.work
        sid = share.share_id
        self.records[sid] = _Rec(share, height, cumwork)
        self.shares_connected += 1
        self._maybe_adopt(sid)

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
            r = self.records.get(h)
            if r is None:
                return  # lineage pruned from under us: cannot adopt
            path.append(h)
            h = r.share.prev_hash
        fork_height = self._pos[h] if h in self._pos else -1
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
        maintaining the window accumulator. Rewound records stay linked
        as a side branch."""
        while self.height > new_height:
            old = self._chain.pop()
            del self._pos[old]
            self._pop_acc(self.records[old].share)

    def _append_best(self, sid: bytes) -> None:
        """Append one linked record to the best chain, maintaining the
        window accumulator."""
        self._pos[sid] = self.height
        self._chain.append(sid)
        self._push_acc(self.records[sid].share)

    # -- PPLNS window accumulator ---------------------------------------------

    def _push_acc(self, share: Share) -> None:
        """Window maintenance for one best-chain append: the new share
        enters; the share falling off the window's far edge leaves."""
        self._acc[share.worker] = (
            self._acc.get(share.worker, 0) + weight_units(share.target))
        lo = self.height - self.params.window
        if lo > 0:
            self._acc_sub(*self._window_entry(lo - 1))

    def _pop_acc(self, share: Share) -> None:
        """Window maintenance for one rewind: the popped share leaves;
        the share that re-enters at the far edge (if the window was
        full) comes back."""
        self._acc_sub(share.worker, weight_units(share.target))
        lo = self.height + 1 - self.params.window
        if lo > 0:
            worker, units = self._window_entry(lo - 1)
            self._acc[worker] = self._acc.get(worker, 0) + units

    def _acc_sub(self, worker: str, units: int) -> None:
        left = self._acc.get(worker, 0) - units
        if left == 0:
            self._acc.pop(worker, None)
        else:
            # a negative residue would be an accounting bug — keep it
            # visible in weights() rather than silently clamping
            self._acc[worker] = left

    def _window_entry(self, height: int) -> tuple[str, int]:
        """(worker, weight units) of the best-chain share at ``height``."""
        share = self.records[self._chain[height]].share
        return share.worker, weight_units(share.target)

    # -- locator sync --------------------------------------------------------

    def locator(self) -> list[str]:
        """Block-locator hashes: dense near the tip, exponentially sparse
        toward genesis, genesis-most element always included."""
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
        ``limit`` shares. Returns ``(shares, more)``."""
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
        records are kept: they serve locator sync from genesis."""
        if self.tip is None:
            return 0
        if len(self.records) == len(self._pos):
            # every linked record is ON the best chain: nothing to scan
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
        """One housekeeping pass: without a chain store, pruning the dead
        side branches is all there is (the reference's compact() with
        ``store=None``)."""
        return self.prune_side_branches()

    def load(self) -> dict:
        """Cold boot from a chain store: there is none in the port yet."""
        raise ValueError("no chain store attached: the durable chain "
                         f"store is not ported yet ({CHAIN_STORE_ITEM})")

    def snapshot(self) -> dict:
        # the reference's keys; the store's (archived height, tail,
        # persistence failures) read as an in-memory chain's
        return {
            "height": self.height,
            "tip": self.tip.hex() if self.tip is not None else "",
            "tip_work": self.tip_work,
            "records": len(self.records),
            "archived_height": 0,
            "tail": self.height,
            "acc_workers": len(self._acc),
            "orphans": len(self.orphans),
            "orphans_adopted": self.orphans_adopted,
            "orphans_evicted": self.orphans_evicted,
            "shares_connected": self.shares_connected,
            "reorgs": self.reorgs,
            "deepest_reorg": self.deepest_reorg,
            "reorgs_refused": self.reorgs_refused,
            "stale_refused": 0,
            "persist_failures": 0,
            "window": self.params.window,
            "min_difficulty": self.params.min_difficulty,
            "algorithm": self.params.algorithm,
        }
