"""Durable share-chain store: WAL segments, settled archive, snapshots
(counterpart of ``otedama_tpu/p2p/chainstore.py``; the on-disk format is
the reference's byte for byte: magic, record types, frame layout, CRC,
segment names and snapshot JSON, so a directory written by either
package loads in the other).

The verified share chain (p2p/sharechain.py) is the substrate for
regions, settlement and cross-region dedup — and until this module it
lived entirely in memory: a pool reboot forfeited the whole PPLNS window
and every region's dedup index. This is the reference's SQLite/Postgres
persistence pillar rebuilt for the chain's actual write
pattern, three layers under one directory:

- **Journal** (``wal-<seq>.seg``): an append-only, CRC-framed log of
  every BEST-CHAIN event — one EXTEND record per best-chain extension
  (the full 80-byte PoW'd header + claim metadata, so the share is
  reconstructible bit-exactly) and one REORG record per rewind. Side
  branches are NOT journaled: on adoption their shares re-enter the log
  as ordinary extensions, so replay is a pure fold over events.

- **Archive** (``arc-<height>.seg``): the settled prefix — positions
  below ``ShareChain.settled_height()`` are immutable by construction
  (deeper forks are refused), so once a share settles its record is
  appended here exactly once, in strict height order, and the in-memory
  chain drops it. Height IS the archive sequence number, which makes
  point reads (window-edge accounting, settlement cursor checks) a
  bisect + seek and range reads (settlement slices, dedup-index
  rebuild, locator service for far-behind peers) a sequential scan.
  This is what bounds memory: a million-share PPLNS window keeps only
  the mutable tail in RAM.

- **Snapshot** (``snapshot.json``, atomic tmp+rename): a checkpoint of
  the chain state AT the archived boundary — settled height, tip id,
  cumulative work, and the exact integer PPLNS window accumulator — so
  a rebooted node restores the prefix in O(1), replays only journal
  events after the snapshot (bounded by the unsnapshotted suffix +
  ``max_reorg_depth``, never chain length), and converges in seconds
  regardless of how long the chain is. A torn or missing snapshot
  degrades to an O(window) archive walk, never to wrong state.

**Pipelined persistence (the commit path pays ~nothing).** Encoding,
CRC and writes synchronously under ``ShareChain.connect``, and
snapshots that rewrite the whole in-memory tail on the event loop,
would tax the hottest write path. The commit path only appends
a compact event tuple to a bounded in-memory ring; a dedicated WRITER
THREAD — the sole owner of the journal/archive file handles — drains
the ring in order, encodes + writes in batches, group-fsyncs (at most
``fsync_interval`` events per fsync), and advances a monotonic
durability watermark (``persisted_seq`` / ``persisted_height``).
Consumers that need durability AWAIT THE WATERMARK instead of the
write: in ``durability: "ack"`` mode the group-commit ledger flush
waits for the watermark to cover its batch before the db transaction
(durable-before-verdict); in ``"async"``
mode (gossip-only / non-ledger nodes) verdicts return immediately and
a crash loses at most the exported ``persist_lag``. Reorg events flow
through the same ring, so ordering is the ring's FIFO; archive flushes
and snapshots are ring jobs too — a snapshot captures a copy-on-write
view of the tail at submit time and the O(tail) rewrite + fsyncs run
entirely on the writer, never stalling a connect.

Crash semantics at each boundary (seeded-testable via the
``chain.persist`` / ``chain.snapshot`` / ``chain.fsync`` fault points):

- killed between the in-memory link and the watermark advance: the
  events past the watermark are lost; boot converges TO the watermark
  and peers heal the tail via ordinary locator sync. In ``ack`` mode
  the ledger never acked a share inside that window (it was still
  waiting on the watermark), so no miner was told "accepted" for work
  the journal lost;
- torn final journal/archive record (kill -9 mid-write): detected by
  CRC, truncated at replay, counted in ``torn_records``;
- writer-thread IO errors (``chain.fsync``): quarantine-loudly — the
  SEQ watermark still advances so ack-mode waiters (and with them the
  commit path) are never wedged behind a dead disk, while the HEIGHT
  watermark (``persisted_height``) is pinned below the hole the loss
  punched until a snapshot boundary covers it — consumers that gate on
  "this position is durable" (the region recommit sweep) never read
  durable across a known hole; the failure is counted
  (``writer_errors``), ``degraded`` raises and the sustained-lag alarm
  fires; the durability statement honestly degrades to "peers hold it";
- torn snapshot: checksum-refused, boot falls back to the previous
  snapshot or the archive walk;
- snapshot ahead of a lost archive write: impossible by ordering — the
  writer refuses to write a snapshot until the archive is durable up to
  the boundary it references.
"""

from __future__ import annotations

import asyncio
import dataclasses
import heapq
import itertools
import json
import logging
import os
import struct
import threading
import time
import zlib
from bisect import bisect_right
from collections import OrderedDict, deque

from otedama_tpu_torch.utils import faults
from otedama_tpu_torch.utils.histogram import LatencyHistogram

log = logging.getLogger("otedama.p2p.chainstore")

SNAPSHOT_VERSION = 1
_MAGIC = 0xC5
REC_EXTEND = 1
REC_REORG = 2

# frame: magic(1) type(1) payload_len(4) | payload | crc32(4, over
# type+len+payload) — the CRC covers the length so a torn length field
# cannot send the reader seeking into garbage that happens to parse
_FRAME = struct.Struct("<BBI")
_CRC = struct.Struct("<I")
_EXTEND_FIX = struct.Struct("<Q32s80sQq")  # height, share_id, header, ts_ms, block#
_REORG = struct.Struct("<Q")               # new best-chain length

# both persistence seams are skippable steps under chaos: error = the
# IO failed loudly (the chain keeps serving, durability degraded and
# counted), drop = the write is silently LOST (the torn-recovery case:
# replay stops at the hole and peer sync covers the rest), crash = the
# chaos harness's registered handler kills the node at this boundary
_PERSIST_FAULTS = faults.STEP
_SNAPSHOT_FAULTS = faults.STEP
# the writer thread's per-fsync-group seam: error = the whole group's
# write/fsync fails loudly (events lost from the journal, watermark
# advances, alarm raised), delay = slow disk (holds the watermark — the
# ack-mode blocking case), crash = die between link and watermark
_FSYNC_FAULTS = faults.POINT

# shares-per-fsync histogram ladder (otedama_chain_fsync_batch_size)
_FSYNC_BATCH_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                       256.0, 512.0, 1024.0, 2048.0, 4096.0)


class ChainStoreError(RuntimeError):
    """A persistence operation failed (IO error, injected fault). The
    in-memory chain is never poisoned by one: callers count and carry on
    with durability degraded-but-visible."""


@dataclasses.dataclass
class ChainStoreConfig:
    path: str = "chainstore"
    # journal/archive segment rotation threshold, bytes
    segment_bytes: int = 8 << 20
    # MOST journal events the writer thread folds into one group-fsync
    # (1 = every event fsynced individually before the watermark covers
    # it). Larger groups amortize the fsync; the watermark — not this
    # knob — is what bounds crash loss in ack mode.
    fsync_interval: int = 64
    # write a snapshot every time the archived boundary advances this
    # many shares (bounds boot replay to ~this + max_reorg_depth
    # events). Snapshots run entirely on the writer thread — the
    # O(tail) rewrite and its fsyncs never touch the event loop.
    snapshot_interval: int = 8192
    # in-memory best-chain tail floor, shares: positions below
    # height - tail_shares (and below the settled horizon) are archived
    # out of RAM. This is what bounds memory under million-share windows.
    tail_shares: int = 16384
    # archived share ids remembered for duplicate detection, so a peer
    # replaying ancient best-chain shares gets "duplicate" (no orphan
    # churn, no gossip re-flood) instead of being mistaken for news —
    # the in-memory records used to provide this from genesis; this
    # bounds it (32 B/id; replays older than the cap die at the flood
    # dedup / verification layers like any other stale gossip)
    dup_cache_shares: int = 65536
    # consumer durability contract (read by the ledger flush through
    # RegionReplicator.wait_durable, NOT by the writer): "ack" = the
    # group-commit ledger awaits the watermark before its db
    # transaction, so no miner is ever told "accepted" for a share the
    # journal could lose; "async" = verdicts return after the in-memory
    # link and a crash loses at most persist_lag (gossip-only /
    # non-ledger nodes)
    durability: str = "ack"
    # bounded event ring between the commit path and the writer thread;
    # when a wedged disk fills it, further events are DROPPED from the
    # journal (counted in ring_dropped, degraded raised) instead of
    # stalling the event loop or growing without bound — the lost tail
    # comes back from peers exactly like any other persist loss
    ring_max: int = 65536


def encode_extend(height: int, share, share_id: bytes, cumwork: int) -> bytes:
    # writer-thread hot path (every best-chain event): one join over
    # length-prefixed pieces, bit-identical to the synchronous layout (stores
    # carry over across versions). Cumulative work is an exact
    # 256-bit-scale integer: variable-length big-endian bytes (the
    # archive's last record is what lets a snapshot-less boot restore
    # tip work in O(1)).
    worker = share.worker.encode()
    job = share.job_id.encode()
    algo = share.algorithm.encode()
    cw = cumwork.to_bytes((cumwork.bit_length() + 7) // 8 or 1, "big")
    return b"".join((
        _EXTEND_FIX.pack(height, share_id, share.header, share.ts_ms,
                         share.block_number),
        len(cw).to_bytes(2, "little"), cw,
        len(algo).to_bytes(1, "little"), algo,
        len(worker).to_bytes(2, "little"), worker,
        len(job).to_bytes(2, "little"), job,
    ))


def decode_extend(payload: bytes):
    """-> (height, share_id, Share, cumwork). Raises on malformed
    payloads (the CRC passed, so malformed means a format bug, not rot)."""
    from otedama_tpu_torch.p2p.sharechain import Share

    height, share_id, header, ts_ms, block_number = _EXTEND_FIX.unpack_from(
        payload, 0)
    off = _EXTEND_FIX.size
    (clen,) = struct.unpack_from("<H", payload, off)
    off += 2
    cumwork = int.from_bytes(payload[off:off + clen], "big")
    off += clen
    (alen,) = struct.unpack_from("<B", payload, off)
    off += 1
    algo = payload[off:off + alen].decode()
    off += alen
    (wlen,) = struct.unpack_from("<H", payload, off)
    off += 2
    worker = payload[off:off + wlen].decode()
    off += wlen
    (jlen,) = struct.unpack_from("<H", payload, off)
    off += 2
    job = payload[off:off + jlen].decode()
    share = Share(header, worker, job, ts_ms, algo, block_number)
    return height, share_id, share, cumwork


def _frame(rtype: int, payload: bytes) -> bytes:
    head = _FRAME.pack(_MAGIC, rtype, len(payload))
    # chained crc32 avoids concatenating head+payload just to hash it
    return b"".join((head, payload,
                     _CRC.pack(zlib.crc32(payload, zlib.crc32(head[1:])))))


class SegmentLog:
    """One directory of append-only, CRC-framed segment files.

    Files are named ``<prefix>-<first_seq:016d>.seg`` so the record a
    sequence number lives in is a filename bisect; rotation happens at
    ``segment_bytes``. Replay tolerates a torn FINAL record (the
    kill -9 tail) by truncating at it; a bad frame anywhere stops the
    iteration there and is counted — the honest move, because nothing
    after an unreadable record can be trusted to be at the right offset.

    Thread-safe: the writer thread appends while the event loop serves
    point/range reads (window edges, settlement slices), so every
    state-mutating or buffer-flushing operation sits under one RLock.
    """

    def __init__(self, dirpath: str, prefix: str, segment_bytes: int):
        self.dir = dirpath
        self.prefix = prefix
        self.segment_bytes = segment_bytes
        os.makedirs(dirpath, exist_ok=True)
        self._lock = threading.RLock()
        self._bases: list[int] = []        # first seq per segment, sorted
        self._counts: dict[int, int] = {}  # base -> records in that segment
        self._fh = None                    # active write handle
        self._active_base = 0
        self._active_bytes = 0
        self.seq = 0                       # next seq to assign
        self.torn_records = 0
        self.appends = 0
        self.fsyncs = 0
        self._pending = 0                  # appends since last fsync
        # lazy per-segment record-offset indexes (point/range reads)
        self._offsets: OrderedDict[int, list[int]] = OrderedDict()
        self._scan_dir()

    # -- layout ---------------------------------------------------------------

    def _path(self, base: int) -> str:
        return os.path.join(self.dir, f"{self.prefix}-{base:016d}.seg")

    def _scan_dir(self) -> None:
        bases = []
        for name in os.listdir(self.dir):
            if name.startswith(self.prefix + "-") and name.endswith(".seg"):
                try:
                    bases.append(int(name[len(self.prefix) + 1:-4]))
                except ValueError:
                    continue
        self._bases = sorted(bases)
        if not self._bases:
            return
        # only the LAST segment needs a scan to learn the total record
        # count (earlier segments' counts are the base deltas) — this is
        # what keeps opening a million-share store off the O(chain) path
        for a, b in zip(self._bases, self._bases[1:]):
            self._counts[a] = b - a
        last = self._bases[-1]
        offsets = self._scan_segment(last, truncate_torn=True)
        self._counts[last] = len(offsets)
        self._offsets[last] = offsets
        self.seq = last + len(offsets)
        self._active_base = last
        self._active_bytes = os.path.getsize(self._path(last))

    def _scan_segment(self, base: int, truncate_torn: bool = False) -> list[int]:
        """Record byte offsets of one segment; optionally truncate a torn
        tail in place (only ever done for the final segment on open)."""
        offsets: list[int] = []
        path = self._path(base)
        good_end = 0
        with open(path, "rb") as f:
            data = f.read()
        pos = 0
        while pos + _FRAME.size <= len(data):
            magic, rtype, plen = _FRAME.unpack_from(data, pos)
            end = pos + _FRAME.size + plen + _CRC.size
            if magic != _MAGIC or end > len(data):
                break
            (crc,) = _CRC.unpack_from(data, end - _CRC.size)
            if zlib.crc32(data[pos + 1:end - _CRC.size]) != crc:
                break
            offsets.append(pos)
            pos = good_end = end
        if good_end < len(data):
            self.torn_records += 1
            log.warning("%s: torn/corrupt record at offset %d of %s "
                        "(truncating=%s)", self.prefix, good_end, path,
                        truncate_torn)
            if truncate_torn:
                with open(path, "r+b") as f:
                    f.truncate(good_end)
        return offsets

    def _offsets_for(self, base: int) -> list[int]:
        with self._lock:
            offsets = self._offsets.get(base)
            if offsets is None:
                offsets = self._scan_segment(base)
                self._offsets[base] = offsets
                while len(self._offsets) > 8:   # a few hot segments is plenty
                    victim = next((b for b in self._offsets
                                   if b != self._active_base), None)
                    if victim is None:
                        break
                    del self._offsets[victim]
            return offsets

    # -- writes ---------------------------------------------------------------

    def append(self, rtype: int, payload: bytes) -> int:
        """Append one record; returns its sequence number. Buffered —
        durability happens at flush()."""
        with self._lock:
            if self._fh is None or self._active_bytes >= self.segment_bytes:
                self._rotate()
            frame = _frame(rtype, payload)
            self._fh.write(frame)
            count = self._counts.get(self._active_base, 0)
            offs = self._offsets.get(self._active_base)
            # only extend an offset index that is COMPLETE for this
            # segment; an evicted-then-partially-rebuilt list would
            # misalign seq→offset
            if offs is not None and len(offs) == count:
                offs.append(self._active_bytes)
            self._active_bytes += len(frame)
            seq = self.seq
            self.seq += 1
            self._counts[self._active_base] = count + 1
            self.appends += 1
            self._pending += 1
            return seq

    def append_frames(self, frames: list[bytes]) -> int:
        """Append a GROUP of pre-built frames with one buffered write;
        returns the first record's sequence number. The writer thread's
        hot path: per-record bookkeeping is a tight loop of int ops and
        the OS sees one write per fsync group instead of one per event.
        The group may overshoot ``segment_bytes`` by one group's worth —
        rotation is a soft threshold, checked before the write."""
        with self._lock:
            first = self.seq
            i = 0
            n = len(frames)
            while i < n:
                if (self._fh is None
                        or self._active_bytes >= self.segment_bytes):
                    self._rotate()
                base = self._active_base
                count = self._counts.get(base, 0)
                offs = self._offsets.get(base)
                track = offs is not None and len(offs) == count
                pos = self._active_bytes
                # take frames until the segment fills (rotation stays
                # record-granular, same as per-record appends)
                j = i
                while j < n and pos < self.segment_bytes:
                    pos += len(frames[j])
                    j += 1
                if track:
                    # one C-level accumulate extends the offset index
                    # for the whole group — not one interpreted append
                    # per record (writer thread holds the GIL O(groups))
                    offs.extend(itertools.accumulate(
                        (len(frames[k]) for k in range(i, j - 1)),
                        initial=self._active_bytes))
                self._fh.write(b"".join(frames[i:j]))
                took = j - i
                self.seq += took
                self._active_bytes = pos
                self._counts[base] = count + took
                self.appends += took
                self._pending += took
                i = j
            return first

    def _rotate(self) -> None:
        # callers hold the lock
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
        self._active_base = self.seq
        # a crash right after a rotation (or a rewrite of an empty tail)
        # leaves an empty segment on disk whose base == seq: reuse it
        # instead of registering a duplicate base
        if not self._bases or self._bases[-1] != self._active_base:
            self._bases.append(self._active_base)
        self._offsets[self._active_base] = []
        self._counts[self._active_base] = 0
        self._active_bytes = 0
        self._fh = open(self._path(self._active_base), "ab")

    def flush(self, fsync: bool = True) -> None:
        with self._lock:
            if self._fh is None:
                return
            self._fh.flush()
            if fsync and self._pending:
                os.fsync(self._fh.fileno())
                self.fsyncs += 1
                self._pending = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self.flush(fsync=True)
                self._fh.close()
                self._fh = None

    def drop_below(self, seq: int) -> int:
        """Delete whole segments every record of which precedes ``seq``
        (journal truncation after a snapshot). Never touches a segment a
        needed record might share."""
        dropped = 0
        with self._lock:
            while len(self._bases) > 1 and self._bases[1] <= seq:
                base = self._bases.pop(0)
                self._counts.pop(base, None)
                self._offsets.pop(base, None)
                try:
                    os.remove(self._path(base))
                    dropped += 1
                except OSError:
                    pass
        return dropped

    # -- reads ----------------------------------------------------------------

    def _read_at(self, base: int, offsets: list[int], idx: int):
        if idx >= len(offsets):
            # the offset scan stopped early at a torn/corrupt record:
            # this seq is unreadable even though the segment exists
            raise ChainStoreError(
                f"record {base}+{idx} unreadable in {self.prefix} "
                f"(segment holds {len(offsets)} good records)")
        with open(self._path(base), "rb") as f:
            return self._read_from(f, base, offsets, idx)

    def _read_from(self, f, base: int, offsets: list[int], idx: int):
        """One record of segment ``base`` from its open file ``f``."""
        f.seek(offsets[idx])
        head = f.read(_FRAME.size)
        magic, rtype, plen = _FRAME.unpack(head)
        payload = f.read(plen)
        (crc,) = _CRC.unpack(f.read(_CRC.size))
        if magic != _MAGIC or zlib.crc32(head[1:] + payload) != crc:
            raise ChainStoreError(
                f"corrupt record {base}+{idx} in {self.prefix}")
        return rtype, payload

    def read(self, seq: int):
        """-> (rtype, payload) of one record by sequence number."""
        with self._lock:
            if not (0 <= seq < self.seq) or not self._bases:
                raise ChainStoreError(f"{self.prefix} seq {seq} out of range")
            if seq < self._bases[0]:
                # dropped by truncation (drop_below): without this guard
                # the bisect would land on the LAST segment and a
                # negative index would silently return some other
                # record's bytes
                raise ChainStoreError(
                    f"{self.prefix} seq {seq} precedes retained segments")
            self.flush(fsync=False)  # point reads must see buffered appends
            i = bisect_right(self._bases, seq) - 1
            base = self._bases[i]
            return self._read_at(base, self._offsets_for(base), seq - base)

    def iter_from(self, seq: int):
        """Yield (seq, rtype, payload) for every record >= seq, in order.
        Stops (without raising) at a torn/corrupt record — everything
        after it is untrusted; the caller heals from peers. Each segment
        is opened once for the scan (the reference opens it once a
        record: a cold boot's replay and archive reads then cost one
        ``open`` a record)."""
        with self._lock:
            self.flush(fsync=False)
            start = max(0, seq)
            i = max(0, bisect_right(self._bases, start) - 1)
            bases = list(self._bases[i:])
        for base in bases:
            offsets = self._offsets_for(base)
            first = max(0, start - base)
            if first >= len(offsets):
                continue
            with open(self._path(base), "rb") as f:
                for idx in range(first, len(offsets)):
                    try:
                        with self._lock:
                            rtype, payload = self._read_from(f, base,
                                                             offsets, idx)
                    except ChainStoreError:
                        return
                    yield base + idx, rtype, payload

    def snapshot(self) -> dict:
        with self._lock:
            bases = list(self._bases)
            seq, appends, fsyncs = self.seq, self.appends, self.fsyncs
            pending, torn = self._pending, self.torn_records
        total = sum(
            os.path.getsize(self._path(b))
            for b in bases if os.path.exists(self._path(b))
        )
        return {
            "segments": len(bases),
            "bytes": total,
            "records": seq - (bases[0] if bases else 0),
            "appends": appends,
            "fsyncs": fsyncs,
            "pending_fsync": pending,
            "torn_records": torn,
        }


class ChainStore:
    """The facade ``ShareChain`` persists through: journal + archive +
    snapshot under one directory, behind a PIPELINED writer thread.

    The commit path calls ``append_extend``/``append_reorg``/
    ``stage_archive``/``submit_snapshot`` — all of which only enqueue a
    compact job onto the bounded event ring and return (µs). The writer
    thread — sole owner of the file handles for WRITES — drains the
    ring strictly in order: journal events are encoded + written and
    group-fsynced (at most ``fsync_interval`` per fsync), then the
    durability watermark advances and watermark waiters
    (``wait_seq``) are released. Archive drains and snapshots ride the
    same ring, so "everything before the snapshot is on disk before the
    snapshot exists" is the ring's FIFO, not a cross-thread dance.

    Reads (point/range, for window edges and settlement slices) stay on
    the caller's thread: staged-but-unwritten archive records are
    served from the in-memory overlay (``pending_archive``), durable
    ones from the segment logs, which are internally locked against the
    writer.
    """

    def __init__(self, config: ChainStoreConfig | None = None):
        self.config = config or ChainStoreConfig()
        os.makedirs(self.config.path, exist_ok=True)
        self.journal = SegmentLog(
            self.config.path, "wal", self.config.segment_bytes)
        self.archive = SegmentLog(
            self.config.path, "arc", self.config.segment_bytes)
        self.stats = {
            "persist_failures": 0,
            "snapshot_failures": 0,
            "snapshots_written": 0,
            "replayed_records": 0,
            "replay_seconds": 0.0,
            "writer_errors": 0,
            "ring_dropped": 0,
        }
        self.snapshot_height = -1          # height of the last good snapshot
        self.snapshot_time = 0.0
        self.fsynced_seq = self.journal.seq  # journal seq covered by fsync
        # -- writer thread / watermark state ----------------------------------
        self._ring: deque = deque()
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stop = False
        self._sleeping = False          # writer parked on the cv (wake it)
        self.submitted_seq = 0          # journal events ever enqueued
        self.persisted_seq = 0          # journal events the writer finished
        # height watermark state: _fsynced_hmax is the max EXTEND height
        # of SUCCESSFULLY fsynced groups; _hole is the lowest height a
        # LOUD loss (failed group write/fsync, ring drop) punched into
        # the journal and no snapshot has covered yet — the exported
        # persisted_height is capped below it, so the recommit sweep
        # never trusts "durable" across a known hole. (chain.persist
        # DROP faults model silent loss and are invisible here by
        # definition — nothing can gate on what it cannot see.)
        self._fsynced_hmax = -1
        self._holes: list[int] = []     # min-heap of uncovered holes
        self.ring_peak = 0
        self._journal_ok = True         # last journal group landed
        self._archive_ok = True         # archive overlay fully drained
        self.lag_alarm = False          # sustained persist lag (see _alarm)
        self._lag_high_since = 0.0
        self._waiters: list = []        # heap of (seq, n, loop, future)
        self._wcount = itertools.count()
        self._snapshot_inflight = False
        self.fsync_batch = LatencyHistogram(bounds=_FSYNC_BATCH_BOUNDS)
        # height -> journal seq of that position's latest EXTEND record:
        # lets a snapshot name its replay boundary WITHOUT rewriting the
        # tail (an O(tail) synchronous cost) — replay
        # simply starts at the boundary position's own journal record.
        # Writer-thread only; pruned below the boundary at snapshot.
        self._height_seq: dict[int, int] = {}
        # height -> (share_id, frame): the journal frame of a recently
        # journaled extend. An archive record for the same height is
        # BYTE-IDENTICAL (same record type, payload, CRC), so archiving
        # a settled share is one buffered write of cached bytes instead
        # of a second encode. Writer-thread only, FIFO-capped.
        self._frame_cache: dict[int, tuple] = {}
        self._cache_cap = max(8192, 2 * self.config.tail_shares)
        # staged-not-yet-durable archive records: height -> (share_id,
        # Share, cumwork). Contiguous above ``archived_height``; the
        # writer drains it bottom-up. Reads overlay it over the log.
        self._arch_lock = threading.Lock()
        self.pending_archive: OrderedDict[int, tuple] = OrderedDict()
        # archive sequence == settled height by construction; cross-check
        # the invariant at open (one point read of the newest record) so
        # a mixed-up directory — segments copied in from another store —
        # fails loudly here, not as confusing replay skips later
        self.archived_height = self.archive.seq
        if self.archived_height > 0:
            rtype, payload = self.archive.read(self.archived_height - 1)
            h, _sid, _share, _cw = decode_extend(payload)
            if rtype != REC_EXTEND or h != self.archived_height - 1:
                raise ChainStoreError(
                    f"archive end claims height {h}, expected "
                    f"{self.archived_height - 1} — mixed-up chain_dir?")

    # -- ring / writer thread -------------------------------------------------

    def _submit(self, job: tuple, journal_event: bool) -> int:
        """Enqueue one writer job; returns the watermark barrier seq
        (the seq a waiter must see persisted for everything enqueued so
        far — including this event — to be durable)."""
        # LOCK-FREE fast path: the commit side is single-threaded (the
        # event loop), the deque append is GIL-atomic, and the writer
        # only needs the condition variable when it is actually parked —
        # a per-event lock acquisition here was measurable in the chain bench
        # connect rates
        if self._stop:
            raise ChainStoreError("chain store is closed")
        if journal_event:
            if len(self._ring) >= self.config.ring_max:
                # wedged disk: drop from the JOURNAL only (the in-memory
                # chain still holds the share; peers restore the journal
                # hole) — never stall the event loop behind dead media.
                # The drop is LOUD: counted, and the height watermark is
                # pinned below the hole it punches (extend height /
                # reorg rewind target both sit at job[1])
                self.stats["ring_dropped"] += 1
                self._note_hole(job[1])
                return self.submitted_seq
            self.submitted_seq += 1
        self._ring.append(job)
        depth = len(self._ring)
        if depth > self.ring_peak:
            self.ring_peak = depth
        if self._thread is None:
            with self._cv:
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._writer_loop, name="chain-writer",
                        daemon=True)
                    self._thread.start()
        elif self._sleeping:
            with self._cv:
                self._cv.notify_all()
        return self.submitted_seq

    def _writer_loop(self) -> None:
        ring = self._ring
        while True:
            if not ring:
                with self._cv:
                    if not ring:
                        if self._stop:
                            return
                        # parked-flag handshake with the lock-free
                        # submit path: publish the flag, RE-CHECK the
                        # ring, then wait — a submit that missed the
                        # flag must have appended before the re-check
                        self._sleeping = True
                        if not ring:
                            self._cv.wait(0.5)
                        self._sleeping = False
                continue
            batch: list[tuple] = []
            cap = max(1, self.config.fsync_interval)
            while ring and len(batch) < cap:
                if ring[0][0] not in ("extend", "reorg") and batch:
                    break  # barrier: fsync the journal group first
                batch.append(ring.popleft())
                if batch[-1][0] not in ("extend", "reorg"):
                    break
            try:
                self._process(batch)
            except Exception:
                # last-resort guard: one bad batch must never kill the
                # writer (a dead writer wedges nothing — the ring would
                # just fill and alarm — but it loses all durability)
                self.stats["writer_errors"] += 1
                self._journal_ok = False
                self._note_lost(batch)
                log.exception("chain writer batch failed "
                              "(durability degraded)")
                self._advance(batch)
            self._alarm()

    def _process(self, batch: list[tuple]) -> None:
        kind = batch[0][0]
        if kind in ("extend", "reorg"):
            self._write_events(batch)
        elif kind == "archive":
            self._drain_archive()
        elif kind == "snapshot":
            _k, state, tail, box = batch[0]
            try:
                box["ok"] = self._do_snapshot(state, tail)
            finally:
                self._snapshot_inflight = False
                box["done"].set()
        elif kind == "flush":
            self._drain_archive()
            try:
                self.journal.flush(fsync=True)
                self.fsynced_seq = self.journal.seq
                self._journal_ok = True
            except OSError:
                self.stats["writer_errors"] += 1
                self._journal_ok = False
            batch[0][1].set()
        self._advance(batch)

    def _event_frame(self, job: tuple) -> bytes:
        if job[0] == "extend":
            _k, height, share, sid, cumwork = job
            return _frame(REC_EXTEND, encode_extend(height, share, sid,
                                                    cumwork))
        return _frame(REC_REORG, _REORG.pack(job[1]))

    def _event_frames(self, events: list[tuple]) -> list[bytes]:
        """Frame a drained group: payload serialization (encode_extend)
        and the magic/type/len/crc32 framing, both in Python. The
        reference frames a group above its crossover in one compiled
        call whose bytes equal ``_frame``'s; the port frames every group
        as the reference does below that crossover."""
        types: list[int] = []
        payloads: list[bytes] = []
        for job in events:
            if job[0] == "extend":
                types.append(REC_EXTEND)
                payloads.append(encode_extend(job[1], job[2], job[3],
                                              job[4]))
            else:
                types.append(REC_REORG)
                payloads.append(_REORG.pack(job[1]))
        return [_frame(t, p) for t, p in zip(types, payloads)]

    def _write_events(self, batch: list[tuple]) -> None:
        """One journal group: encode every event, ONE buffered write,
        ONE fsync. ``chain.fsync`` is the writer thread's own seam (per
        group); ``chain.persist`` keeps firing per event so seeded
        chaos schedules replay unchanged (an event it errors or
        drops is excluded from the group — the same journal hole the
        synchronous path left)."""
        lost = False
        try:
            d = faults.hit("chain.fsync", None, _FSYNC_FAULTS)
        except Exception:
            self.stats["writer_errors"] += 1
            lost = True
            d = None
        if d is not None and d.delay:
            self._interruptible_sleep(d.delay)
        if lost:
            # the whole group is loudly lost: hole + degraded, and the
            # height watermark must NOT claim these positions durable
            self._journal_ok = False
            self._note_lost(batch)
        else:
            events = batch
            if faults.get() is not None:     # per-event seam, chaos only
                events = []
                for job in batch:
                    try:
                        d2 = faults.hit("chain.persist", "journal",
                                        _PERSIST_FAULTS)
                    except Exception as e:
                        self.stats["persist_failures"] += 1
                        # a loud per-event loss pins the watermark too
                        self._note_hole(job[1])
                        log.warning("chain journal persistence failed "
                                    "(continuing in-memory): %s", e)
                        continue
                    if d2 is not None:
                        if d2.delay:
                            d2.sleep_sync()
                        if d2.drop:
                            continue  # silently LOST (torn-recovery case)
                    events.append(job)
            written = False
            if events:
                try:
                    frames = self._event_frames(events)
                    first = self.journal.append_frames(frames)
                    written = True
                    cache = self._frame_cache
                    hseq = self._height_seq
                    # once-per-drain-group bookkeeping: two bulk
                    # dict.updates replace the per-event store loop, so
                    # the snapshot frame cache and height->seq map cost
                    # the writer thread GIL O(groups) not O(events)
                    # (a measurable slice of the writer's time)
                    hseq.update(
                        (job[1], first + i)
                        for i, job in enumerate(events)
                        if job[0] == "extend")
                    cache.update(
                        (job[1], (job[3], frames[i]))
                        for i, job in enumerate(events)
                        if job[0] == "extend")
                    while len(cache) > self._cache_cap:
                        del cache[next(iter(cache))]
                    if len(hseq) > 4 * self._cache_cap:
                        # a stretch without landed snapshots (they prune
                        # on success) must not grow the map with chain
                        # length: positions below the durable archive
                        # can never be a future snapshot boundary
                        ah = self.archived_height
                        self._height_seq = {
                            h: s for h, s in hseq.items() if h >= ah}
                except OSError as e:
                    self.stats["persist_failures"] += len(events)
                    self._journal_ok = False
                    self._note_lost(events)
                    log.warning("chain journal write failed "
                                "(continuing in-memory): %s", e)
            try:
                self.journal.flush(fsync=True)
                self.fsynced_seq = self.journal.seq
                if written:
                    self._note_fsynced(events)
                self._journal_ok = True
            except OSError as e:
                self.stats["writer_errors"] += 1
                self._journal_ok = False
                if written:
                    # written but durability unknown: treat as lost
                    self._note_lost(events)
                log.error("chain journal fsync failed "
                          "(durability degraded): %s", e)
        self.fsync_batch.observe(float(len(batch)))

    def _note_hole(self, height: int) -> None:
        """A LOUD journal loss at ``height`` (extend position or reorg
        rewind target): pin the height watermark below it until a
        snapshot whose boundary passes it lands — once the position is
        inside a durable snapshot+archive, the journal hole is no
        longer load-relevant and that pin lifts (holes are a heap: a
        snapshot covering the lowest must not unpin ones above it).
        Locked: ring-full drops note holes from the commit thread while
        the writer notes/clears its own."""
        with self._cv:
            heapq.heappush(self._holes, height)

    def _note_lost(self, jobs: list[tuple]) -> None:
        heights = [j[1] for j in jobs if j[0] in ("extend", "reorg")]
        if heights:
            self._note_hole(min(heights))

    def _note_fsynced(self, jobs: list[tuple]) -> None:
        # one C max per drain group, one attribute store
        mx = max((job[1] for job in jobs if job[0] == "extend"),
                 default=-1)
        if mx > self._fsynced_hmax:
            self._fsynced_hmax = mx

    @property
    def persisted_height(self) -> int:
        """The height watermark: positions <= this are DURABLE — fsynced
        in the journal, or inside the snapshot+archive a boot would
        restore from. Capped below any loudly-lost position
        (``_note_hole``), so consumers like the region recommit sweep
        never read "durable" across a known hole."""
        if self._holes:
            return min(self._fsynced_hmax, self._holes[0] - 1)
        return self._fsynced_hmax

    @property
    def degraded(self) -> bool:
        """True while ANY durability path is behind: the last journal
        group failed, the archive overlay cannot drain, or a loud
        journal hole awaits a covering snapshot. Computed, not a
        latched flag — one healthy fsync must not mask an ongoing
        archive failure (or vice versa)."""
        return (not self._journal_ok or not self._archive_ok
                or bool(self._holes))

    def _advance(self, batch: list[tuple]) -> None:
        """Move the seq watermark past a processed batch and release due
        waiters. The SEQ watermark advances even for events an IO
        failure lost — quarantine-loudly (counted + alarmed), never
        wedge the commit path behind dead media; the HEIGHT watermark
        (`persisted_height`) only advances over durable positions."""
        # batches are homogeneous by construction (_writer_loop breaks
        # on the first non-journal job), so this is O(1) not O(events);
        # close() may hand over an empty leftovers list
        n = len(batch) if batch and batch[0][0] in ("extend", "reorg") else 0
        due: list = []
        with self._cv:
            self.persisted_seq += n
            while self._waiters and self._waiters[0][0] <= self.persisted_seq:
                due.append(heapq.heappop(self._waiters))
            self._cv.notify_all()
        for _seq, _n, loop, fut in due:
            try:
                loop.call_soon_threadsafe(self._resolve_waiter, fut)
            except RuntimeError:
                pass  # loop closed mid-shutdown: nothing left to wake

    @staticmethod
    def _resolve_waiter(fut) -> None:
        if not fut.done():
            fut.set_result(None)

    def _interruptible_sleep(self, seconds: float) -> None:
        """Injected slow-disk delay on the writer thread — sliced so
        ``close()`` never waits out a long chaos stall."""
        end = time.monotonic() + seconds
        while not self._stop:
            left = end - time.monotonic()
            if left <= 0:
                return
            time.sleep(min(0.05, left))

    def _alarm(self) -> None:
        """Sustained-lag alarm: the persist lag staying above the
        threshold for 5 s means the writer is not keeping up (wedged
        disk, chaos stall) — raised once, exported as a gauge, cleared
        when the lag drains."""
        lag = self.persist_lag
        threshold = max(1024, 8 * self.config.fsync_interval)
        now = time.monotonic()
        if lag > threshold:
            if not self._lag_high_since:
                self._lag_high_since = now
            elif now - self._lag_high_since >= 5.0 and not self.lag_alarm:
                self.lag_alarm = True
                log.error("chain persist lag %d sustained above %d — the "
                          "journal writer is not keeping up; a crash now "
                          "loses that many best-chain events", lag, threshold)
        else:
            self._lag_high_since = 0.0
            self.lag_alarm = False

    # -- watermark ------------------------------------------------------------

    @property
    def persist_lag(self) -> int:
        """Best-chain events linked in memory but not yet covered by the
        durability watermark — the shares a kill -9 right now would lose
        (peers would restore them)."""
        return self.submitted_seq - self.persisted_seq

    def barrier_seq(self) -> int:
        """The watermark value that covers everything enqueued so far."""
        return self.submitted_seq

    async def wait_seq(self, seq: int) -> None:
        """Await the durability watermark reaching ``seq`` (event-loop
        side of the ack-mode contract). Returns immediately when already
        covered; never raises on writer IO failures — those advance the
        watermark degraded-but-visible (``writer_errors``/alarm)."""
        if self.persisted_seq >= seq:
            return
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        with self._cv:
            if self.persisted_seq >= seq:
                return
            heapq.heappush(self._waiters,
                           (seq, next(self._wcount), loop, fut))
        await fut

    def wait_seq_sync(self, seq: int, timeout: float = 60.0) -> bool:
        """Thread-blocking watermark wait (benches, tests — never the
        event loop). True when the watermark covered ``seq`` in time."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self.persisted_seq < seq:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(min(0.1, left))
        return True

    def drain(self, timeout: float = 60.0) -> bool:
        """Flush barrier: enqueue a flush job and block until the writer
        has processed everything before it (journal fsynced, archive
        overlay drained). Thread-blocking — benches/tests/shutdown."""
        ev = threading.Event()
        try:
            self._submit(("flush", ev), journal_event=False)
        except ChainStoreError:
            return True  # already closed: close() drained
        return ev.wait(timeout)

    def flush(self) -> None:
        """Synchronous durability point (legacy spelling of drain)."""
        self.drain()

    def can_bound(self, height: int) -> bool:
        """True when the height->journal-seq map can name a snapshot
        replay boundary for ``height`` — the chain then skips capturing
        a copy-on-write tail entirely (read-only GIL-safe lookup; the
        map only grows until a LANDED snapshot prunes below its own
        boundary, which is <= any future boundary)."""
        return height in self._height_seq

    def note_boot(self, height: int) -> None:
        """Seed the watermark after ``ShareChain.load()``: everything
        restored from disk is durable by definition."""
        with self._cv:
            if height - 1 > self._fsynced_hmax:
                self._fsynced_hmax = height - 1

    # -- journal --------------------------------------------------------------

    def append_extend(self, height: int, share, share_id: bytes,
                      cumwork: int) -> int:
        """Enqueue one best-chain extension; returns the barrier seq."""
        return self._submit(("extend", height, share, share_id, cumwork),
                            journal_event=True)

    def append_reorg(self, new_height: int) -> int:
        return self._submit(("reorg", new_height), journal_event=True)

    def _append(self, rtype: int, payload: bytes) -> None:
        # writer thread only. chain.persist fires per event, exactly as
        # it did when the commit path wrote synchronously — seeded chaos
        # schedules see the same per-event hit sequence.
        d = faults.hit("chain.persist", "journal", _PERSIST_FAULTS)
        if d is not None:
            if d.delay:
                d.sleep_sync()
            if d.drop:
                return  # the write is silently LOST (torn-recovery case)
        try:
            self.journal.append(rtype, payload)
        except OSError as e:
            raise ChainStoreError(f"journal append failed: {e}") from e

    def iter_journal(self, after_seq: int):
        """Yield (seq, rtype, payload) for journal records with
        seq > after_seq; stops at the first torn/corrupt record."""
        return self.journal.iter_from(after_seq + 1)

    # -- archive --------------------------------------------------------------

    @property
    def staged_height(self) -> int:
        """The LOGICAL archive boundary: durable records + the staged
        overlay. This is what ``ShareChain._base`` equals after a
        compact — reads below it are always servable."""
        with self._arch_lock:
            return self.archived_height + len(self.pending_archive)

    def stage_archive(self, records: list[tuple]) -> None:
        """Hand settled best-chain records to the writer: ``records`` =
        contiguous ``(height, share_id, Share, cumwork)`` starting at
        the logical boundary. The in-memory transition is immediate (the
        chain drops its copies; reads fall through to the overlay); the
        disk appends happen on the writer thread, which retries the
        overlay bottom-up until durable."""
        with self._arch_lock:
            staged = len(self.pending_archive)
            if staged + len(records) > self.config.ring_max:
                # wedged archive: refusing keeps the records in the
                # CHAIN's tail (visible as tail growth + persist
                # failures) instead of accumulating a second unbounded
                # copy here — the same bounded-backlog policy as the
                # event ring
                raise ChainStoreError(
                    f"archive backlog at {staged} staged records "
                    "(writer cannot drain — wedged archive?)")
            expect = self.archived_height + staged
            for height, sid, share, cumwork in records:
                if height < expect:
                    continue  # already staged/durable (reboot overlap)
                if height != expect:
                    raise ChainStoreError(
                        f"archive must grow in height order: expected "
                        f"{expect}, got {height}")
                self.pending_archive[height] = (sid, share, cumwork)
                expect += 1
        self._submit(("archive",), journal_event=False)

    def _drain_archive(self) -> bool:
        """Writer thread: append staged records bottom-up in groups —
        one buffered write per pass, each record's bytes reused from the
        journal frame cache when possible (they are BYTE-IDENTICAL). A
        failure leaves the remainder staged (retried by the next
        archive/flush/snapshot job). True when the overlay drained."""
        chaos = faults.get() is not None
        while True:
            with self._arch_lock:
                h0 = self.archived_height
                entries = []
                h = h0
                while len(entries) < 1024:
                    entry = self.pending_archive.get(h)
                    if entry is None:
                        break
                    entries.append(entry)
                    h += 1
            if not entries:
                self._archive_ok = True
                return True
            frames: list[bytes] = []
            misses: list[tuple] = []  # (slot, height, share, sid, cumwork)
            failed = False
            for i, (sid, share, cumwork) in enumerate(entries):
                if chaos:
                    try:
                        d = faults.hit("chain.persist", "archive",
                                       _PERSIST_FAULTS)
                    except Exception as e:
                        self.stats["persist_failures"] += 1
                        self._archive_ok = False
                        log.warning("chain archive persistence failed "
                                    "(records stay staged): %s", e)
                        failed = True
                        break
                    if d is not None:
                        if d.delay:
                            d.sleep_sync()
                        if d.drop:
                            # the injected write loss: stop HERE — the
                            # archive grows in strict height order, so
                            # nothing after the refused record can land
                            self.stats["persist_failures"] += 1
                            self._archive_ok = False
                            failed = True
                            break
                cached = self._frame_cache.pop(h0 + i, None)
                if cached is not None and cached[0] == sid:
                    frames.append(cached[1])
                else:
                    frames.append(b"")  # patched from the miss batch below
                    misses.append((len(frames) - 1, h0 + i, share, sid,
                                   cumwork))
            if misses:
                # cache misses re-encode and frame here
                built = [_frame(REC_EXTEND, encode_extend(h, s, sid_, cw))
                         for _, h, s, sid_, cw in misses]
                for (slot, *_rest), fr in zip(misses, built):
                    frames[slot] = fr
            if frames:
                try:
                    self.archive.append_frames(frames)
                except OSError as e:
                    self.stats["persist_failures"] += 1
                    self._archive_ok = False
                    log.warning("chain archive write failed (records "
                                "stay staged in memory): %s", e)
                    return False
                with self._arch_lock:
                    for i in range(len(frames)):
                        self.pending_archive.pop(h0 + i, None)
                    self.archived_height = h0 + len(frames)
            if failed:
                return False

    def read_record(self, height: int):
        """-> (share_id, Share, cumwork) of the archived best-chain share
        at an absolute position below the logical boundary — from the
        staged overlay when the writer has not landed it yet, else from
        the segment log."""
        with self._arch_lock:
            entry = self.pending_archive.get(height)
        if entry is not None:
            return entry
        rtype, payload = self.archive.read(height)
        if rtype != REC_EXTEND:
            raise ChainStoreError(f"archive record {height} is not EXTEND")
        h, share_id, share, cumwork = decode_extend(payload)
        if h != height:
            raise ChainStoreError(
                f"archive record at {height} claims height {h}")
        return share_id, share, cumwork

    def read_share_id(self, height: int) -> bytes:
        return self.read_record(height)[0]

    def read_share(self, height: int):
        return self.read_record(height)[1]

    def read_range(self, start: int, end: int):
        """Yield (height, share_id, Share) for archived positions
        [start, end), sequentially — durable records streamed from the
        log, staged ones from the overlay. Raises ``ChainStoreError`` if
        the range cannot be served CONTIGUOUSLY (a torn/corrupt record
        mid-archive): a silent hole here would let a settlement slice
        drop shares from a payout without anyone noticing — better to
        fail the consumer loudly."""
        end = min(end, self.staged_height)
        if start >= end:
            return
        expect = start
        durable = self.archived_height   # may advance under us: fine —
        stop = min(end, durable)         # the overlay/point path covers it
        if expect < stop:
            for seq, rtype, payload in self.archive.iter_from(expect):
                if seq >= stop:
                    break
                if rtype != REC_EXTEND or seq != expect:
                    raise ChainStoreError(
                        f"archive discontinuity at {seq} (expected {expect})")
                height, share_id, share, _cumwork = decode_extend(payload)
                yield height, share_id, share
                expect = seq + 1
            if expect < stop:
                raise ChainStoreError(
                    f"archive truncated at {expect} "
                    f"(wanted [{start}, {end})) — restore from a peer")
        while expect < end:
            sid, share, _cw = self.read_record(expect)
            yield expect, sid, share
            expect += 1

    def journal_rewrite_tail(self, tail) -> None:
        """Rewrite the in-memory tail as fresh journal records in a NEW
        segment (``tail`` = iterable of (height, share, share_id,
        cumwork)). Writer thread only, right before a snapshot:
        everything at or below the snapshot's ``journal_seq`` boundary
        becomes droppable, and replay = snapshot + this suffix. Raises
        on failure — the caller aborts the snapshot and the previous one
        stays in force."""
        with self.journal._lock:
            self.journal.flush(fsync=True)
            self.journal._rotate()
            for height, share, share_id, cumwork in tail:
                self.journal.append(
                    REC_EXTEND, encode_extend(height, share, share_id,
                                              cumwork))
            self.journal.flush(fsync=True)
        self.fsynced_seq = self.journal.seq

    # -- snapshots ------------------------------------------------------------

    def _snapshot_path(self) -> str:
        return os.path.join(self.config.path, "snapshot.json")

    def submit_snapshot(self, state: dict, tail: list) -> dict | None:
        """Enqueue a snapshot job (state + copy-on-write tail view,
        both captured by the caller at submit time — the chain mutating
        afterwards cannot skew them, and the ring's FIFO IS the
        ordering barrier against every prior event). Returns a box
        whose ``done`` event fires with ``ok`` set, or None when a
        snapshot is already in flight."""
        if self._snapshot_inflight:
            return None
        self._snapshot_inflight = True
        box = {"done": threading.Event(), "ok": False}
        try:
            self._submit(("snapshot", state, tail, box), journal_event=False)
        except ChainStoreError:
            self._snapshot_inflight = False
            return None
        return box

    def _do_snapshot(self, state: dict, tail: list) -> bool:
        """Writer thread: land one checkpoint. Ordering: the archive
        must be durable up to the boundary the snapshot references
        BEFORE the snapshot exists — a snapshot pointing at archive
        state a crash could lose would restore wrong state.

        The replay boundary comes from the height->journal-seq map when
        it can: replay then starts at the boundary position's OWN
        journal record and folds forward, so a full snapshot's
        O(tail) tail rewrite (+ its two fsyncs) disappears from the
        steady state entirely. Heights the map cannot vouch for (events
        journaled before this boot, or lost to an injected drop) fall
        back to the rewrite."""
        self._drain_archive()
        boundary_height = int(state.get("height", 0))
        if self.archived_height < boundary_height:
            self.stats["snapshot_failures"] += 1
            log.warning("snapshot refused: archive durable only to %d, "
                        "boundary needs %d (previous snapshot stays)",
                        self.archived_height, boundary_height)
            return False
        if tail is None:
            # the caller verified can_bound(): the tail's first record
            # (absolute position == boundary_height) was journaled at
            # this seq; every later tail record was journaled after it
            # (re-extends append in order), so replay from there
            # reconstructs the tail with no rewrite at all
            seq = self._height_seq.get(boundary_height)
            if seq is None:
                self.stats["snapshot_failures"] += 1
                log.warning("snapshot refused: no journal boundary for "
                            "height %d (previous snapshot stays)",
                            boundary_height)
                return False
            boundary = seq - 1
        elif not tail:
            boundary = self.journal.seq - 1
        else:
            boundary = self.journal.seq - 1
            try:
                self.journal_rewrite_tail(tail)
            except Exception as e:
                self.stats["snapshot_failures"] += 1
                log.warning("snapshot tail rewrite failed (previous "
                            "snapshot stays): %s", e)
                return False
        state["journal_seq"] = boundary
        ok = self.write_snapshot(state)
        if ok:
            # prune the boundary map below the checkpoint: those
            # positions can never be a future snapshot's boundary
            for h in [h for h in self._height_seq if h < boundary_height]:
                del self._height_seq[h]
            # a journal hole BELOW the landed boundary is no longer
            # load-relevant (boot restores from snapshot+archive past
            # it): lift the height-watermark pin and credit the durable
            # prefix
            with self._cv:
                while self._holes and self._holes[0] < boundary_height:
                    heapq.heappop(self._holes)
            if boundary_height - 1 > self._fsynced_hmax:
                self._fsynced_hmax = boundary_height - 1
        return ok

    def write_snapshot(self, state: dict) -> bool:
        """Atomically persist a chain checkpoint; returns False when the
        write was refused/lost (injected or real — the previous snapshot
        stays in force, boot just replays more journal)."""
        try:
            d = faults.hit("chain.snapshot", None, _SNAPSHOT_FAULTS)
        except faults.FaultInjectedError:
            self.stats["snapshot_failures"] += 1
            return False
        if d is not None:
            if d.delay:
                d.sleep_sync()
            if d.drop:
                self.stats["snapshot_failures"] += 1
                return False
        # the snapshot references archived heights: the archive (and the
        # journal truncation point) must be durable BEFORE the snapshot
        # that points at them exists
        try:
            self.archive.flush(fsync=True)
            self.journal.flush(fsync=True)
            body = json.dumps(state, sort_keys=True)
            doc = {"version": SNAPSHOT_VERSION, "state": state,
                   "crc": zlib.crc32(body.encode())}
            tmp = self._snapshot_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._snapshot_path())
        except OSError as e:
            self.stats["snapshot_failures"] += 1
            log.warning("snapshot write failed (previous stays): %s", e)
            return False
        self.snapshot_height = int(state.get("height", -1))
        self.snapshot_time = time.time()
        self.stats["snapshots_written"] += 1
        self.journal.drop_below(int(state.get("journal_seq", -1)) + 1)
        return True

    def read_snapshot(self) -> dict | None:
        """The last good snapshot state, or None (absent OR torn — a
        checksum-refused snapshot degrades to the archive walk, it never
        restores wrong state)."""
        try:
            with open(self._snapshot_path()) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        state = doc.get("state")
        if not isinstance(state, dict) or doc.get("version") != SNAPSHOT_VERSION:
            return None
        body = json.dumps(state, sort_keys=True)
        if zlib.crc32(body.encode()) != doc.get("crc"):
            log.warning("snapshot checksum mismatch — ignoring torn snapshot")
            return None
        self.snapshot_height = int(state.get("height", -1))
        try:
            self.snapshot_time = os.path.getmtime(self._snapshot_path())
        except OSError:
            self.snapshot_time = time.time()
        return state

    # -- lifecycle / reporting ------------------------------------------------

    def close(self) -> None:
        """Drain the ring (journal fsynced, archive landed, queued
        snapshot written), stop the writer, close the handles. A hard
        kill skipping this is exactly the crash ``load()`` replays."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                log.error("chain writer did not drain within 60s at close")
            self._thread = None
        # a never-started writer (or a timed-out drain) may leave staged
        # work: make one synchronous best-effort pass so a clean stop is
        # a clean image
        leftovers: list[tuple] = []
        with self._cv:
            leftovers = list(self._ring)
            self._ring.clear()
        for job in leftovers:
            try:
                if job[0] == "extend":
                    _k, height, share, sid, cumwork = job
                    self._append(REC_EXTEND,
                                 encode_extend(height, share, sid, cumwork))
                elif job[0] == "reorg":
                    self._append(REC_REORG, _REORG.pack(job[1]))
                elif job[0] == "flush":
                    job[1].set()
                elif job[0] == "snapshot":
                    job[3]["done"].set()
            except Exception:
                self.stats["persist_failures"] += 1
        # leftovers may be heterogeneous (unlike writer-loop batches):
        # advance the seq watermark over the event-bearing jobs only
        self._advance([j for j in leftovers if j[0] in ("extend", "reorg")])
        self._drain_archive()
        try:
            self.journal.flush(fsync=True)
        except OSError:
            pass
        self.journal.close()
        self.archive.close()

    def snapshot(self) -> dict:
        with self._arch_lock:
            staged = len(self.pending_archive)
        return {
            "path": self.config.path,
            "durability": self.config.durability,
            "archived_height": self.archived_height,
            "staged_archive": staged,
            "persist_lag": self.persist_lag,
            "submitted_seq": self.submitted_seq,
            "persisted_seq": self.persisted_seq,
            "persisted_height": self.persisted_height,
            "ring_depth": len(self._ring),
            "ring_peak": self.ring_peak,
            "degraded": self.degraded,
            "lag_alarm": self.lag_alarm,
            "fsync_batch": self.fsync_batch.state(),
            "snapshot_height": self.snapshot_height,
            "snapshot_age_seconds": (
                round(time.time() - self.snapshot_time, 1)
                if self.snapshot_time else -1.0),
            "journal": self.journal.snapshot(),
            "archive": self.archive.snapshot(),
            **self.stats,
        }
