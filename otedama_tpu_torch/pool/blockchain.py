"""Block templates, the chain-client protocol, the in-process mock chain
and the JSON-RPC client of a bitcoind-compatible node (counterpart of
``otedama_tpu/pool/blockchain.py`` ``BlockTemplate``, ``SubmitOutcome``,
``BlockchainClient``, ``MockChainClient`` and ``BitcoinRPCClient``,
without the reference's ``chain.rpc`` fault-injection gates).

The mock is a regtest-style chain: it hands out templates, verifies
submitted headers against its own nbits, and advances height.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import logging
import struct
import time
from typing import Protocol
from urllib.parse import urlparse

from otedama_tpu_torch.kernels import target as tgt
from otedama_tpu_torch.utils.netpool import HttpConnectionPool
from otedama_tpu_torch.utils.sha256_host import sha256d

log = logging.getLogger("otedama.pool.chain")


@dataclasses.dataclass
class BlockTemplate:
    height: int
    prev_hash: bytes            # header byte order
    coinb1: bytes
    coinb2: bytes
    merkle_branch: list[bytes]
    version: int
    nbits: int
    ntime: int
    reward: int                 # atomic units (coinbase value)


@dataclasses.dataclass
class SubmitOutcome:
    accepted: bool
    block_hash: str = ""
    reason: str = ""


class BlockchainClient(Protocol):
    """What the pool needs from a chain node (reference iface
    internal/pool/block_submitter.go:52-58)."""

    async def get_block_template(self) -> BlockTemplate: ...
    async def submit_block(self, header: bytes) -> SubmitOutcome: ...
    async def get_confirmations(self, block_hash: str) -> int: ...
    async def get_network_difficulty(self) -> float: ...


class MockChainClient:
    """In-process regtest-style chain for tests and solo-mode dry runs.

    Deterministic: templates derive entirely from the chain state (height,
    tip, a race counter), so a seeded test replays bit-identically.
    ``bump_template()`` stages a second distinct template at the same
    height; ``reorg(depth)`` rewinds the tip onto a fork; ``reject_stale``
    refuses submits whose prev-hash is not the current tip.

    The default nbits 0x207FFFFF is regtest: half of all hashes win. Pass
    0x1d00ffff for difficulty 1.
    """

    def __init__(self, nbits: int = 0x207FFFFF, reward: int = 50 * 100_000_000,
                 *, reject_stale: bool = False):
        self.nbits = nbits
        self.reward = reward
        self.height = 100
        self.tip = b"\x00" * 32
        self.reject_stale = reject_stale
        self.submitted: list[tuple[int, bytes, str]] = []
        self.confirmations: dict[str, int] = {}
        self.template_nonce = 0     # bumped per race/reorg: changes coinb1
        self.reorgs = 0

    def bump_template(self) -> None:
        """Stage a template race: same height and prev, other coinbase."""
        self.template_nonce += 1

    def reorg(self, depth: int) -> None:
        """Rewind ``depth`` blocks onto a deterministic fork tip."""
        depth = min(depth, len(self.submitted))
        if depth <= 0:
            return
        for _, _, orphaned_hash in self.submitted[-depth:]:
            self.confirmations.pop(orphaned_hash, None)
        del self.submitted[-depth:]
        self.height -= depth
        self.reorgs += 1
        self.tip = sha256d(b"mock-fork" + struct.pack("<II", self.height,
                                                      self.reorgs))
        self.template_nonce += 1

    async def get_block_template(self) -> BlockTemplate:
        return BlockTemplate(
            height=self.height + 1,
            prev_hash=self.tip,
            coinb1=bytes.fromhex("01000000010000000000000000")
            + struct.pack("<I", (self.height + 1) ^ (self.template_nonce << 20)),
            coinb2=bytes.fromhex("ffffffff0100f2052a01000000"),
            merkle_branch=[],
            version=0x20000000,
            nbits=self.nbits,
            ntime=int(time.time()),
            reward=self.reward,
        )

    async def submit_block(self, header: bytes) -> SubmitOutcome:
        if len(header) != 80:
            return SubmitOutcome(False, reason="bad header size")
        if self.reject_stale and header[4:36] != self.tip:
            return SubmitOutcome(False, reason="stale-prevblk")
        digest = sha256d(header)
        if not tgt.hash_meets_target(digest, tgt.bits_to_target(self.nbits)):
            return SubmitOutcome(False, reason="high-hash")
        block_hash = digest[::-1].hex()
        self.height += 1
        self.tip = digest
        self.submitted.append((self.height, header, block_hash))
        self.confirmations[block_hash] = 1
        log.info("mock chain accepted block %d %s", self.height, block_hash[:16])
        return SubmitOutcome(True, block_hash=block_hash)

    async def get_confirmations(self, block_hash: str) -> int:
        if block_hash not in self.confirmations:
            return -1  # orphaned / unknown
        self.confirmations[block_hash] += 1
        return self.confirmations[block_hash]

    async def get_network_difficulty(self) -> float:
        return tgt.target_to_difficulty(tgt.bits_to_target(self.nbits))


class BitcoinRPCClient:
    """JSON-RPC client for bitcoind-compatible nodes. Blocking HTTP runs
    in the loop's default executor, so the event loop never blocks, over
    a keep-alive connection pool (``utils/netpool``)."""

    def __init__(self, url: str, user: str = "", password: str = "",
                 timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._auth = None
        if user:
            self._auth = "Basic " + base64.b64encode(
                f"{user}:{password}".encode()
            ).decode()
        self._id = 0
        # keep-alive pool: template polls and block submits must not pay
        # TCP connect + slow start per call
        self._pool = HttpConnectionPool(url, timeout=timeout)
        u = urlparse(url)
        # hosted RPC providers key auth on the query string — keep it
        self._path = (u.path or "/") + (f"?{u.query}" if u.query else "")

    # response-read replays are safe for reads/polls, NOT for submits
    # (a replayed submitblock answers "duplicate", which would mis-report
    # a succeeded block as rejected) — see netpool.request's policy
    _IDEMPOTENT = frozenset({
        "getblocktemplate", "getnetworkinfo", "getdifficulty",
        "getblockheader", "getblockcount", "getblockchaininfo",
        "getmininginfo", "getblock",
    })

    async def _rpc(self, method: str, params: list | None = None):
        self._id += 1
        payload = json.dumps(
            {"jsonrpc": "1.0", "id": self._id, "method": method,
             "params": params or []}
        ).encode()

        def do_request():
            headers = {"Content-Type": "application/json"}
            if self._auth:
                headers["Authorization"] = self._auth
            resp = self._pool.request(
                "POST", self._path, body=payload, headers=headers,
                idempotent=method in self._IDEMPOTENT,
            )
            # bitcoind ships JSON-RPC errors WITH an HTTP error status —
            # prefer the JSON error object; a proxy's HTML error page
            # (502 from nginx etc.) must surface the STATUS, not a
            # JSONDecodeError
            try:
                return json.loads(resp.body)
            except ValueError:
                raise RuntimeError(
                    f"rpc http {resp.status}: non-JSON response"
                ) from None

        obj = await asyncio.get_running_loop().run_in_executor(None, do_request)
        if obj.get("error"):
            raise RuntimeError(f"rpc {method}: {obj['error']}")
        return obj["result"]

    def close(self) -> None:
        """Release pooled keep-alive sockets (app teardown)."""
        self._pool.close()

    def pool_snapshot(self) -> dict:
        """Connection-pool telemetry."""
        return self._pool.snapshot()

    async def get_block_template(self) -> BlockTemplate:
        t = await self._rpc("getblocktemplate", [{"rules": ["segwit"]}])
        # the raw template fields the job builder consumes: the coinbase
        # halves stay empty, so TemplateSource builds the coinbase around
        # the configured payout script
        return BlockTemplate(
            height=int(t["height"]),
            prev_hash=bytes.fromhex(t["previousblockhash"])[::-1],
            coinb1=b"",
            coinb2=b"",
            merkle_branch=[],
            version=int(t["version"]),
            nbits=int(t["bits"], 16),
            ntime=int(t["curtime"]),
            reward=int(t.get("coinbasevalue", 0)),
        )

    async def submit_block(self, header: bytes) -> SubmitOutcome:
        res = await self._rpc("submitblock", [header.hex()])
        if res is None:
            return SubmitOutcome(True, block_hash=sha256d(header)[::-1].hex())
        return SubmitOutcome(False, reason=str(res))

    async def get_confirmations(self, block_hash: str) -> int:
        try:
            block = await self._rpc("getblock", [block_hash])
            return int(block.get("confirmations", 0))
        except RuntimeError:
            return -1

    async def get_network_difficulty(self) -> float:
        return float(await self._rpc("getdifficulty"))
