"""P2P wire format: length-prefixed binary frames (counterpart of
``otedama_tpu/p2p/messages.py``, copied whole; frames encoded by one
package decode in the other).

Reference parity: internal/p2p/messages.go + protocol.go:21-45 (message
schema: type/payload/timestamp/from/message_id) and optimized_network.go's
length-prefixed TCP framing with a network magic. Frame layout:

    magic   uint32 BE  (0x4F54504F "OTPO")
    length  uint32 BE  (bytes after this field)
    type    uint8
    payload length-4-... JSON body

JSON payloads keep the wire debuggable (the reference uses JSON inside its
binary frames too); the hot mining path never touches P2P, so codec speed
is not a constraint.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import secrets
import struct
import time

MAGIC = 0x4F54504F  # "OTPO"
MAX_FRAME = 4 << 20  # 4 MiB

# -- share-chain schemas ------------------------------------------------------
#
# SHARE payload (p2p/sharechain.py Share.to_payload):
#     {"header": <160 hex chars>, "worker": str, "job_id": str,
#      "ts_ms": int, "algorithm": str, "block_number": int}
# The 80-byte header IS the proof: prev-share hash at bytes 4:36, claim
# commitment at 36:68, claimed target as compact nbits at 72:76. Receivers
# verify the PoW before linking or re-flooding.
#
# SYNC_REQUEST payload (locator-based catch-up, replaces the timestamp dump):
#     {"locator": [<64 hex chars>, ...], "page": int}
# Locator hashes run newest -> oldest, exponentially spaced (bitcoin block
# locator); at most MAX_LOCATOR entries are honored.
#
# SYNC_RESPONSE payload:
#     {"shares": [<SHARE payload>, ...], "more": bool}
# Shares are the best-chain suffix after the highest recognized locator
# hash, oldest first, at most MAX_SYNC_PAGE per page; "more" drives the
# requester's next page.
#
# SHARE_BATCH payload (group-commit ledger, one flood per ledger batch):
#     {"shares": [<SHARE payload>, ...]}
# A lineage-ordered run of shares committed together (each extends the
# previous, oldest first, at most MAX_SHARE_BATCH). Receivers verify
# every member's PoW exactly like single SHARE gossip and connect in
# payload order; only the verified members are re-flooded — a Byzantine
# entry dies at the first honest hop without dragging its batchmates
# down.

MAX_SYNC_PAGE = 500
MAX_SHARE_BATCH = 500
MAX_LOCATOR = 64


def parse_locator(raw) -> list[str]:
    """Validate a wire locator: a bounded list of 32-byte hex hashes.
    Malformed entries are dropped (a partial locator still syncs — the
    receiver just starts from an earlier fork point or genesis)."""
    if not isinstance(raw, list):
        return []
    out: list[str] = []
    for entry in raw[:MAX_LOCATOR]:
        if isinstance(entry, str) and len(entry) == 64:
            try:
                bytes.fromhex(entry)
            except ValueError:
                continue
            out.append(entry)
    return out


class MessageType(enum.IntEnum):
    HANDSHAKE = 1
    HANDSHAKE_ACK = 2
    PING = 3
    PONG = 4
    SHARE = 5           # share gossip (P2P pool share-chain)
    JOB = 6             # job/work propagation
    BLOCK = 7           # block found
    PEER_LIST = 8       # discovery
    GET_PEERS = 9
    SYNC_REQUEST = 10   # share-chain sync
    SYNC_RESPONSE = 11
    TX = 12             # payout transaction gossip
    LEDGER = 13         # balance snapshot gossip
    SHARE_BATCH = 14    # one ledger batch of chained shares, one flood


@dataclasses.dataclass
class P2PMessage:
    type: MessageType
    payload: dict
    sender: str = ""                 # hex node id
    message_id: str = dataclasses.field(
        default_factory=lambda: secrets.token_hex(16)
    )
    timestamp: float = dataclasses.field(default_factory=time.time)

    def encode(self) -> bytes:
        body = json.dumps(
            {
                "payload": self.payload,
                "from": self.sender,
                "message_id": self.message_id,
                "ts": self.timestamp,
            },
            separators=(",", ":"),
        ).encode()
        frame = struct.pack(">B", int(self.type)) + body
        return struct.pack(">II", MAGIC, len(frame)) + frame

    @classmethod
    def decode_frame(cls, frame: bytes) -> "P2PMessage":
        if not frame:
            raise ValueError("empty frame")
        mtype = MessageType(frame[0])
        obj = json.loads(frame[1:]) if len(frame) > 1 else {}
        return cls(
            type=mtype,
            payload=obj.get("payload", {}),
            sender=obj.get("from", ""),
            message_id=obj.get("message_id", ""),
            timestamp=obj.get("ts", 0.0),
        )


async def read_frame(reader) -> bytes:
    """Read one frame body (type byte + JSON) from an asyncio reader."""
    header = await reader.readexactly(8)
    magic, length = struct.unpack(">II", header)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    if length > MAX_FRAME:
        raise ValueError(f"frame too large: {length}")
    return await reader.readexactly(length)
