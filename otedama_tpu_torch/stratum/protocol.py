"""Stratum V1 wire protocol: line-delimited JSON-RPC messages
(counterpart of ``otedama_tpu/stratum/protocol.py``, copied whole).

Reference parity: internal/stratum/unified_stratum.go — Message schema
(ID/Method/Params/Result/Error), mining.notify param order (:433-477),
mining.submit param order (:397-417), subscribe result shape (:690-714).
The codec is symmetric (client and server share it), unlike the reference
which hand-rolls marshalling at each call site.

Wire conventions (bitcoin stratum V1):
- one JSON object per line, ``\\n`` terminated;
- notifications carry ``id: null``;
- errors are ``[code, message, traceback|null]`` triples;
- hex fields: prevhash is word-swapped (see engine.jobs), version/nbits/ntime
  are big-endian hex, nonce is the big-endian word of header bytes 76:80.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any

from otedama_tpu_torch.engine.jobs import decode_prevhash, encode_prevhash
from otedama_tpu_torch.engine.types import Job, Share
from otedama_tpu_torch.kernels import target as tgt


class StratumError(Exception):
    """A JSON-RPC error response ([code, message, data])."""

    def __init__(self, code: int, message: str, data: Any = None):
        super().__init__(f"stratum error {code}: {message}")
        self.code = code
        self.message = message
        self.data = data

    def as_triple(self) -> list:
        return [self.code, self.message, self.data]


# error codes used by the major pool implementations
ERR_OTHER = 20
ERR_STALE = 21
ERR_DUPLICATE = 22
ERR_LOW_DIFF = 23
ERR_UNAUTHORIZED = 24
ERR_NOT_SUBSCRIBED = 25


@dataclasses.dataclass
class Message:
    id: int | str | None = None
    method: str | None = None
    params: Any = None
    result: Any = None
    error: list | None = None

    @property
    def is_request(self) -> bool:
        return self.method is not None and self.id is not None

    @property
    def is_notification(self) -> bool:
        return self.method is not None and self.id is None

    @property
    def is_response(self) -> bool:
        return self.method is None


def encode_line(msg: Message) -> bytes:
    obj: dict[str, Any] = {"id": msg.id}
    if msg.method is not None:
        obj["method"] = msg.method
        obj["params"] = msg.params if msg.params is not None else []
    else:
        obj["result"] = msg.result
        obj["error"] = msg.error
    return (json.dumps(obj, separators=(",", ":")) + "\n").encode()


def decode_line(line: bytes | str) -> Message:
    obj = json.loads(line)
    if not isinstance(obj, dict):
        raise ValueError("stratum message must be a JSON object")
    return Message(
        id=obj.get("id"),
        method=obj.get("method"),
        params=obj.get("params"),
        result=obj.get("result"),
        error=obj.get("error"),
    )


# -- job conversion ----------------------------------------------------------

def notify_params(job: Job, clean: bool | None = None) -> list:
    """Job -> mining.notify params (the 9-element stratum V1 array)."""
    return [
        job.job_id,
        encode_prevhash(job.prev_hash),
        job.coinb1.hex(),
        job.coinb2.hex(),
        [node.hex() for node in job.merkle_branch],
        f"{job.version:08x}",
        f"{job.nbits:08x}",
        f"{job.ntime:08x}",
        bool(job.clean if clean is None else clean),
    ]


def job_from_notify(
    params: list,
    *,
    extranonce1: bytes = b"",
    extranonce2_size: int = 4,
    share_difficulty: float = 1.0,
    algorithm: str = "sha256d",
) -> Job:
    """mining.notify params -> engine Job."""
    if not isinstance(params, list) or len(params) < 9:
        raise ValueError("mining.notify needs 9 params")
    job_id, prevhash, coinb1, coinb2, branch, version, nbits, ntime, clean = params[:9]
    return Job(
        job_id=str(job_id),
        prev_hash=decode_prevhash(prevhash),
        coinb1=bytes.fromhex(coinb1),
        coinb2=bytes.fromhex(coinb2),
        merkle_branch=[bytes.fromhex(n) for n in branch],
        version=int(version, 16),
        nbits=int(nbits, 16),
        ntime=int(ntime, 16),
        clean=bool(clean),
        algorithm=algorithm,
        extranonce1=extranonce1,
        extranonce2_size=extranonce2_size,
        share_target=tgt.difficulty_to_target(share_difficulty),
    )


# -- share conversion --------------------------------------------------------

def submit_params(worker_user: str, share: Share) -> list:
    """Share -> mining.submit params [user, job_id, en2, ntime, nonce]."""
    return [
        worker_user,
        share.job_id,
        share.extranonce2_hex,
        f"{share.ntime:08x}",
        f"{share.nonce_word:08x}",
    ]


@dataclasses.dataclass(frozen=True)
class ShareSubmission:
    """A parsed mining.submit from the wire (pool side)."""

    worker_user: str
    job_id: str
    extranonce2: bytes
    ntime: int
    nonce_word: int

    @classmethod
    def from_params(cls, params: list) -> "ShareSubmission":
        from otedama_tpu_torch.security import validation as val

        if not isinstance(params, list) or len(params) < 5:
            raise StratumError(ERR_OTHER, "mining.submit needs 5 params")
        user, job_id, en2, ntime, nonce = params[:5]
        try:
            # shape-check untrusted fields BEFORE decoding: a multi-MB
            # "hex" extranonce2 or non-string job id must die cheaply
            # (reference: internal/security/input_validation.go)
            if not isinstance(job_id, str) or len(job_id) > 128:
                raise val.ValidationError("job id: bad shape")
            return cls(
                worker_user=val.validate_worker_name(str(user)),
                job_id=job_id,
                extranonce2=val.validate_hex(
                    en2, max_bytes=16, field="extranonce2"
                ),
                ntime=int.from_bytes(
                    val.validate_hex(ntime, exact_bytes=4, field="ntime"),
                    "big",
                ),
                nonce_word=int.from_bytes(
                    val.validate_hex(nonce, exact_bytes=4, field="nonce"),
                    "big",
                ),
            )
        except (val.ValidationError, ValueError, TypeError) as e:
            raise StratumError(ERR_OTHER, f"malformed submit params: {e}") from None

    @property
    def nonce_bytes(self) -> bytes:
        return struct.pack(">I", self.nonce_word)
