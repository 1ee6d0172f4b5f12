"""Signed stratum session resume tokens for multi-region miner handoff
(counterpart of ``otedama_tpu/stratum/resume.py``, copied whole; the
server reads tokens only when ``session_secret`` is set).

A pool front-end that dies takes its session table with it. Rather than
replicate session state between regions, every front-end of one
deployment shares a secret and issues each subscriber a SIGNED token
capturing the session state a reconnect must recover: the extranonce1
(the miner's nonce-space lease — losing it would force a mid-flight
work restart and, worse, could land the miner inside another session's
space) and the current vardiff difficulty (losing it resets a tuned
miner to ``initial_difficulty`` and burns minutes of retargeting).

The token rides the standard stratum seams, so stock miners that echo
the session-id parameter get handoff for free:

- issued as the 4th element of the ``mining.subscribe`` result (clients
  that read only the canonical 3 ignore it);
- refreshed via a ``mining.set_resume_token`` notification whenever
  vardiff retargets (the token must always describe the CURRENT state);
- presented as the 2nd ``mining.subscribe`` parameter on reconnect —
  the slot classic stratum reserves for "previous session id".

Stratum V2 rides the SAME token (stratum/v2.py): the ``extranonce1``
field carries the channel's fixed extranonce prefix — whose big-endian
value IS the 32-bit ``[region byte | worker slice | counter]`` channel
id — so one verified token recovers channel id, search space, and
difficulty on any front-end sharing the secret. V2 tokens are
protocol-TYPED (``"p": "v2"`` in the signed payload; absence means V1)
because the two wires' allocators draw from one lease space with
independent live-collision scans — a token must only resume on the
wire that issued it. V2 delivers it via the ``SetResumeToken`` vendor
frame and presents it via ``ResumeChannel``; the verification, TTL,
and threat-model notes below apply unchanged
(V2 deployments running the Noise transport additionally close the
plaintext-bearer-token exposure V1 documents).

Tokens are stateless on the server: any region verifies the HMAC with
the shared ``session_secret`` and recovers the session without having
ever seen the miner before. Forgery is an HMAC forgery. Replay — the
token is a BEARER credential on a classic-stratum plaintext wire — is
bounded by ``ttl``, and within one region by the live-session collision
check at the accepting server (stratum/server.py); ACROSS regions a
stolen token can alias the victim's extranonce1 lease until the ttl
expires (each region sees only its own sessions), which costs the
victim duplicate-rejected shares, not credit already earned. Where
token theft is in the threat model, terminate V1 stratum behind TLS or
a tunnel; chain-recorded single-use tokens are future work.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import time

TOKEN_VERSION = 1
_SIG_BYTES = 16  # truncated HMAC-SHA256: 128-bit forgery resistance


@dataclasses.dataclass(frozen=True)
class ResumeState:
    """What a verified token recovers on the accepting front-end."""

    region_id: int        # region that ISSUED the token (telemetry only)
    extranonce1: bytes
    difficulty: float
    issued_at: float


def _sign(secret: str, payload: bytes) -> bytes:
    return hmac.new(secret.encode(), payload, hashlib.sha256).digest()[
        :_SIG_BYTES
    ]


def issue_token(secret: str, region_id: int, extranonce1: bytes,
                difficulty: float, now: float | None = None,
                protocol: str = "v1") -> str:
    """Encode + sign the resumable session state. ``secret`` must be the
    deployment-wide ``region.session_secret`` or no other region will
    honour the token. ``protocol`` types the token: the V1 and V2
    lease allocators draw from ONE partitioned space with independent
    live-collision scans (V1 sees only its sessions, V2 only its
    channels), so a token must only ever resume on the wire that
    issued it — a cross-protocol replay could alias a lease still
    live under the other server. "v1" is encoded as ABSENCE for
    wire-compatibility with pre-PR-15 tokens."""
    if not secret:
        raise ValueError("resume tokens require a session secret")
    fields = {
        "v": TOKEN_VERSION,
        "r": int(region_id),
        "e1": extranonce1.hex(),
        "d": float(difficulty),
        "t": round(time.time() if now is None else now, 3),
    }
    if protocol != "v1":
        fields["p"] = protocol
    payload = json.dumps(
        fields, separators=(",", ":"), sort_keys=True,
    ).encode()
    blob = payload + _sign(secret, payload)
    return base64.urlsafe_b64encode(blob).decode().rstrip("=")


def verify_token(secret: str, token: str, ttl: float,
                 now: float | None = None,
                 protocol: str = "v1") -> ResumeState | None:
    """Verify signature + freshness and decode. Returns None for ANY
    defect (malformed, forged, expired, future-dated, or a token typed
    for the OTHER protocol) — a bad token must degrade to a fresh
    subscribe, never to an error a miner chokes on."""
    if not secret or not token or len(token) > 512:
        return None
    try:
        blob = base64.urlsafe_b64decode(token + "=" * (-len(token) % 4))
    except (ValueError, TypeError):
        return None
    if len(blob) <= _SIG_BYTES:
        return None
    payload, sig = blob[:-_SIG_BYTES], blob[-_SIG_BYTES:]
    if not hmac.compare_digest(_sign(secret, payload), sig):
        return None
    try:
        obj = json.loads(payload)
        if obj.get("v") != TOKEN_VERSION:
            return None
        if obj.get("p", "v1") != protocol:
            return None
        state = ResumeState(
            region_id=int(obj["r"]),
            extranonce1=bytes.fromhex(str(obj["e1"])),
            difficulty=float(obj["d"]),
            issued_at=float(obj["t"]),
        )
    except (KeyError, ValueError, TypeError):
        return None
    if not state.extranonce1 or len(state.extranonce1) > 8:
        return None
    if state.difficulty <= 0:
        return None
    now = time.time() if now is None else now
    # expired or absurdly future-dated (a skewed issuer must not mint
    # tokens that outlive the ttl policy)
    if state.issued_at > now + 60.0 or now - state.issued_at > ttl:
        return None
    return state
