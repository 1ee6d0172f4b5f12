"""x11 (Dash) chained-hash host tier: the port's own copy of
``otedama_tpu/kernels/x11`` (the lane-axis numpy stage modules and the
chain), with the same names and bytes.

x11 = blake512 -> bmw512 -> groestl512 -> skein512 -> jh512 -> keccak512 ->
luffa512 -> cubehash512 -> shavite512 -> simd512 -> echo512, hashing the
80-byte header through 11 chained 512-bit digests, with the final echo
digest truncated to its first 32 bytes for the target compare.

This chain is the one the JAX package computes, not one certified against
the Dash network: ``simd512`` is an uncertified reconstruction and
``shavite512``'s counter-injection order is a runtime switch
(``shavite.CNT_VARIANTS``). x11 therefore registers ``canonical=False`` in
the port's registry (``engine/algos.py``), the ``"dash"`` alias refuses to
resolve, and only a certification artifact whose fingerprint (the chain's
digest of ``DASH_GENESIS_HEADER``) still matches flips the gate
(``_maybe_certify``, ``utils/certification.py``: the same artifact path
and ``OTEDAMA_CERT_PATH`` as the reference). Chain-level oracle for that
day: x11(Dash genesis header) must equal the genesis block hash; two
conflicting recollections of that value are kept in
``DASH_GENESIS_ORACLES``, and a match against either is a finalist, not a
certification.

The numpy chain is the oracle of the port's x11 paths: every winner a
device backend reports is re-hashed through ``x11_digest``, the
``python`` backend searches with ``x11_digest_batch``, and the share
validator's host tier uses ``x11_verify_batch``. The plain PyTorch chain
(``kernels/x11_torch.py``) and the card's kernel B6 (``csrc/x11.cu``)
are held against it.
"""

from __future__ import annotations

import struct

import numpy as np

from otedama_tpu_torch.kernels.x11 import (
    blake,
    bmw,
    cubehash,
    echo,
    groestl,
    jh,
    keccak,
    luffa,
    shavite,
    simd,
    skein,
)

# single source of truth for the chain-level certification oracle
# (consumed by tests/test_x11.py and tools/simd_search.py)
DASH_GENESIS_HEADER: bytes = (
    struct.pack("<I", 1)
    + bytes(32)
    + bytes.fromhex(
        "e0028eb9648db56b1ac77cf090b99048a8007e2bb64b68f092c03c7f56a662c7"
    )[::-1]
    + struct.pack("<III", 1390095618, 0x1E0FFFF0, 28917698)
)

# conflicting offline recollections of the genesis hash — see module
# docstring; a match against either is a FINALIST, not a certification
DASH_GENESIS_ORACLES = {
    "round2-recall":
        "00000ffd590b1485b3caadc19b22e6379c733355108f107a430458cdb3407424",
    "round3-chainparams-recall":
        "00000ffd590b1485b3caadc19b22e6379c733355108f107a430458cdf3407ab6",
}

ORDER = (
    "blake512", "bmw512", "groestl512", "skein512", "jh512", "keccak512",
    "luffa512", "cubehash512", "shavite512", "simd512", "echo512",
)

# stage name -> bytes-level implementation (filled in as stages land)
STAGES_BYTES = {
    "blake512": blake.blake512_bytes,
    "bmw512": bmw.bmw512_bytes,
    "groestl512": groestl.groestl512_bytes,
    "skein512": skein.skein512_bytes,
    "jh512": jh.jh512_bytes,
    "keccak512": keccak.keccak512_bytes,
    "luffa512": luffa.luffa512_bytes,
    "cubehash512": cubehash.cubehash512_bytes,
    "shavite512": shavite.shavite512_bytes,
    "simd512": simd.simd512_bytes,
    "echo512": echo.echo512_bytes,
}


def x11_digest_batch(headers: "np.ndarray") -> "np.ndarray":
    """Vectorized x11 over a batch of 80-byte headers ``[B, 80]`` uint8.

    Every stage is lane-axis numpy, so one call chains the whole batch;
    byte/word conversions between stages follow each algorithm's wire
    convention (LE/BE words as in the scalar path). Returns ``[B, 32]``.
    """
    h = np.atleast_2d(headers)
    B = h.shape[0]

    def be64(x):  # bytes[B, n] -> uint64 BE words
        return np.ascontiguousarray(x).view(">u8").astype(np.uint64)

    def le64(x):
        return np.ascontiguousarray(x).view("<u8").astype(np.uint64)

    def be32(x):
        return np.ascontiguousarray(x).view(">u4").astype(np.uint32)

    def le32(x):
        return np.ascontiguousarray(x).view("<u4").astype(np.uint32)

    d = blake.blake512(be64(h), h.shape[1])
    b = d.astype(">u8").view(np.uint8).reshape(B, 64)
    d = bmw.bmw512(le64(b), 64)
    b = d.astype("<u8").view(np.uint8).reshape(B, 64)
    b = groestl.groestl512(b, 64)
    d = skein.skein512(le64(b), 64)
    b = d.astype("<u8").view(np.uint8).reshape(B, 64)
    b = jh.jh512(b, 64)
    d = keccak.keccak512(le64(b), 64)
    b = d.astype("<u8").view(np.uint8).reshape(B, 64)
    d = luffa.luffa512(be32(b), 64)
    b = d.astype(">u4").view(np.uint8).reshape(B, 64)
    d = cubehash.cubehash512(le32(b), 64)
    b = d.astype("<u4").view(np.uint8).reshape(B, 64)
    d = shavite.shavite512(le32(b), 64)
    b = d.astype("<u4").view(np.uint8).reshape(B, 64)
    b = simd.simd512(b, 64)
    b = echo.echo512(b, 64)
    return b[:, :32]


def x11_verify_batch(headers: "np.ndarray", targets: list[int]):
    """Lane-parallel x11 share validation: one pipeline pass over N
    submitted 80-byte headers, each digest compared EXACTLY against its
    own share target. The x11 tier of the device-batched validation
    path (runtime/validate.py): the 11 stages are lane-axis numpy (the
    vectorized tier), with the jnp chain injectable where a TPU is
    paying the compile anyway. Returns ``(verdicts bool[N], min_h0)``
    where ``min_h0`` is the minimum top compare limb (best-share
    telemetry, same unit as the search kernels')."""
    h = np.atleast_2d(headers)
    digests = x11_digest_batch(h)
    n = h.shape[0]
    verdicts = np.zeros((n,), dtype=bool)
    best = 0xFFFFFFFF
    for i in range(n):
        v = int.from_bytes(digests[i].tobytes(), "little")
        verdicts[i] = v <= targets[i]
        best = min(best, v >> 224)
    return verdicts, best


def missing_stages() -> list[str]:
    return [s for s in ORDER if s not in STAGES_BYTES]


def x11_digest(data: bytes) -> bytes:
    """Full x11 chain (host/scalar). Raises until all 11 stages exist —
    a partial chain must never masquerade as x11."""
    gaps = missing_stages()
    if gaps:
        raise NotImplementedError(f"x11 stages not yet implemented: {gaps}")
    h = data
    for name in ORDER:
        h = STAGES_BYTES[name](h)
    return h[:32]


from otedama_tpu_torch.engine import algos as _algos  # noqa: E402


def _maybe_certify() -> bool:
    """Flip the canonical gate from the out-of-band certification
    artifact (the reference's tools/certify.py writes it), guarded by a fingerprint RECHECK: the
    artifact stores the full-chain Dash-genesis digest observed when the
    real-network vectors passed; we recompute it now so a kernel edited
    after certification un-certifies itself instead of shipping a
    drifted chain as canonical (utils/certification.py)."""
    import logging

    from otedama_tpu_torch.utils import certification

    cert = certification.get("x11")
    if not cert or missing_stages():
        return False
    prev_variant = shavite.active_cnt_variant()
    variant = cert.get("shavite_cnt_variant")
    if variant:
        # certification may have pinned a non-default counter order;
        # the fingerprint below only matches with it applied
        try:
            shavite.set_cnt_variant(str(variant))
        except ValueError:
            logging.getLogger("otedama.kernels.x11").warning(
                "x11 certification names unknown shavite counter "
                "variant %r — keeping canonical=False", variant,
            )
            return False
    want = str(cert.get("genesis_hash", "")).lower()
    got = x11_digest(DASH_GENESIS_HEADER)[::-1].hex()
    if want and got == want:
        _algos.mark_canonical("x11")
        return True
    # failed recheck: fall back to the default order — the process must
    # not keep hashing under a variant that passed NO validation
    shavite.set_cnt_variant(prev_variant)
    logging.getLogger("otedama.kernels.x11").warning(
        "x11 certification artifact present but the chain fingerprint "
        "no longer matches (%s != %s) — the kernel changed since "
        "certification; keeping canonical=False", got[:16], want[:16],
    )
    return False


_maybe_certify()
