"""SHAvite-3-512 (AES-based Feistel — x11 stage 9).

Lane-axis implementation. C512 compression: 512-bit state as four 128-bit
quarters (p0..p3), 14 Feistel rounds where each of the two branch updates
runs a 4-AES-round keyed F function; 448 32-bit subkeys from the message
expansion:

- 13 expansion blocks of 32 words after the 32 message words, alternating
  NONLINEAR and LINEAR starting nonlinear (7 NL + 6 L).
- Nonlinear group appended at index u: AES round (keyless) of the one-word
  rotation of the 32-back words — x = (rk[u-31], rk[u-30], rk[u-29],
  rk[u-32]) — XORed with the last four words rk[u-4..u-1].
- Linear: rk[u+j] = rk[u-32+j] ^ rk[u-7+j] (the -7 tap crosses group
  boundaries on purpose).
- The 128-bit bit counter is injected at subkey indices 32, 164, 316, 440
  with word orders (c0,c1,c2,~c3), (c3,c2,c1,~c0), (c2,c3,c0,~c1),
  (c1,c0,c3,~c2) — inside the expansion, so later subkeys depend on it.

Padding: 0x80, zeros, the 16-byte LE bit counter at block bytes 110..125,
the 2-byte digest size at 126..127. A block consisting only of padding is
compressed with counter 0.

Words are little-endian; AES rounds view each 128-bit quantity as the
standard column-major AES state.

Validated: the empty-message digest reproduces the SHAvite-3-512
ShortMsgKAT Len=0 digest (a485c1b2...). Scope caveat: that vector runs
with counter=0, so all four counter words are zero and the KAT pins the
injection OFFSETS and the complement position but CANNOT distinguish the
_CNT_INJECT word orders — the (c0,c1,c2,~c3)/(c3,c2,c1,~c0)/... orders are
from this author's recall of the reference and remain unverified for
nonzero counters (i.e. for every real x11 input). A nonzero-counter
cross-check (or the Dash-genesis chain oracle once simd is canonical) is
required before treating this stage as fully certified.
"""

from __future__ import annotations

import numpy as np

from otedama_tpu_torch.kernels.x11.echo import _aes_round

U32 = np.uint32

ROUNDS = 14
RK_WORDS = 448

# published SHAvite-3-512 initial value
IV512 = (
    0x72FCCDD8, 0x79CA4727, 0x128A077B, 0x40D55AEC,
    0xD1901A06, 0x430AE307, 0xB29F5CD1, 0xDF07FBFC,
    0x8E45D73D, 0x681AB538, 0xBDE86578, 0xDD577E47,
    0xE275EADE, 0x502D9FCD, 0xB9357178, 0x022A4B9A,
)

# Counter-injection word orders (verdict r5 item 8: a wrong recall must
# cost a CONFIG FLIP, not a kernel rewrite). The Len=0 KAT pins the
# injection OFFSETS (32/164/316/440) and the complement position (last
# word of each group: with all counter words zero only ~c contributes),
# but NOT the order of (c0..c3) within a group — so the order variants
# live behind one switch and tools/certify.py auto-selects among them
# the day a nonzero-counter vector exists (the artifact records the
# winner; _maybe_certify applies it before the fingerprint recheck).
# NB selectivity: for any message under 2^32 bits only counter word c0
# is nonzero, so vectors can only pin WHERE c0 sits at each injection —
# variants sharing that c0-position trajectory are indistinguishable by
# any realistic vector (e.g. pure rotations share r3-recall's). The
# registered set therefore keeps one representative per DISTINCT c0
# trajectory (listed in the comments).
CNT_VARIANTS: dict[str, dict[int, tuple[int, int, int, int]]] = {
    # this author's recall of the reference; c0 at positions (0,3,2,1)
    "r3-recall": {32: (0, 1, 2, 3), 164: (3, 2, 1, 0),
                  316: (2, 3, 0, 1), 440: (1, 0, 3, 2)},
    # same order everywhere; c0 at (0,0,0,0)
    "identity": {32: (0, 1, 2, 3), 164: (0, 1, 2, 3),
                 316: (0, 1, 2, 3), 440: (0, 1, 2, 3)},
    # c0 walks forward; c0 at (1,2,3,0)
    "c0-cycle": {32: (3, 0, 1, 2), 164: (1, 2, 0, 3),
                 316: (1, 2, 3, 0), 440: (0, 3, 1, 2)},
    # r3-recall with the last two injections swapped; c0 at (0,3,1,2)
    "swap-mid": {32: (0, 1, 2, 3), 164: (3, 2, 1, 0),
                 316: (1, 0, 3, 2), 440: (2, 3, 0, 1)},
    # fully reversed everywhere; c0 at (3,3,3,3)
    "reverse-all": {32: (3, 2, 1, 0), 164: (3, 2, 1, 0),
                    316: (3, 2, 1, 0), 440: (3, 2, 1, 0)},
}
_ACTIVE_CNT_VARIANT = "r3-recall"


def active_cnt_variant() -> str:
    return _ACTIVE_CNT_VARIANT


def set_cnt_variant(name: str) -> None:
    """Switch the counter-injection word order (certification day)."""
    global _ACTIVE_CNT_VARIANT
    if name not in CNT_VARIANTS:
        raise ValueError(
            f"unknown shavite counter-order variant {name!r}; "
            f"known: {sorted(CNT_VARIANTS)}"
        )
    _ACTIVE_CNT_VARIANT = name


def select_cnt_variant(pairs: "list[tuple[bytes, bytes]]") -> str | None:
    """Find the unique variant under which every (message, digest)
    vector passes. Only nonzero-counter (non-empty) messages can
    discriminate; returns None when none or several variants pass
    (several = the vectors cannot pin the order yet)."""
    global _ACTIVE_CNT_VARIANT
    prev = _ACTIVE_CNT_VARIANT
    passing = []
    try:
        for name in CNT_VARIANTS:
            _ACTIVE_CNT_VARIANT = name
            if all(shavite512_bytes(msg) == want for msg, want in pairs):
                passing.append(name)
    finally:
        _ACTIVE_CNT_VARIANT = prev
    return passing[0] if len(passing) == 1 else None


def _words_to_aes_bytes(w: list[np.ndarray]) -> np.ndarray:
    """4 uint32 LE lanes -> [B, 16] AES byte state."""
    B = w[0].shape[0]
    out = np.empty((B, 16), dtype=np.uint8)
    for i in range(4):
        for b in range(4):
            out[:, 4 * i + b] = ((w[i] >> U32(8 * b)) & U32(0xFF)).astype(np.uint8)
    return out


def _aes_bytes_to_words(s: np.ndarray) -> list[np.ndarray]:
    out = []
    for i in range(4):
        w = np.zeros(s.shape[0], dtype=np.uint32)
        for b in range(4):
            w |= s[:, 4 * i + b].astype(np.uint32) << U32(8 * b)
        out.append(w)
    return out


_ZERO_KEY = np.zeros(16, dtype=np.uint8)


def _aes0_words(w: list[np.ndarray]) -> list[np.ndarray]:
    """Keyless AES round over a 128-bit quantity given as 4 LE uint32 lanes."""
    return _aes_bytes_to_words(_aes_round(_words_to_aes_bytes(w), _ZERO_KEY))


def expand_keys(m: list[np.ndarray], counter: int) -> list[np.ndarray]:
    """448 subkey words (lanes) from 32 message words + the bit counter."""
    cnt = [U32((counter >> (32 * i)) & 0xFFFFFFFF) for i in range(4)]
    inject = CNT_VARIANTS[_ACTIVE_CNT_VARIANT]
    rk: list[np.ndarray] = list(m)
    u = 32
    nonlinear = True
    while u < RK_WORDS:
        if nonlinear:
            for _ in range(8):
                x = [rk[u - 31], rk[u - 30], rk[u - 29], rk[u - 32]]
                x = _aes0_words(x)
                for j in range(4):
                    rk.append(x[j] ^ rk[u - 4 + j])
                order = inject.get(u)
                if order is not None:
                    for j in range(4):
                        w = cnt[order[j]]
                        if j == 3:
                            w = ~w
                        rk[u + j] = rk[u + j] ^ w
                u += 4
        else:
            for _ in range(8):
                for j in range(4):
                    rk.append(rk[u - 32 + j] ^ rk[u - 7 + j])
                u += 4
        nonlinear = not nonlinear
    assert len(rk) == RK_WORDS
    return rk


def _f4(x: list[np.ndarray], keys: list[np.ndarray]) -> list[np.ndarray]:
    """4 keyed AES rounds: x ^ k0 -> A -> ^k1 -> A -> ^k2 -> A -> ^k3 -> A."""
    t = [x[j] ^ keys[j] for j in range(4)]
    for r in range(1, 4):
        t = _aes0_words(t)
        t = [t[j] ^ keys[4 * r + j] for j in range(4)]
    return _aes0_words(t)


def c512(h: list[np.ndarray], m: list[np.ndarray], counter: int) -> list[np.ndarray]:
    """One C512 compression. ``h``: 16 uint32 lanes; ``m``: 32 uint32 lanes."""
    rk = expand_keys(m, counter)
    p = [h[4 * q : 4 * q + 4] for q in range(4)]  # p0..p3 as 4-word groups
    for r in range(ROUNDS):
        k = rk[32 * r : 32 * (r + 1)]
        f1 = _f4(p[1], k[:16])
        f2 = _f4(p[3], k[16:])
        p[0] = [p[0][j] ^ f1[j] for j in range(4)]
        p[2] = [p[2][j] ^ f2[j] for j in range(4)]
        p = [p[3], p[0], p[1], p[2]]
    flat = [w for quarter in p for w in quarter]
    return [h[i] ^ flat[i] for i in range(16)]


def shavite512(data_words: np.ndarray, n_bytes: int) -> np.ndarray:
    """SHAvite-3-512 across lanes. ``data_words``: uint32 ``[B, ceil(n/4)]``
    little-endian words. Returns ``[B, 16]`` LE digest words."""
    data_words = np.atleast_2d(data_words)
    B = data_words.shape[0]
    bitlen = n_bytes * 8
    # 0x80 + counter(16B @ offset 110) + size(2B @ 126) must fit the block
    rem = n_bytes % 128
    total = (n_bytes - rem) + (128 if rem < 110 else 256)
    padded = np.zeros((B, total // 4), dtype=np.uint32)
    padded[:, : data_words.shape[1]] = data_words
    word_i, byte_i = divmod(n_bytes, 4)
    padded[:, word_i] |= U32(0x80) << U32(8 * byte_i)
    tail = bitlen.to_bytes(16, "little") + (512).to_bytes(2, "little")
    # bytes total-18 .. total-1 are word-aligned only in pairs: splice via bytes
    tail_arr = np.frombuffer(tail, dtype="<u2").astype(np.uint32)
    for k in range(9):  # 9 uint16 pieces at byte offsets total-18+2k
        byte_off = total - 18 + 2 * k
        wi, sh = divmod(byte_off, 4)
        padded[:, wi] |= U32(tail_arr[k]) << U32(8 * sh)

    h = [np.full(B, U32(v), dtype=np.uint32) for v in IV512]
    for blk in range(total // 128):
        m = [padded[:, blk * 32 + i] for i in range(32)]
        # counter: message bits processed incl. this block; 0 for pad-only
        c = min(bitlen, (blk + 1) * 1024)
        if c <= blk * 1024:
            c = 0
        h = c512(h, m, c)
    return np.stack(h, axis=-1)


def shavite512_bytes(data: bytes) -> bytes:
    n = len(data)
    padded = data + b"\x00" * ((-n) % 4)
    words = (
        np.frombuffer(padded, dtype="<u4").astype(np.uint32)[None, :]
        if padded
        else np.zeros((1, 0), dtype=np.uint32)
    )
    out = shavite512(words, n)
    return out[0].astype("<u4").tobytes()
