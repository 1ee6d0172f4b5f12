"""The plain PyTorch version of scrypt (N=1024, r=1, p=1), Litecoin's proof
of work.

Counterpart of ``otedama_tpu/kernels/scrypt_jax.py`` (``salsa_double_round``,
``salsa20_8``, ``blockmix_salsa8_r1``, ``scrypt_1024_1_1``,
``scrypt_search_winners``, ``scrypt_verify_step``, ``header_words19``,
``scrypt_digest_host``) and
of the Pallas kernels of ``otedama_tpu/kernels/scrypt_pallas.py``:
``blockmix`` is the plain version of ``_bm_kernel`` / ``_bmx_kernel``
(BlockMix, with the mix pass's XOR fused in when ``Vt`` is given) and
``romix`` that of ``_romix_kernel_factory`` (the whole ROMix, with the
same fill and mix recurrences and the same odd-row recompute for
``half_v``).

It is the yardstick the CUDA kernels (``scrypt_cuda``) are held against on
the card, and what the CPU tests run; it is no yardstick of speed.

Words travel as int64 tensors holding values in ``[0, 2^32)``, as in
``sha256_torch``. The kernels' I/O tensors (``blockmix``, ``romix``,
``scrypt_search_buffer``) are int32 tensors that carry the uint32 bit
patterns, so kernel and plain results compare with ``torch.equal``.

Cost on the CPU. One ROMix is 2,048 BlockMixes in sequence, so eager
torch is bound by the number of ops, whatever the lane count. Each Salsa
step therefore runs its four independent quarter-rounds as one op on a
``[4, 4, B]`` state in *diagonal* order — rows ``a = (x0, x5, x10, x15)``,
``b = (x4, x9, x14, x3)``, ``c = (x8, x13, x2, x7)``,
``d = (x12, x1, x6, x11)`` — where a column round is
``b ^= R(a+d, 7); c ^= R(b+a, 9); d ^= R(c+b, 13); a ^= R(d+c, 18)`` and
turning rows b, c, d by -1, 2 and 1 places makes the row round the same
four lines (the layout of SIMD Salsa20 implementations). BlockMix and
ROMix never leave that order: XOR, the feed-forward add and V's rows are
word-wise, and Integerify's word 16 sits at ``[1, 0, 0]``. Between rotates
the words may carry bits above 31; every rotate masks its input, and every
value that leaves a Salsa core is masked.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter
from otedama_tpu_torch.kernels import sha256_torch as st
from otedama_tpu_torch.utils import pow_host
from otedama_tpu_torch.utils.sha256_host import SHA256_IV

M32 = 0xFFFFFFFF
SCRYPT_N = 1024

# calls of the plain entry points (blockmix, romix, scrypt_search_buffer,
# scrypt_search_buffers, scrypt_verify_step):
# chip_smoke shows that the card's main path makes none
calls = LaunchCounter()

# diagonal order: _DIAG[i] is the standard word index held at position i
_DIAG = torch.tensor([0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11])
_UNDIAG = torch.argsort(_DIAG)


# the turn between half rounds on the flattened 16 rows: a stays; b, c, d
# become d turned by -1, c by 2, b by 1. It is its own inverse, so after
# every double round the state is in column order again.
_TURN = torch.tensor([0, 1, 2, 3, 13, 14, 15, 12, 10, 11, 8, 9, 7, 4, 5, 6])


class _Mixer:
    """Salsa20/8 and BlockMix on diagonal states of ``L`` lanes, with every
    buffer allocated once: the plain version's ops are so small that their
    dispatch cost is the whole cost, so each step writes into a kept buffer
    (``out=``, in place) and takes its constants as tensors."""

    def __init__(self, lanes: int, device):
        def buf(*shape):
            return torch.empty(shape + (lanes,), dtype=torch.int64,
                               device=device)

        # ping-pong states of the half rounds, their rows and flat views
        self.states = [buf(4, 4), buf(4, 4)]
        self.rows = [s.unbind(0) for s in self.states]
        self.flat = [s.view(16, lanes) for s in self.states]
        self.m, self.r, self.t = buf(4), buf(4), buf(4, 4)
        self.mask = torch.tensor(M32, device=device)
        self.shift = {n: torch.tensor(32 - n, device=device)
                      for n in (7, 9, 13, 18)}
        self.turn = _TURN.to(device)

    def _quarter(self, t, p, q, n: int):
        """``t ^= rotl(p + q, n)`` for four quarter-rounds at once. The
        rotate of the masked sum m is ``m * 2^n + (m >> (32 - n))`` (the
        parts do not overlap); bits above 31 are left for later masks."""
        m, r = self.m, self.r
        torch.add(p, q, out=m)
        m &= self.mask
        torch.bitwise_right_shift(m, self.shift[n], out=r)
        torch.add(r, m, alpha=1 << n, out=r)
        t ^= r

    def half_rounds(self, x, count: int):
        """``count`` half rounds (column, row, ...) from state ``x``; returns
        the buffer that holds the result (bits above 31 unmasked)."""
        cur = 0
        self.states[cur].copy_(x)
        for _ in range(count):
            a, b, c, d = self.rows[cur]
            self._quarter(b, a, d, 7)
            self._quarter(c, b, a, 9)
            self._quarter(d, c, b, 13)
            self._quarter(a, d, c, 18)
            torch.index_select(self.flat[cur], 0, self.turn,
                               out=self.flat[1 - cur])
            cur = 1 - cur
        return self.states[cur]

    def salsa8(self, x, out):
        """``out = Salsa20/8(x)`` of a masked ``[4, 4, L]`` state."""
        torch.add(self.half_rounds(x, 8), x, out=out)
        out &= self.mask

    def blockmix(self, x, out):
        """``out = BlockMix(x)`` of a ``[2, 4, 4, L]`` state: Y0 =
        Salsa20/8(B1 ^ B0), Y1 = Salsa20/8(Y0 ^ B1). ``out`` may be ``x``."""
        torch.bitwise_xor(x[1], x[0], out=self.t)
        self.salsa8(self.t, out[0])
        torch.bitwise_xor(out[0], x[1], out=self.t)
        self.salsa8(self.t, out[1])


def _blockmix(x):
    """BlockMix of a diagonal ``[2, 4, 4, L]`` state, as a new tensor."""
    out = torch.empty_like(x)
    _Mixer(x.shape[-1], x.device).blockmix(x, out)
    return out


def _to_diag(words):
    """Standard-order ``[..., 16, L]`` words -> diagonal ``[..., 4, 4, L]``."""
    return words[..., _DIAG.to(words.device), :].unflatten(-2, (4, 4))


def _from_diag(x):
    return x.flatten(-3, -2)[..., _UNDIAG.to(x.device), :]


def _words(t):
    """int32 bit patterns (or int64 words) -> int64 words in [0, 2^32)."""
    return t.to(torch.int64) & M32


def _bits(x):
    """int64 words in [0, 2^32) -> int32 tensor of the same bit patterns."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _check_wordmajor(t):
    if t.dim() != 2 or t.shape[0] != 32:
        raise ValueError(f"expected word-major [32, B] lanes, got "
                         f"{tuple(t.shape)}")


def salsa_double_round(x):
    """One Salsa20 double round over standard-order words ``[16, ...]``."""
    flat = x.reshape(16, -1)
    s = _Mixer(flat.shape[-1], x.device).half_rounds(_to_diag(flat), 2)
    return _from_diag(s & M32).reshape(x.shape)


def salsa20_8(x):
    """Salsa20/8 core over standard-order words ``[16, ...]``."""
    flat = x.reshape(16, -1)
    out = torch.empty((4, 4, flat.shape[-1]), dtype=torch.int64,
                      device=x.device)
    _Mixer(flat.shape[-1], x.device).salsa8(_to_diag(flat), out)
    return _from_diag(out).reshape(x.shape)


def blockmix_salsa8_r1(X):
    """BlockMix r=1 on lane-major ``[..., 32]`` words."""
    lanes = X.reshape(-1, 32).T.reshape(2, 16, -1)
    out = _from_diag(_blockmix(_to_diag(lanes))).reshape(32, -1)
    return out.T.reshape(X.shape)


def blockmix(Xt, Vt=None):
    """BlockMix of word-major ``[32, B]`` lanes, or of ``Xt ^ Vt`` when
    ``Vt`` is given: the plain version of kernels B3 and B4. Takes and
    returns int32 bit patterns."""
    calls.add()
    _check_wordmajor(Xt)
    x = _words(Xt)
    if Vt is not None:
        if Vt.shape != Xt.shape:
            raise ValueError(f"Vt {tuple(Vt.shape)} != Xt {tuple(Xt.shape)}")
        x = x ^ _words(Vt)
    y = _blockmix(_to_diag(x.view(2, 16, -1)))
    return _bits(_from_diag(y).reshape(32, -1))


def _romix(x, half_v: bool):
    """ROMix N=1024 of a diagonal ``[2, 4, 4, B]`` state (int64 words), in
    place. V keeps the rows as int32 bit patterns; with ``half_v`` it keeps
    the even rows only and a mix step recomputes an odd row as BlockMix of
    the row before it (computed for every lane, selected where ``j`` is
    odd, as ``scrypt_pallas._romix_kernel_factory`` does)."""
    lanes = x.shape[-1]
    mixer = _Mixer(lanes, x.device)
    rows = SCRYPT_N // 2 if half_v else SCRYPT_N
    V = torch.empty((rows,) + tuple(x.shape), dtype=torch.int32,
                    device=x.device)
    for i in range(SCRYPT_N):
        if not half_v or i % 2 == 0:
            V[i // 2 if half_v else i] = _bits(x)
        mixer.blockmix(x, x)
    vb = torch.empty_like(x)
    for _ in range(SCRYPT_N):
        j = x[1, 0, 0] & (SCRYPT_N - 1)  # Integerify: word 16
        row = (j >> 1) if half_v else j
        vj = _words(torch.gather(
            V, 0, row.view(1, 1, 1, 1, lanes).expand((1,) + tuple(x.shape)))[0])
        if half_v:
            mixer.blockmix(vj, vb)
            vj = torch.where((j & 1).bool(), vb, vj)
        x ^= vj
        mixer.blockmix(x, x)
    return x


def _romix_bits(Xt, half_v: bool = False):
    x = _to_diag(_words(Xt).view(2, 16, -1))
    return _bits(_from_diag(_romix(x, half_v)).reshape(32, -1))


def romix(Xt, half_v: bool = False):
    """ROMix (N=1024, r=1) of word-major ``[32, B]`` lanes: the plain
    version of kernel B5. Takes and returns int32 bit patterns."""
    calls.add()
    _check_wordmajor(Xt)
    return _romix_bits(Xt, half_v)


# -- PBKDF2-HMAC-SHA256 around ROMix, specialised to the 80-byte header -------
# Words below are big-endian words of the byte strings, as in scrypt_jax.

def _hmac_states(key8, comp):
    """(inner, outer) chaining states of an HMAC keyed by 8 words."""
    zero = torch.zeros_like(key8[0])
    ipad = [k ^ 0x36363636 for k in key8] + [zero + 0x36363636] * 8
    opad = [k ^ 0x5C5C5C5C for k in key8] + [zero + 0x5C5C5C5C] * 8
    iv = tuple(zero + v for v in SHA256_IV)
    return comp(iv, ipad), comp(iv, opad)


def _hmac_finish(ostate, digest8, comp):
    """Outer compression over the 32-byte inner digest (96-byte message)."""
    zero = torch.zeros_like(digest8[0])
    w = list(digest8) + [zero + 0x80000000] + [zero] * 6 + [zero + 768]
    return comp(ostate, w)


def scrypt_1024_1_1(header_words, nonces, *, romix_fn=None):
    """scrypt(header, header, N=1024, r=1, p=1, dkLen=32) across lanes.

    ``header_words``: the 19 big-endian words of header[0:76], each an int
    (one header for every lane, a search) or an int64 ``[B]`` tensor (a
    header per lane, share validation); ``nonces``: int64 ``[B]`` tensor of
    header word 19 (the big-endian read of bytes 76:80). ``romix_fn`` maps
    word-major int32 ``[32, B]`` to the same (default: the plain ROMix).
    Returns the 8 big-endian digest words as int64 ``[B]`` tensors."""
    comp = st.compress
    zero = torch.zeros_like(nonces)
    hw = [zero + (w & M32 if torch.is_tensor(w) else int(w))
          for w in header_words] + [nonces & M32]

    # key0 = SHA256(header80): two blocks
    iv = tuple(zero + v for v in SHA256_IV)
    key0 = comp(comp(iv, hw[:16]),
                hw[16:20] + [zero + 0x80000000] + [zero] * 10 + [zero + 640])
    istate, ostate = _hmac_states(key0, comp)

    # PBKDF2 pass 1: B = T1..T4; inner message = header80 || INT(i)
    imid = comp(istate, hw[:16])
    T = []
    for i in range(1, 5):
        blk = (hw[16:20] + [zero + i, zero + 0x80000000] + [zero] * 9
               + [zero + 1184])  # (64 + 80 + 4) * 8 bits
        T.extend(_hmac_finish(ostate, comp(imid, blk), comp))

    # ROMix runs on little-endian words
    Xt = (romix_fn or _romix_bits)(
        _bits(torch.stack([st.bswap32(w) for w in T])))
    bw = [st.bswap32(w) for w in _words(Xt).unbind(0)]

    # PBKDF2 pass 2: HMAC(P, B' || INT(1)), the first 32 bytes
    inner = comp(comp(istate, bw[:16]), bw[16:32])
    blk = [zero + 1, zero + 0x80000000] + [zero] * 13 + [zero + 1568]
    return _hmac_finish(ostate, comp(inner, blk), comp)  # (64+128+4)*8 bits


def scrypt_search_buffer(header19, base: int, limbs, last: int, *, n: int,
                         k: int, device="cpu"):
    """The scrypt search kernels' result in plain tensor ops: the
    ``uint32[2k+3]`` winner buffer of ``scrypt_jax.scrypt_search_winners``
    over the ``n`` lanes from nonce ``base`` (wrapping mod 2^32), with
    lane offsets past ``last`` taking part in neither the winners nor the
    min top limb. Returns it as an int32 tensor on ``device``."""
    calls.add()
    lanes = max(0, min(n, int(last) + 1))
    return _search_buffers(header19, [(base, lanes)], limbs, k, device)[0]


def scrypt_search_buffers(header19, windows, limbs, *, k: int, device="cpu"):
    """``scrypt_search_buffer`` of several ``(base, lanes)`` windows of one
    header, all through one ROMix call (which costs the same for few lanes
    as for many); returns int32 ``[len(windows), 2k+3]`` on ``device``."""
    calls.add()
    return _search_buffers(header19, windows, limbs, k, device)


def _search_buffers(header19, windows, limbs, k: int, device):
    device = torch.device(device)
    limbs = [int(x) for x in np.asarray(limbs, dtype=np.uint32)]
    nonces = [(torch.arange(lanes, dtype=torch.int64, device=device)
               + int(base)) & M32 for base, lanes in windows]
    if sum(len(nw) for nw in nonces):
        h = st.digest_words_to_compare_order(
            scrypt_1024_1_1(header19, torch.cat(nonces)))
    bufs, off = [], 0
    for nw in nonces:
        if len(nw):
            hw = [w[off:off + len(nw)] for w in h]
            bufs.append(st.compact_winners(st.le256(hw, limbs), hw[0], nw, k))
        else:
            empty = torch.tensor([0] * (2 * k) + [0, 0, M32], dtype=torch.int64)
            empty[k:2 * k] = M32
            bufs.append(empty)
        off += len(nw)
    out = torch.stack([b.cpu() for b in bufs]).numpy().astype(np.uint32)
    return torch.from_numpy(out.view(np.int32)).to(device)


def scrypt_verify_step(words20, limbs, last: int, *, k: int):
    """scrypt share validation of ``[B, 20]`` header words against per-lane
    ``[B, 8]`` target limbs, failures compacted as
    ``sha256_torch.compact_failures`` does (lanes past ``last`` take no
    part): the counterpart of ``scrypt_jax.scrypt_verify_step`` and the
    plain version of ``scrypt_cuda.scrypt_verify``. Takes int32 bit
    patterns or int64 words; returns the int32 ``[2k+3]`` buffer."""
    calls.add()
    cols = _words(words20).unbind(1)
    h = st.digest_words_to_compare_order(scrypt_1024_1_1(cols[:19], cols[19]))
    passes = st.le256(h, _words(limbs).unbind(1))
    return _bits(st.compact_failures(passes, h[0], int(last), k))


def header_words19(header76: bytes) -> tuple[int, ...]:
    if len(header76) != 76:
        raise ValueError(f"need 76 header bytes, got {len(header76)}")
    return struct.unpack(">19I", header76)


def scrypt_digest_host(header80: bytes) -> bytes:
    """Scalar oracle via hashlib, the host re-check of every winner."""
    return pow_host.scrypt_1024_1_1(header80)
