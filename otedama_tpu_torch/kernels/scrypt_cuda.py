"""The scrypt kernels on the card: build, binding and wrappers.

``csrc/scrypt.cu`` replaces the Pallas TPU kernels of
``otedama_tpu/kernels/scrypt_pallas.py``: ``blockmix`` is ``_bm_kernel``
(B3) and, given ``Vt``, ``_bmx_kernel`` (B4); ``romix`` is
``_romix_kernel_factory`` (B5). ``scrypt_search`` is what the search
backends call: three launches into one winner buffer — the PBKDF2
prologue (header -> X), the ROMix (``romix``, or the ``blockmix`` tier's
2,048 BlockMix launches around a ``torch.gather`` of V's rows), and the
epilogue (PBKDF2 -> digest -> exact 256-bit compare -> winners), with the
``uint32[2k+3]`` buffer of ``scrypt_jax.scrypt_search_winners``. B5 runs
each lane's ROMix on four threads.
``scrypt_verify`` is share validation, the counterpart of
``scrypt_jax.scrypt_verify_step``: a verify prologue (each lane's own
header -> X), the ROMix (B5), and a verify epilogue (-> digest -> exact
compare with each lane's own target -> FAILURES by lane offset).

Each wrapper takes int32 tensors that carry the uint32 bit patterns, in
the word-major ``[32, B]`` layout of the TPU kernels. Given CPU tensors
(or a CPU device) it runs the plain version (``scrypt_torch``); given CUDA
ones it launches the kernel on ``stream`` (default: the current stream)
without synchronizing, or raises — it never falls back. Each counts its
kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter, cuda_build
from otedama_tpu_torch.kernels import scrypt_torch as st
from otedama_tpu_torch.kernels.sha256_cuda import (
    check_verify_inputs,
    winner_buffer_words,
)

SOURCE = "scrypt.cu"
HEADERS = ("sha256_device.cuh",)

SCRYPT_N = 1024
ROW_WORDS = 32              # one V row (one lane's X): 128 bytes
TIERS = ("romix", "romix-half", "blockmix")

# kernel launches through the wrappers (not the plain version's calls)
blockmix_launches = LaunchCounter()      # B3: BlockMix(X)
blockmix_xor_launches = LaunchCounter()  # B4: BlockMix(X ^ V[j])
romix_launches = LaunchCounter()         # B5: the whole ROMix
search_launches = LaunchCounter()        # prologue + epilogue pairs
verify_launches = LaunchCounter()        # verify prologue + epilogue pairs

_lib = None
_lib_lock = threading.Lock()
# what the last build reported: seconds, library path, ptxas register use
build_info: dict = {}


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library. Raises
    if the toolkit is missing or the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = cuda_build.build(SOURCE, HEADERS)
        build_info.update(info)
        p, n, i = ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int
        for fn, args in (
            (lib.otedama_scrypt_blockmix, [p, p, p, n, p]),
            (lib.otedama_scrypt_romix, [p, p, n, i, p]),
            (lib.otedama_scrypt_prologue, [p, n, p, p, i, p]),
            (lib.otedama_scrypt_epilogue, [p, n, p, p, i, p]),
            (lib.otedama_scrypt_verify_prologue, [p, n, p, p, i, p]),
            (lib.otedama_scrypt_verify_epilogue, [p, p, n, p, p, i, p]),
        ):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.otedama_scrypt_error_string.argtypes = [ctypes.c_int]
        lib.otedama_scrypt_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.otedama_scrypt_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check_lanes(name: str, t: torch.Tensor, device: torch.device) -> None:
    if (t.device != device or t.dtype != torch.int32 or t.dim() != 2
            or t.shape[0] != ROW_WORDS or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [32, B] tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _stream(stream, device) -> torch.cuda.Stream:
    return torch.cuda.current_stream(device) if stream is None else stream


def scratch_words(lanes: int) -> int:
    """Words of V for ``lanes`` lanes (full V; ``half_v`` uses half)."""
    return SCRYPT_N * ROW_WORDS * lanes


def blockmix(Xt: torch.Tensor, Vt: torch.Tensor | None = None, *,
             out: torch.Tensor | None = None,
             stream: torch.cuda.Stream | None = None) -> torch.Tensor:
    """BlockMix of word-major ``[32, B]`` lanes (B3), or of ``Xt ^ Vt``
    (B4). ``out`` may be ``Xt`` itself."""
    if Xt.device.type == "cpu":
        y = st.blockmix(Xt, Vt)
        return y if out is None else out.copy_(y)
    if Xt.device.type != "cuda":
        raise ValueError(f"blockmix runs on cuda or cpu, not {Xt.device}")
    _check_lanes("Xt", Xt, Xt.device)
    if Vt is not None:
        _check_lanes("Vt", Vt, Xt.device)
        if Vt.shape != Xt.shape:
            raise ValueError(f"Vt {tuple(Vt.shape)} != Xt {tuple(Xt.shape)}")
    stream = _stream(stream, Xt.device)
    if out is None:
        with torch.cuda.stream(stream):
            out = torch.empty_like(Xt)
    _check_lanes("out", out, Xt.device)
    if out.shape != Xt.shape:
        raise ValueError(f"out {tuple(out.shape)} != Xt {tuple(Xt.shape)}")
    lanes = Xt.shape[1]
    if lanes == 0:
        return out
    lib = load_library()
    with torch.cuda.device(Xt.device):
        rc = lib.otedama_scrypt_blockmix(
            Xt.data_ptr(), None if Vt is None else Vt.data_ptr(),
            out.data_ptr(), lanes, stream.cuda_stream)
    _check(lib, rc, "blockmix")
    (blockmix_launches if Vt is None else blockmix_xor_launches).add()
    return out


def _romix_in_place(x: torch.Tensor, half_v: bool, scratch: torch.Tensor,
                    stream: torch.cuda.Stream) -> None:
    lanes = x.shape[1]
    need = scratch_words(lanes) // (2 if half_v else 1)
    if (scratch.device != x.device or scratch.dtype != torch.int32
            or scratch.numel() < need or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be a contiguous int32 tensor of at "
                         f"least {need} words on {x.device}")
    lib = load_library()
    with torch.cuda.device(x.device):
        rc = lib.otedama_scrypt_romix(x.data_ptr(), scratch.data_ptr(), lanes,
                                      int(half_v), stream.cuda_stream)
    _check(lib, rc, "romix")
    romix_launches.add()


def romix(Xt: torch.Tensor, half_v: bool = False, *,
          scratch: torch.Tensor | None = None,
          stream: torch.cuda.Stream | None = None) -> torch.Tensor:
    """ROMix (N=1024, r=1) of word-major ``[32, B]`` lanes (B5); V lives in
    ``scratch`` (default: allocated for this call, 128 KiB per lane, or
    64 KiB with ``half_v``). Returns a new tensor."""
    if Xt.device.type == "cpu":
        return st.romix(Xt, half_v=half_v)
    if Xt.device.type != "cuda":
        raise ValueError(f"romix runs on cuda or cpu, not {Xt.device}")
    _check_lanes("Xt", Xt, Xt.device)
    stream = _stream(stream, Xt.device)
    with torch.cuda.stream(stream):
        out = Xt.clone()
        if scratch is None:
            scratch = torch.empty(
                scratch_words(Xt.shape[1]) // (2 if half_v else 1),
                dtype=torch.int32, device=Xt.device)
    if Xt.shape[1]:
        _romix_in_place(out, half_v, scratch, stream)
    return out


def _romix_by_blockmix(x: torch.Tensor, scratch: torch.Tensor,
                       stream: torch.cuda.Stream) -> None:
    """The ``blockmix`` tier's ROMix of ``x`` in place, as the reference's
    ``pallas`` tier runs it: 1024 B3 launches fill V (row i+1 = BlockMix of
    row i), then 1024 steps gather V's rows with ``torch.gather`` and run
    B4. V is word-major per row, ``[1024, 32, lanes]``."""
    lanes = x.shape[1]
    V = scratch[:scratch_words(lanes)].view(SCRYPT_N, ROW_WORDS, lanes)
    with torch.cuda.stream(stream):
        V[0].copy_(x)
        for i in range(SCRYPT_N - 1):
            blockmix(V[i], out=V[i + 1], stream=stream)
        blockmix(V[SCRYPT_N - 1], out=x, stream=stream)
        for _ in range(SCRYPT_N):
            j = (x[16] & (SCRYPT_N - 1)).long()  # Integerify: word 16
            vj = torch.gather(V, 0, j.view(1, 1, lanes).expand(1, ROW_WORDS,
                                                                lanes))[0]
            blockmix(x, vj, out=x, stream=stream)


def _x_view(xs: torch.Tensor, lanes: int, device) -> torch.Tensor:
    """X's word-major ``[32, lanes]`` view of the flat x scratch."""
    if (xs.device != device or xs.dtype != torch.int32
            or xs.numel() < ROW_WORDS * lanes or not xs.is_contiguous()):
        raise ValueError(f"x scratch must be a contiguous int32 tensor of "
                         f"at least {ROW_WORDS * lanes} words on {device}")
    return xs[:ROW_WORDS * lanes].view(ROW_WORDS, lanes)


def _pack_params(header19, base: int, limbs) -> np.ndarray:
    """The 28 parameter words of a search: 19 header words, the nonce
    base, the 8 target limbs (most-significant-first)."""
    out = np.zeros(28, dtype=np.uint32)
    out[:19] = np.asarray(header19, dtype=np.uint64).astype(np.uint32)
    out[19] = np.uint32(int(base) & 0xFFFFFFFF)
    out[20:28] = np.asarray(limbs, dtype=np.uint32)
    return out


def scrypt_search(header19, base: int, limbs, last: int, *, n: int,
                  k: int = 16, device, tier: str = "romix",
                  stream: torch.cuda.Stream | None = None,
                  out: torch.Tensor | None = None,
                  scratch: tuple[torch.Tensor, torch.Tensor] | None = None
                  ) -> torch.Tensor:
    """The scrypt search of the ``n`` lanes from nonce ``base`` (wrapping
    mod 2^32), lane offsets past ``last`` out of range; returns the
    ``uint32[2k+3]`` winner buffer as an int32 tensor on ``device``.

    On a CUDA device it launches on ``stream`` into ``out``; ``scratch``
    is ``(x, v)``: flat int32 tensors of at least ``32 * lanes`` and
    ``scratch_words(lanes)`` words (default: allocated for this call).
    ``tier``: ``romix`` (kernel B5), ``romix-half`` (B5 with ``half_v``)
    or ``blockmix`` (B3 and B4). On the CPU the plain version computes the
    same buffer, whatever the tier."""
    device = torch.device(device)
    if tier not in TIERS:
        raise ValueError(f"unknown scrypt tier {tier!r} (known: {TIERS})")
    if device.type == "cpu":
        return st.scrypt_search_buffer(header19, base, limbs, last, n=n, k=k,
                                       device=device)
    if device.type != "cuda":
        raise ValueError(f"scrypt_search runs on cuda or cpu, not {device}")
    if device.index is None:    # "cuda" names the current card
        device = torch.device("cuda", torch.cuda.current_device())
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lanes = max(0, min(int(n), int(last) + 1))
    params = _pack_params(header19, base, limbs)
    stream = _stream(stream, device)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        if out is None:
            out = torch.empty(winner_buffer_words(k), dtype=torch.int32,
                              device=device)
        if (out.device != device or out.dtype != torch.int32
                or out.shape != (winner_buffer_words(k),)
                or not out.is_contiguous()):
            raise ValueError("out must be a contiguous int32 tensor of 2k+3 "
                             f"words on {device}")
        if scratch is None:
            scratch = (torch.empty(ROW_WORDS * lanes, dtype=torch.int32,
                                   device=device),
                       torch.empty(scratch_words(lanes), dtype=torch.int32,
                                   device=device))
        xs, vs = scratch
        x = _x_view(xs, lanes, device)
        lib = load_library()
        _check(lib, lib.otedama_scrypt_prologue(
            params.ctypes.data, lanes, x.data_ptr(), out.data_ptr(), k,
            stream.cuda_stream), "scrypt prologue")
        if lanes:
            if tier == "blockmix":
                _romix_by_blockmix(x, vs, stream)
            else:
                _romix_in_place(x, tier == "romix-half", vs, stream)
        _check(lib, lib.otedama_scrypt_epilogue(
            params.ctypes.data, lanes, x.data_ptr(), out.data_ptr(), k,
            stream.cuda_stream), "scrypt epilogue")
    search_launches.add()
    return out


def scrypt_verify(words20: torch.Tensor, limbs: torch.Tensor, count: int, *,
                  k: int = 16,
                  scratch: tuple[torch.Tensor, torch.Tensor] | None = None,
                  stream: torch.cuda.Stream | None = None) -> torch.Tensor:
    """Validate the first ``count`` scrypt shares: ``words20`` int32
    ``[B, 20]`` header words and ``limbs`` int32 ``[B, 8]`` target limbs,
    as ``sha256_cuda.sha256d_verify`` takes them. Returns the
    ``uint32[2k+3]`` failure buffer (lane offsets of failing shares) as an
    int32 tensor on the inputs' device.

    Given CPU tensors it runs the plain version. Given CUDA tensors it
    launches the verify prologue, the ROMix kernel (B5, full V) and the
    verify epilogue on ``stream`` without synchronizing, or raises;
    ``scratch`` is ``(x, v)`` as for ``scrypt_search``, sized for
    ``count`` lanes (default: allocated for this call)."""
    check_verify_inputs(words20, limbs, count)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    device = words20.device
    if device.type == "cpu":
        return st.scrypt_verify_step(words20, limbs, count - 1, k=k)
    if device.type != "cuda":
        raise ValueError(f"scrypt_verify runs on cuda or cpu, not {device}")
    if words20.dtype != torch.int32 or limbs.dtype != torch.int32:
        raise ValueError("words20 and limbs must be int32 tensors")
    stream = _stream(stream, device)
    lib = load_library()
    with torch.cuda.device(device), torch.cuda.stream(stream):
        w = words20[:count].t().contiguous()    # word-major [20, count]
        t = limbs[:count].t().contiguous()      # [8, count]
        out = torch.empty(winner_buffer_words(k), dtype=torch.int32,
                          device=device)
        if scratch is None:
            scratch = (torch.empty(ROW_WORDS * count, dtype=torch.int32,
                                   device=device),
                       torch.empty(scratch_words(count), dtype=torch.int32,
                                   device=device))
        xs, vs = scratch
        x = _x_view(xs, count, device)
        _check(lib, lib.otedama_scrypt_verify_prologue(
            w.data_ptr(), count, x.data_ptr(), out.data_ptr(), k,
            stream.cuda_stream), "scrypt verify prologue")
        if count:
            _romix_in_place(x, False, vs, stream)
        _check(lib, lib.otedama_scrypt_verify_epilogue(
            w.data_ptr(), t.data_ptr(), count, x.data_ptr(), out.data_ptr(),
            k, stream.cuda_stream), "scrypt verify epilogue")
    verify_launches.add()
    return out


# -- the bound -----------------------------------------------------------------

SALSA_OPS = 4 * 32 * 3 + 16            # 4 double rounds x 32 (add, rot, xor) + feed-forward
BLOCKMIX_OPS = 2 * (16 + SALSA_OPS)    # two Salsa20/8 on XORed halves
SHA256_COMPRESS_OPS = 64 * 14 + 48 * 10 + 8
PBKDF2_COMPRESSIONS = 21               # 13 in the prologue, 8 in the epilogue


def romix_ops(half_v: bool = False, odd_share: float = 0.5) -> float:
    """32-bit integer operations of one lane's ROMix: fill 1024 BlockMix,
    mix 1024 x (32 XOR + BlockMix), and with ``half_v`` one more BlockMix
    for the share of mix steps whose ``j`` is odd. A funnel-shift rotate
    is one instruction."""
    mix = SCRYPT_N * (ROW_WORDS + BLOCKMIX_OPS)
    extra = SCRYPT_N * odd_share * BLOCKMIX_OPS if half_v else 0.0
    return SCRYPT_N * BLOCKMIX_OPS + mix + extra


def ops_per_hash(half_v: bool = False, odd_share: float = 0.5) -> float:
    """32-bit integer operations per scrypt hash on the search path: the
    ROMix and PBKDF2's SHA-256 compressions (a round: Sigma1 and Sigma0 as
    three rotates and a 3-way xor each, ch and maj one LOP3 each, the adds
    as IADD3s: ~14 ops; a schedule word ~10). The op count behind the
    search's ``bound_ms``."""
    return romix_ops(half_v, odd_share) + PBKDF2_COMPRESSIONS * SHA256_COMPRESS_OPS


def v_bytes_per_hash(half_v: bool = False) -> int:
    """Bytes of V that one lane's ROMix moves through device memory: the
    fill pass writes every row (every even row with ``half_v``) and each
    of the 1,024 mix steps reads one. V (128 KiB a lane) cannot stay on
    the chip at a useful lane count, so these bytes are part of the
    bound."""
    rows_written = SCRYPT_N // 2 if half_v else SCRYPT_N
    return (rows_written + SCRYPT_N) * ROW_WORDS * 4
