"""The sha256d kernels on the card: build, binding and wrappers.

``csrc/sha256d.cu`` replaces the Pallas TPU kernels of
``otedama_tpu/kernels/sha256_pallas.py``: ``search_kernel`` its
``_search_kernel`` (B1), ``verify_kernel`` its ``_verify_kernel`` (B2,
share validation). The library is built at first use by ``cuda_build``
(nvcc for ``sm_90a``, a shared library with plain C entry points loaded
through ``ctypes``). The
search's job words, and what ``search_params`` computes from them once a
launch (the first compression up to its first nonce-dependent operation),
ride in as kernel parameters, so a search launch copies nothing to the
device.

``sha256d_search`` and ``sha256d_verify`` launch on a CUDA stream without
synchronizing and return the device ``uint32[2k+3]`` buffer (an int32
tensor, read back as uint32). A verify call is one kernel launch on the
caller's row-major inputs, into an ``out=`` buffer when the caller keeps
one. Given the CPU they run the plain versions
(``sha256_torch.sha256d_search_buffer``, ``sha256_torch.sha256d_verify_step``);
given CUDA they launch the kernel or raise — they never fall back.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter, cuda_build, sha256_torch
from otedama_tpu_torch.utils.sha256_host import SHA256_K

_M32 = 0xFFFFFFFF

# job_words layout (uint32[22]), the same encoding as the TPU kernel's:
#   [0:8]   midstate of header[0:64]
#   [8:11]  header words 16..18 (merkle tail, ntime, nbits)
#   [11]    nonce base of the launch
#   [12:20] target limbs, most-significant-first (limb 0 is the filter)
#   [20]    last in-range launch offset (count-1); lanes past it are
#           excluded from winners AND the min top limb
#   [21]    empty flag: 1 = no lane of the launch is in range
JOB_WORDS = 22

# default winner-table depth: at real difficulty a 2^31 launch sees ~0-1
# winners, so 16 slots overflow only at test-easy targets
K_WINNERS = 16

# nonces a block of the search kernel takes a step: one a thread
SEARCH_BLOCK_NONCES = 256

SOURCE = "sha256d.cu"
HEADERS = ("sha256_device.cuh",)

# kernel launches through the wrappers (not the plain versions' calls)
launches = LaunchCounter()          # B1: sha256d_search
verify_launches = LaunchCounter()   # B2: sha256d_verify

_lib = None
_lib_lock = threading.Lock()
# what the last build reported: seconds, library path, ptxas register use
build_info: dict = {}


def pack_job_words(midstate, tail, nonce_base, target_limbs,
                   count: int | None = None) -> np.ndarray:
    """``count`` = in-range lanes of the launch; None means the whole
    launch is in range, 0 means none of it is."""
    out = np.zeros((JOB_WORDS,), dtype=np.uint32)
    out[0:8] = np.asarray(midstate, dtype=np.uint64).astype(np.uint32)
    out[8:11] = np.asarray(tail, dtype=np.uint64).astype(np.uint32)
    out[11] = np.uint32(nonce_base & _M32)
    out[12:20] = np.asarray(target_limbs, dtype=np.uint32)
    if count is None:
        out[20] = np.uint32(_M32)
    elif count <= 0:
        out[21] = np.uint32(1)
    else:
        out[20] = np.uint32((count - 1) & _M32)
    return out


# what search_params hoists after the 22 job words (csrc/sha256d.cu
# `Hoisted`): the state after round 2, round 3's a and e less the nonce,
# K[i] + W[i] for i = 4..17, the job-only sums of W18..W33, and the three
# multipliers that put the kernel's adds and shifts on the FMA pipe
HOISTED_WORDS = 43


def search_params(job_words) -> np.ndarray:
    """The search kernel's launch parameters: the 22 job words, then what
    depends on them alone, computed here once a launch so that the
    kernel's loop starts at the first operation that depends on the nonce
    (W3): rounds 0..2 of the first compression from the midstate, round 3
    but for its two adds of the nonce, K[i] + W[i] of the constant words
    W4..W17, and for W18..W33 the sum of their job-only terms."""
    st = sha256_torch   # its round functions take Python ints as well
    jw = [int(x) for x in np.asarray(job_words, dtype=np.uint32)]
    if len(jw) != JOB_WORDS:
        raise ValueError(f"job_words must be uint32[{JOB_WORDS}], got {len(jw)}")
    # W[i] of the first compression but W3 (the nonce): tail, padding, length
    W = jw[8:11] + [None, 0x80000000] + [0] * 10 + [640]
    W.append((st._small_sigma0(W[1]) + W[0]) & _M32)                    # W16
    W.append((st._small_sigma1(W[15]) + st._small_sigma0(W[2]) + W[1]) & _M32)
    a, b, c, d, e, f, g, h = jw[0:8]
    for i in range(4):
        t1 = (h + st._big_sigma1(e) + st._ch(e, f, g) + SHA256_K[i]
              + (W[i] or 0)) & _M32
        t2 = (st._big_sigma0(a) + st._maj(a, b, c)) & _M32
        if i == 3:          # W3 is the nonce: both adds of it stay
            s3 = [a, b, c, d, e, f, g, h]
            a4, e4 = (t1 + t2) & _M32, (d + t1) & _M32
            break
        a, b, c, d, e, f, g, h = (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    kw = [(SHA256_K[i] + W[i]) & _M32 for i in range(4, 18)]
    wc = []
    for i in range(18, 34):     # the terms of W[i] whose word is job-only
        terms = [(st._small_sigma1, i - 2), (None, i - 7),
                 (st._small_sigma0, i - 15), (None, i - 16)]
        wc.append(sum((fn(W[j]) if fn else W[j]) for fn, j in terms
                      if j != 3 and j < 18) & _M32)
    out = jw + s3 + [a4, e4] + kw + wc + [1, 1 << 29, 1 << 22]
    assert len(out) == JOB_WORDS + HOISTED_WORDS
    return np.asarray(out, dtype=np.uint32)


def winner_buffer_words(k: int) -> int:
    """One launch's output: k nonces, k top limbs, [n_winners, 0, min_h0]."""
    return 2 * k + 3


def unpack_winner_buffer(buf, k: int):
    """Split one read-back winner buffer (uint32[2k+3]) into
    ``(win_nonce[k], win_limb[k], n_winners, min_hash_hi)``. ``n_winners``
    past ``k`` means the table overflowed."""
    buf = np.asarray(buf).view(np.uint32)
    return buf[:k], buf[k:2 * k], int(buf[2 * k]), int(buf[2 * k + 2])


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library. Raises
    if the toolkit is missing or the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = cuda_build.build(SOURCE, HEADERS)
        build_info.update(info)
        lib.otedama_sha256d_search.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.otedama_sha256d_search.restype = ctypes.c_int
        lib.otedama_sha256d_verify.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.otedama_sha256d_verify.restype = ctypes.c_int
        lib.otedama_empty_launch.argtypes = [ctypes.c_void_p]
        lib.otedama_empty_launch.restype = ctypes.c_int
        lib.otedama_cuda_error_string.argtypes = [ctypes.c_int]
        lib.otedama_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def sha256d_search(job_words, *, batch: int, k: int = K_WINNERS, device,
                   stream: torch.cuda.Stream | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Search ``batch`` lanes from nonce base ``job_words[11]`` in ONE
    launch; returns the ``uint32[2k+3]`` winner buffer as an int32 tensor
    on ``device`` (``unpack_winner_buffer`` after reading it back).

    On a CUDA device the kernel runs on ``stream`` (default: the device's
    current stream) into ``out`` (default: a new tensor) and nothing waits
    for it. On the CPU the plain version computes the same buffer."""
    device = torch.device(device)
    if device.type == "cpu":
        return sha256_torch.sha256d_search_buffer(
            job_words, batch=batch, k=k, device=device)
    if device.type != "cuda":
        raise ValueError(f"sha256d_search runs on cuda or cpu, not {device}")
    jw = np.ascontiguousarray(job_words, dtype=np.uint32)
    if jw.shape != (JOB_WORDS,):
        raise ValueError(f"job_words must be uint32[{JOB_WORDS}], got {jw.shape}")
    if not 0 <= batch <= 1 << 32:
        raise ValueError(f"batch {batch} outside [0, 2^32]")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if stream is None:
        stream = torch.cuda.current_stream(device)
    if out is None:
        with torch.cuda.stream(stream):
            out = torch.empty(winner_buffer_words(k), dtype=torch.int32,
                              device=device)
    if (out.device != stream.device or out.dtype != torch.int32
            or out.shape != (winner_buffer_words(k),)
            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous int32 tensor of 2k+3 "
                         "words on the stream's device")
    params = search_params(jw)
    lib = load_library()
    with torch.cuda.device(out.device):
        rc = lib.otedama_sha256d_search(
            params.ctypes.data, batch, k, out.data_ptr(), stream.cuda_stream)
    if rc != 0:
        msg = lib.otedama_cuda_error_string(rc).decode()
        raise RuntimeError(f"sha256d_search launch failed: CUDA error {rc} "
                           f"({msg})")
    launches.add()
    return out


def check_verify_inputs(words20: torch.Tensor, limbs: torch.Tensor,
                        count: int) -> None:
    """Shapes and devices a verify wrapper takes: ``[B, 20]`` and
    ``[B, 8]`` on one device, ``0 <= count <= B``."""
    if (words20.dim() != 2 or words20.shape[1] != 20 or limbs.dim() != 2
            or limbs.shape[1] != 8 or limbs.shape[0] != words20.shape[0]):
        raise ValueError(f"need words20 [B, 20] and limbs [B, 8], got "
                         f"{tuple(words20.shape)} and {tuple(limbs.shape)}")
    if words20.device != limbs.device:
        raise ValueError(f"words20 on {words20.device}, limbs on {limbs.device}")
    if not 0 <= count <= words20.shape[0]:
        raise ValueError(f"count {count} outside [0, {words20.shape[0]}]")


# the verify kernel's 3-word workspace (csrc/sha256d.cu), one for each
# stream that launches it: launches on one stream run in order, so they
# can share one; all zero between launches
VERIFY_WORKSPACE_WORDS = 3
_workspaces: dict[int, torch.Tensor] = {}


def _verify_workspace(stream: torch.cuda.Stream) -> torch.Tensor:
    ws = _workspaces.get(stream.cuda_stream)
    if ws is None:
        with _lib_lock:
            ws = _workspaces.get(stream.cuda_stream)
            if ws is None:
                with torch.cuda.stream(stream):
                    ws = torch.zeros(VERIFY_WORKSPACE_WORDS, dtype=torch.int32,
                                     device=stream.device)
                _workspaces[stream.cuda_stream] = ws
    return ws


def check_verify_layout(words20: torch.Tensor, limbs: torch.Tensor) -> None:
    """What the verify kernel reads on the card: int32 rows, contiguous,
    each tensor starting on a 16-byte boundary (a ``words20[off:]`` view
    does; other views may not)."""
    for name, x in (("words20", words20), ("limbs", limbs)):
        if x.dtype != torch.int32 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             f"starting on a 16-byte boundary (dtype "
                             f"{x.dtype}, contiguous {x.is_contiguous()}, "
                             f"address {x.data_ptr():#x})")


def sha256d_verify(words20: torch.Tensor, limbs: torch.Tensor, count: int, *,
                   k: int = K_WINNERS,
                   stream: torch.cuda.Stream | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Validate the first ``count`` shares in ONE launch (kernel B2):
    ``words20`` int32 ``[B, 20]`` (the uint32 bit patterns of each header's
    big-endian words, ``sha256_torch.headers_to_words``), ``limbs`` int32
    ``[B, 8]`` (each share's target limbs, most-significant-first). Rows
    past ``count`` take no part. Returns the ``uint32[2k+3]`` failure
    buffer as an int32 tensor on the inputs' device (``unpack_winner_buffer``
    after reading it back: failing lane offsets, their top limbs, the true
    failure count — past ``k`` an overflow — and the min top limb).

    Given CPU tensors it runs the plain version. Given CUDA tensors (row
    major, contiguous, 16-byte aligned: ``check_verify_layout``) it
    launches the one kernel on ``stream`` (default: the current stream)
    into ``out`` (default: a new tensor) without synchronizing, or
    raises; it allocates nothing else but, once per stream, the kernel's
    workspace."""
    check_verify_inputs(words20, limbs, count)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    device = words20.device
    if device.type == "cpu":
        buf = sha256_torch.sha256d_verify_step(words20, limbs, count - 1, k=k)
        return buf if out is None else out.copy_(buf)
    if device.type != "cuda":
        raise ValueError(f"sha256d_verify runs on cuda or cpu, not {device}")
    check_verify_layout(words20, limbs)
    if stream is None:
        stream = torch.cuda.current_stream(device)
    if out is None:
        with torch.cuda.stream(stream):
            out = torch.empty(winner_buffer_words(k), dtype=torch.int32,
                              device=device)
    if (out.device != device or out.dtype != torch.int32
            or out.shape != (winner_buffer_words(k),)
            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous int32 tensor of 2k+3 "
                         "words on the inputs' device")
    ws = _verify_workspace(stream)
    lib = load_library()
    # entering the device costs microseconds a call: only when it is not
    # the current one already
    with (contextlib.nullcontext() if device.index == torch.cuda.current_device()
          else torch.cuda.device(device)):
        rc = lib.otedama_sha256d_verify(
            words20.data_ptr(), limbs.data_ptr(), count, k, out.data_ptr(),
            ws.data_ptr(), stream.cuda_stream)
    if rc != 0:
        # a refused launch never ran; zero the workspace all the same, so
        # that no launch after it can start from a dirty one
        with torch.cuda.stream(stream):
            ws.zero_()
        msg = lib.otedama_cuda_error_string(rc).decode()
        raise RuntimeError(f"sha256d_verify launch failed: CUDA error {rc} "
                           f"({msg})")
    verify_launches.add()
    return out


def empty_launch(stream: torch.cuda.Stream) -> None:
    """Launch the library's empty kernel on ``stream``: the floor under
    any one-launch call's time (not counted: it computes nothing)."""
    lib = load_library()
    rc = lib.otedama_empty_launch(stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")


class _OpTrace:
    """Counts 32-bit integer operations over a hash's dataflow as the
    hardware can issue it: a rotate or shift is one instruction, any
    3-input logic function (ch, maj, a 3-way xor) one LOP3, and a sum of T
    terms ceil((T-1)/2) IADD3s, with all constant terms folded into one.
    A traced value is ``True`` when it varies per lane and ``False`` when
    it is a constant or a launch-invariant value, which costs nothing."""

    def __init__(self) -> None:
        self.n = 0

    def op(self, *xs) -> bool:
        if any(xs):
            self.n += 1
        return any(xs)

    def add(self, *xs) -> bool:
        terms = sum(xs) + (0 if all(xs) else 1)
        if any(xs):
            self.n += terms // 2  # == ceil((terms - 1) / 2)
        return any(xs)

    def sig(self, x) -> bool:  # three funnel shifts (or shifts) and one LOP3
        return self.op(self.op(x), self.op(x), self.op(x))

    def rounds(self, s, w, count: int, a_until: int = 64) -> list:
        """``count`` rounds of one compression; the a produced by round r
        is first read by round r+4's e, so a truncated compression can stop
        computing a at ``a_until``."""
        for i in range(count):
            if i >= 16:
                w[i % 16] = self.add(w[i % 16], self.sig(w[(i - 15) % 16]),
                                     w[(i - 7) % 16], self.sig(w[(i - 2) % 16]))
            t1 = self.add(s[7], self.sig(s[4]), self.op(s[4], s[5], s[6]),
                          False, w[i % 16])
            a = False
            if i < a_until:
                a = self.add(t1, self.sig(s[0]), self.op(s[0], s[1], s[2]))
            s = [a, s[0], s[1], s[2], self.add(s[3], t1), s[4], s[5], s[6]]
        return s


def ops_per_nonce() -> int:
    """32-bit integer operations per nonce on the search kernel's hot path
    (``_OpTrace``): values that depend on the job words alone are
    loop-invariant and cost nothing, and the truncated second compression
    stops at digest word 7. The filter adds the nonce add, bswap, the
    running min and the compare. This is the op count behind B1's
    ``bound_ms``."""
    t = _OpTrace()
    s = t.rounds([False] * 8, [False] * 3 + [True] + [False] * 12, 64)
    d = [t.add(False, x) for x in s]  # feed-forward of the midstate
    s = t.rounds([False] * 8, d + [False] * 8, 61, 57)
    t.add(False, s[4])  # digest word 7 = IV[7] + e
    return t.n + 4


def verify_ops_per_share() -> int:
    """32-bit integer operations per share of the verify kernel (B2),
    counted as ``ops_per_nonce`` counts them: three whole compressions
    (header block 1 from the IV, header block 2 with its constant padding
    words, the digest block from the IV), their feed-forwards, then 8
    bswaps, a compare and a select per limb, and the min. This is the op
    count behind B2's ``bound_ms``."""
    t = _OpTrace()
    s1 = [t.add(False, x) for x in t.rounds([False] * 8, [True] * 16, 64)]
    s2 = t.rounds(list(s1), [True] * 4 + [False] * 12, 64)
    d = [t.add(a, b) for a, b in zip(s1, s2)]
    s3 = t.rounds([False] * 8, d + [False] * 8, 64)
    for x in s3:
        t.add(False, x)
    return t.n + 8 + 2 * 8 + 1


def verify_bytes_per_share() -> int:
    """Bytes one share moves: its 20 header words and 8 target limbs, read
    once (the 2k+3-word buffer is per launch)."""
    return (20 + 8) * 4
