"""The sha256d search kernel on the card: build, binding and wrapper.

``csrc/sha256d_search.cu`` replaces the Pallas TPU kernel
``otedama_tpu/kernels/sha256_pallas.py`` ``_search_kernel``. It is built at
first use by ``cuda_build`` (nvcc for ``sm_90a``, a shared library with a
plain C entry point loaded through ``ctypes``). The job words
ride in as kernel parameters, so a launch copies nothing to the device.

``sha256d_search`` launches on a CUDA stream without synchronizing and
returns the device ``uint32[2k+3]`` winner buffer (an int32 tensor, read
back as uint32). For a CPU device it runs the plain version
(``sha256_torch.sha256d_search_buffer``); for a CUDA device it launches the
kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter, cuda_build, sha256_torch

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

SOURCE = "sha256d_search.cu"
HEADERS = ("sha256_device.cuh",)

# kernel launches through the wrapper (not the plain version's calls)
launches = LaunchCounter()

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
    lib = load_library()
    with torch.cuda.device(out.device):
        rc = lib.otedama_sha256d_search(
            jw.ctypes.data, batch, k, out.data_ptr(), stream.cuda_stream)
    if rc != 0:
        msg = lib.otedama_cuda_error_string(rc).decode()
        raise RuntimeError(f"sha256d_search launch failed: CUDA error {rc} "
                           f"({msg})")
    launches.add()
    return out


def ops_per_nonce() -> int:
    """32-bit integer operations per nonce on the kernel's hot path,
    counted over its dataflow as the hardware can issue it: a rotate or
    shift is one instruction, any 3-input logic function (ch, maj, a
    3-way xor) one LOP3, and a sum of T terms ceil((T-1)/2) IADD3s, with
    all constant terms folded into one. Values that depend on the job
    words alone are loop-invariant and cost nothing. The filter adds the
    nonce add, bswap, the running min and the compare. This is the op
    count behind ``bound_ms``.

    In the trace, ``True`` marks a nonce-dependent value and ``False`` a
    constant or job-word value."""
    n = 0

    def op(*xs):
        nonlocal n
        if any(xs):
            n += 1
        return any(xs)

    def add(*xs):
        nonlocal n
        terms = sum(xs) + (0 if all(xs) else 1)
        if any(xs):
            n += terms // 2  # == ceil((terms - 1) / 2)
        return any(xs)

    def sig(x):  # three funnel shifts (or shifts) and one LOP3
        return op(op(x), op(x), op(x))

    def rounds(s, w, count, a_until):
        # the a produced by round r is first read by round r+4's e, so in
        # the truncated compression rounds >= 57 need no a at all
        for i in range(count):
            if i >= 16:
                w[i % 16] = add(w[i % 16], sig(w[(i - 15) % 16]),
                                w[(i - 7) % 16], sig(w[(i - 2) % 16]))
            t1 = add(s[7], sig(s[4]), op(s[4], s[5], s[6]), False, w[i % 16])
            a = False
            if i < a_until:
                a = add(t1, sig(s[0]), op(s[0], s[1], s[2]))
            s = [a, s[0], s[1], s[2], add(s[3], t1), s[4], s[5], s[6]]
        return s

    s = rounds([False] * 8, [False] * 3 + [True] + [False] * 12, 64, 64)
    d = [add(False, x) for x in s]  # feed-forward of the midstate
    s = rounds([False] * 8, d + [False] * 8, 61, 57)
    add(False, s[4])  # digest word 7 = IV[7] + e
    return n + 4
