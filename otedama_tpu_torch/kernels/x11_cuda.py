"""Kernel B6, the x11 chain on the card: build, binding and wrappers.

``csrc/x11.cu`` replaces the device tier that the JAX package runs through
XLA (``otedama_tpu/kernels/x11/jnp_chain.py``: ``x11_winner_step`` for the
search, ``x11_verify_step`` for share validation; there is no Pallas
kernel for x11). It is built at first use by ``cuda_build`` (nvcc for
``sm_90a``, a shared library with plain C entry points loaded through
``ctypes``) and shares the winner-buffer code of ``sha256_device.cuh``
with B1 and B2.

``x11_search`` and ``x11_verify`` launch on a CUDA stream without
synchronizing and return the device ``uint32[2k+3]`` buffer (an int32
tensor; ``sha256_cuda.unpack_winner_buffer`` after the read-back), with
lane offsets in its first k words. Given the CPU they run the plain
versions (``x11_torch.x11_search_buffer``, ``x11_torch.x11_verify_step``);
given CUDA they launch the kernel or raise — they never fall back.

The kernel reads its large tables (groestl's eight, the AES T-table, jh's
IV and round constants, simd's twist, NTT roots and final-block words,
cubehash's IV) from one block of 64-bit words that ``table_block`` builds
from the port's host tier (through ``x11_torch``) and that each device
keeps (``device_tables``).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter, cuda_build, x11_torch
from otedama_tpu_torch.kernels.sha256_cuda import check_verify_inputs, \
    winner_buffer_words

M32 = 0xFFFFFFFF

SOURCE = "x11.cu"
HEADERS = ("sha256_device.cuh",)

# the search kernel's job words: the prefix's 19 big-endian words, the nonce
# base, the 8 target limbs, the packed shavite counter order
JOB_WORDS = 29

# threads a block (csrc/x11.cu kX11Threads): one lane a thread
THREADS = 128

# kernel launches through the wrappers (not the plain versions' calls)
search_launches = LaunchCounter()   # B6 search
verify_launches = LaunchCounter()   # B6 verify

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}

# offsets of the table block (csrc/x11.cu, k*Off)
TABLE_LAYOUT = (("groestl", 2048), ("aes", 256), ("jh_iv", 16),
                ("jh_c", 168), ("twist", 256), ("w_final", 256),
                ("cube_iv", 32), ("omega_pow", 256))
TABLE_WORDS = sum(n for _, n in TABLE_LAYOUT)


def table_block() -> np.ndarray:
    """The kernel's tables as one uint64 array, in ``TABLE_LAYOUT`` order."""
    iv, consts = x11_torch.jh_tables()
    simd = x11_torch.simd_tables()
    parts = {
        "groestl": x11_torch.groestl_tables().reshape(-1),
        "aes": x11_torch.aes_table(),
        "jh_iv": iv,
        "jh_c": consts.reshape(-1),
        "twist": simd["twist"],
        "w_final": simd["w_final"],
        "cube_iv": x11_torch.cubehash_iv(),
        "omega_pow": simd["omega_pow"],
    }
    out = np.concatenate([np.asarray(parts[name]).astype(np.uint64)
                          for name, _ in TABLE_LAYOUT])
    assert out.shape == (TABLE_WORDS,)
    return out


_tables: dict[int, torch.Tensor] = {}


def device_tables(device: torch.device) -> torch.Tensor:
    """The table block on ``device``, copied there once."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    t = _tables.get(idx)
    if t is None:
        with _lib_lock:
            t = _tables.get(idx)
            if t is None:
                host = torch.from_numpy(table_block().view(np.int64))
                t = host.to(torch.device("cuda", idx))
                torch.cuda.synchronize(idx)
                _tables[idx] = t
    return t


def pack_cnt_order(order) -> int:
    """The shavite counter order ``[4][4]`` (``x11_torch.cnt_variant_order``)
    as the kernel's argument: entry (i, j) in bits 2 * (4i + j)."""
    v = 0
    for i in range(4):
        for j in range(4):
            v |= (int(order[i][j]) & 3) << (2 * (4 * i + j))
    return v


def pack_job(prefix76: bytes, base: int, limbs8, cnt_order) -> np.ndarray:
    if len(prefix76) != 76:
        raise ValueError(f"need 76 header bytes, got {len(prefix76)}")
    out = np.zeros((JOB_WORDS,), dtype=np.uint32)
    out[:19] = np.frombuffer(prefix76, dtype=">u4")
    out[19] = base & M32
    out[20:28] = np.asarray(limbs8, dtype=np.uint64).astype(np.uint32)
    out[28] = pack_cnt_order(cnt_order)
    return out


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library. Raises
    if the toolkit is missing or the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = cuda_build.build(SOURCE, HEADERS)
        build_info.update(info)
        lib.otedama_x11_search.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.otedama_x11_search.restype = ctypes.c_int
        lib.otedama_x11_verify.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_ulonglong,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        lib.otedama_x11_verify.restype = ctypes.c_int
        lib.otedama_x11_error_string.argtypes = [ctypes.c_int]
        lib.otedama_x11_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _out_for(k: int, device, stream, out):
    if out is None:
        with torch.cuda.stream(stream):
            out = torch.empty(winner_buffer_words(k), dtype=torch.int32,
                              device=device)
    if (out.device != device or out.dtype != torch.int32
            or out.shape != (winner_buffer_words(k),)
            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous int32 tensor of 2k+3 "
                         "words on the launch's device")
    return out


def x11_search(prefix76: bytes, base: int, last: int, limbs8, *, batch: int,
               k: int, device, cnt_order=None,
               stream: torch.cuda.Stream | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Search ``batch`` lanes from nonce word ``base`` (wrapping mod 2^32)
    in ONE launch of B6; lanes past offset ``last`` (-1: none) take no
    part. Returns the ``uint32[2k+3]`` winner buffer (lane offsets) as an
    int32 tensor on ``device``. ``cnt_order``: the shavite counter order
    (default: the active variant of the port's host tier).

    On a CUDA device the kernel runs on ``stream`` (default: the device's
    current stream) into ``out`` (default: a new tensor) and nothing waits
    for it. On the CPU the plain version computes the same buffer."""
    device = torch.device(device)
    order = cnt_order or x11_torch.cnt_variant_order()
    if device.type == "cpu":
        return x11_torch.x11_search_buffer(prefix76, base, last, limbs8,
                                           batch=batch, k=k, device=device,
                                           cnt_order=order)
    if device.type != "cuda":
        raise ValueError(f"x11_search runs on cuda or cpu, not {device}")
    if not 0 <= batch <= 1 << 32:
        raise ValueError(f"batch {batch} outside [0, 2^32]")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if stream is None:
        stream = torch.cuda.current_stream(device)
    out = _out_for(k, device, stream, out)
    job = pack_job(prefix76, base, limbs8, order)
    lanes = max(0, min(batch, last + 1))
    lib = load_library()
    tables = device_tables(device)
    with torch.cuda.device(device):
        rc = lib.otedama_x11_search(job.ctypes.data, lanes, k, out.data_ptr(),
                                    tables.data_ptr(), stream.cuda_stream)
    if rc != 0:
        msg = lib.otedama_x11_error_string(rc).decode()
        raise RuntimeError(f"x11_search launch failed: CUDA error {rc} ({msg})")
    search_launches.add()
    return out


def x11_verify(words20: torch.Tensor, limbs: torch.Tensor, count: int, *,
               k: int, cnt_order=None,
               stream: torch.cuda.Stream | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Validate the first ``count`` shares in ONE launch of B6's verify
    kernel: ``words20`` int32 ``[B, 20]`` (each header's big-endian
    words), ``limbs`` int32 ``[B, 8]`` (each share's target limbs,
    most-significant-first). Returns the ``uint32[2k+3]`` failure buffer
    (failing lane offsets in lane order, their top limbs, the true failure
    count — past ``k`` an overflow — and the min top limb) as an int32
    tensor on the inputs' device.

    Given CPU tensors it runs the plain version. Given CUDA tensors
    (contiguous int32) it launches on ``stream`` (default: the current
    stream) into ``out`` (default: a new tensor) without synchronizing,
    or raises."""
    check_verify_inputs(words20, limbs, count)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    order = cnt_order or x11_torch.cnt_variant_order()
    device = words20.device
    if device.type == "cpu":
        buf = x11_torch.x11_verify_step(words20, limbs, count - 1, k=k,
                                        cnt_order=order)
        return buf if out is None else out.copy_(buf)
    if device.type != "cuda":
        raise ValueError(f"x11_verify runs on cuda or cpu, not {device}")
    for name, x in (("words20", words20), ("limbs", limbs)):
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             f"(dtype {x.dtype}, contiguous "
                             f"{x.is_contiguous()})")
    if stream is None:
        stream = torch.cuda.current_stream(device)
    out = _out_for(k, device, stream, out)
    lib = load_library()
    tables = device_tables(device)
    with torch.cuda.device(device):
        rc = lib.otedama_x11_verify(
            words20.data_ptr(), limbs.data_ptr(), count, k, out.data_ptr(),
            pack_cnt_order(order), tables.data_ptr(), stream.cuda_stream)
    if rc != 0:
        msg = lib.otedama_x11_error_string(rc).decode()
        raise RuntimeError(f"x11_verify launch failed: CUDA error {rc} ({msg})")
    verify_launches.add()
    return out


# -- the bound ------------------------------------------------------------------

# the chain's stages in the order of csrc/x11.cu's counting build (X11_COUNT
# = 1..11; 0 is the frame alone)
STAGES = ("blake512", "bmw512", "groestl512", "skein512", "jh512",
          "keccak512", "luffa512", "cubehash512", "shavite512", "simd512",
          "echo512")

# 32-bit integer instructions an SM runs a clock, thread by thread: the
# ALU pipe (IADD3, LOP3, SHF, PRMT, ...) and the FMA pipe (IMAD in all its
# forms) take 64 each, 128 together
ALU_LANES_PER_SM = 64
INT_LANES_PER_SM = 128
# shared-memory words an SM reads a clock: 32 banks of 4 bytes
SMEM_WORDS_PER_SM = 32


def _lds_words(op: str) -> int:
    """32-bit words one lane reads in a shared-memory load (LDS, LDS.64,
    LDS.128, LDS.U8, ...)."""
    return 4 if ".128" in op else 2 if ".64" in op else 1


def _stage_counts(stage: int) -> dict:
    info = cuda_build.cubin(SOURCE, HEADERS, (f"X11_COUNT={stage}",))
    code = cuda_build.sass_functions(info["library"], "x11_count_kernel")
    (fn, code), = code.items()
    loop = cuda_build.hot_loop(code)
    if loop:
        raise RuntimeError(
            f"the counting build of stage {stage} still has a loop of "
            f"{len(loop)} instructions at {loop[0][0]:#x} (its SASS is not "
            f"what a lane executes): {[op for _, op, _ in loop[:24]]}")
    counts = cuda_build.pipe_counts(code)
    counts["smem_words"] = sum(_lds_words(op) for _, op, _ in code
                               if op.startswith("LDS"))
    counts["seconds"] = info.get("seconds", 0.0)
    return counts


def chain_instructions() -> dict[str, dict]:
    """The instructions one lane of B6 executes in each stage of the chain,
    from the SASS of ``csrc/x11.cu``'s counting build (``-DX11_COUNT=S``:
    stage S alone, every round loop unrolled, every stage inlined; the
    twelve builds run at once): by pipe (``alu``, ``fma``), in all
    (``total``), and the shared-memory words its table lookups read
    (``smem_words``), each less the frame's (stage 0: the load and store
    around the stage), and its build's ``seconds``. ``"chain"`` holds the
    sums (its ``seconds``: the frame's build). Needs ``nvcc`` and
    ``cuobjdump``, not a card."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(STAGES) + 1) as pool:
        counts = list(pool.map(_stage_counts, range(len(STAGES) + 1)))
    frame, keys = counts[0], ("total", "alu", "fma", "smem_words")
    out = {name: {k: c[k] - frame[k] for k in keys}
           for name, c in zip(STAGES, counts[1:])}
    out["chain"] = {k: sum(out[name][k] for name in STAGES) for k in keys}
    for name, c in zip(("frame", *STAGES), counts):
        out.get(name, out["chain"])["seconds"] = c["seconds"]
    return out


def bound_ms(lanes: int, sms: int, clock_mhz: float, chain: dict,
             verify: bool = False,
             hbm_bytes_per_s: float = 3.35e12) -> dict[str, float]:
    """The least times the card could take for ``lanes`` lanes of B6, in
    ms, by what could bound it, given ``chain`` (``chain_instructions()
    ["chain"]``): the integer instructions over both integer pipes
    (``"operations"``, as the bounds of B1 to B5 count them: the
    compiler's split between the pipes is not the work's); the table
    reads over the shared-memory banks (``"shared-memory reads"``); the
    bytes read once over the memory's rate (``"bytes"``: a verify row's
    80 header and 32 limb bytes; a search reads none a lane). Beside
    them, not a bound: the ALU pipe alone at the compiler's split
    (``"ALU pipe as compiled"``)."""
    per_sm_clock = lanes / (sms * clock_mhz * 1e6) * 1e3
    return {
        "operations": per_sm_clock * (chain["alu"] + chain["fma"])
        / INT_LANES_PER_SM,
        "shared-memory reads": per_sm_clock * chain["smem_words"]
        / SMEM_WORDS_PER_SM,
        "bytes": (112 * lanes if verify else 0) / hbm_bytes_per_s * 1e3,
        "ALU pipe as compiled": per_sm_clock * chain["alu"]
        / ALU_LANES_PER_SM,
    }
