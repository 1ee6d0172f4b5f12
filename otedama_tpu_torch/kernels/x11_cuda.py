"""Kernel B6, the x11 chain on the card: build, binding and wrappers.

``csrc/x11.cu`` replaces the device tier that the JAX package runs through
XLA (``otedama_tpu/kernels/x11/jnp_chain.py``: ``x11_winner_step`` for the
search, ``x11_verify_step`` for share validation; there is no Pallas
kernel for x11). It is built at first use by ``cuda_build`` (nvcc for
``sm_90a``, a shared library with plain C entry points loaded through
``ctypes``) and shares the winner-buffer code of ``sha256_device.cuh``
with B1 and B2.

B6 is a kernel a stage. ``x11_search`` and ``x11_verify`` launch, on a
CUDA stream and without synchronizing, the buffer's init, then for each
chunk of ``chunk_plan`` the eleven stage kernels over the chunk's lanes
(their 64-byte values in a state buffer of ``state_words(lanes)`` words,
small enough to stay in the card's L2: the caller's ``state=``, as the
scrypt kernels take ``scratch=``, or one allocated for the call), then
the finalize; they return the device ``uint32[2k+3]`` buffer (an int32
tensor; ``sha256_cuda.unpack_winner_buffer`` after the read-back), with
lane offsets in its first k words. One call is one B6 launch in the
launch counters, and 2 + 11 x chunks kernel launches on the card. Given
the CPU they run the plain versions (``x11_torch.x11_search_buffer``,
``x11_torch.x11_verify_step``); given CUDA they launch the kernels or
raise — they never fall back.

The kernels read their tables (groestl's and AES's T-tables replicated
across the shared-memory banks, jh's IV and round constants, cubehash's
IV, simd's NTT constants, twist and final-block words) from one block of
32-bit words that ``table_block`` builds from the port's host tier
(through ``x11_torch``) and that each device keeps (``device_tables``).
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

# threads a block (csrc/x11.cu kThreads, kTabThreads): a thread a lane in
# the stage kernels, 8 a lane in simd's (kSimdGroup), and the table stages
# (groestl, shavite, echo) one 512-thread block an SM
THREADS = 128
TABLE_THREADS = 512
SIMD_GROUP = 8
# lanes a chunk: the state of 2^19 lanes is 32 MiB, under the card's 50 MB
# L2, so the stages pass it on without a round trip to HBM
CHUNK = 1 << 19
# a table entry's stride in shared memory (csrc/x11.cu kRowBytes): entry x
# of table t at byte t * 32768 + x * ROW_BYTES + its copy's offset
ROW_BYTES = 128
GROESTL_COPIES = 16     # a 64-bit entry a bank pair: lane mod 16
AES_COPIES = 32         # a 32-bit entry a bank: lane mod 32

# B6 launches through the wrappers (not the plain versions' calls): a
# search or a verify call is one, whatever its chunks (2 + 11 x chunks
# kernel launches on the card)
search_launches = LaunchCounter()   # B6 search
verify_launches = LaunchCounter()   # B6 verify

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}

# the table block, in 32-bit words (csrc/x11.cu, k*Off)
TABLE_LAYOUT = (("groestl", 4 * 256 * GROESTL_COPIES * 2),
                ("aes", 4 * 256 * AES_COPIES), ("jh_iv", 32), ("jh_c", 336),
                ("cube_iv", 32), ("simd_c", 512), ("twist", 256),
                ("w_final", 256))
TABLE_WORDS = sum(n for _, n in TABLE_LAYOUT)


def table_offsets() -> dict[str, int]:
    out, at = {}, 0
    for name, n in TABLE_LAYOUT:
        out[name] = at
        at += n
    return out


def _u32(a) -> np.ndarray:
    """64-bit words as their little-endian 32-bit halves (low first)."""
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint64)
                                .astype("<u8")).view("<u4").astype(np.uint32)


def table_block() -> np.ndarray:
    """The kernels' tables as one uint32 array, in ``TABLE_LAYOUT`` order:

    - ``groestl``: ``[4][256][16]`` 64-bit entries, table t (t < 4) of
      ``x11_torch.groestl_tables`` in each of 16 copies (tables 4-7 are
      tables 0-3 rotated by 32 bits: the kernel swaps the halves);
    - ``aes``: ``[4][256][32]``, T0 of ``x11_torch.aes_table`` rotated
      left by 8t bits (table t) in each of 32 copies;
    - ``jh_iv``, ``jh_c``: ``x11_torch.jh_tables``, 64-bit words;
    - ``cube_iv``: cubehash's IV;
    - ``simd_c``: ``[64][8]``, entry (n, j) = 41^(nj) mod 257;
    - ``twist``, ``w_final``: ``x11_torch.simd_tables``."""
    gro = x11_torch.groestl_tables()[:4]
    t0 = x11_torch.aes_table().astype(np.uint64)
    aes = np.stack([((t0 << (8 * t)) | (t0 >> (32 - 8 * t))) & M32
                    for t in range(4)])
    iv, consts = x11_torch.jh_tables()
    simd = x11_torch.simd_tables()
    omega = simd["omega_pow"]
    parts = {
        "groestl": _u32(np.repeat(gro[:, :, None], GROESTL_COPIES, 2)),
        "aes": np.repeat(aes[:, :, None], AES_COPIES, 2),
        "jh_iv": _u32(iv),
        "jh_c": _u32(consts),
        "cube_iv": x11_torch.cubehash_iv(),
        "simd_c": np.array([[omega[(n * j) % 256] for j in range(8)]
                            for n in range(64)]),
        "twist": simd["twist"],
        "w_final": simd["w_final"],
    }
    out = np.concatenate([np.asarray(parts[name]).reshape(-1).astype(np.uint32)
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
                host = torch.from_numpy(table_block().view(np.int32))
                t = host.to(torch.device("cuda", idx))
                torch.cuda.synchronize(idx)
                _tables[idx] = t
    return t


def chunk_plan(lanes: int, chunk: int = CHUNK) -> list[tuple[int, int]]:
    """The chunks a launch of ``lanes`` lanes runs, in order: (first lane
    offset, lanes), covering ``[0, lanes)`` exactly, the last one ragged."""
    if not 0 <= lanes <= 1 << 32 or chunk < 1:
        raise ValueError(f"lanes {lanes} outside [0, 2^32] or chunk {chunk}")
    return [(first, min(chunk, lanes - first))
            for first in range(0, lanes, chunk)]


def state_words(lanes: int) -> int:
    """The int64 words of the state buffer a call of ``lanes`` lanes needs:
    eight a lane of its largest chunk (32 MiB from ``CHUNK`` lanes on)."""
    return 8 * max(1, min(lanes, CHUNK))


def _state_for(state, lanes: int, device, stream) -> torch.Tensor:
    """``state``, checked, or a new one for this call on ``stream``. Calls
    that share a state must enqueue one after the other: the stages of one
    chunk pass their values through it."""
    if state is None:
        with torch.cuda.stream(stream):
            return torch.empty(state_words(lanes), dtype=torch.int64,
                               device=device)
    if (state.device != device or state.dtype != torch.int64
            or not state.is_contiguous()
            or state.numel() < state_words(lanes)):
        raise ValueError(f"state must be a contiguous int64 tensor of at "
                         f"least {state_words(lanes)} words on {device}")
    return state


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


_P, _U, _ULL, _I = ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int
_SIGNATURES = {
    "otedama_x11_begin": [_P, _I, _P],
    "otedama_x11_end": [_P, _I, _P],
    "otedama_x11_search_chunk": [_P, _ULL, _ULL, _I, _P, _P, _P, _ULL, _P],
    "otedama_x11_verify_chunk": [_P, _P, _ULL, _ULL, _I, _P, _U, _P, _P,
                                 _ULL, _P],
    "otedama_x11_stage": [_I, _P, _P, _P, _ULL, _I, _P, _P, _P, _ULL, _P],
    "otedama_x11_kernel_info": [_I] + [ctypes.POINTER(ctypes.c_int)] * 5,
}


def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library. Raises
    if the toolkit is missing or the build fails."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = cuda_build.build(SOURCE, HEADERS)
        build_info.update(info)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.otedama_x11_error_string.argtypes = [ctypes.c_int]
        lib.otedama_x11_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.otedama_x11_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


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


def _launch(what: str, device, stream, out, k: int, lanes: int, state,
            chunk_call) -> None:
    """The launch sequence of one search or verify call: the buffer's
    init, ``chunk_call(lib, first, n, tables, state, stride)`` for each
    chunk of ``chunk_plan(lanes)`` (the state word-major, ``stride`` lanes
    a word), the finalize."""
    lib = load_library()
    tables = device_tables(device)
    state = _state_for(state, lanes, device, stream)
    stride, s = state.numel() // 8, stream.cuda_stream
    with torch.cuda.device(device):
        _check(lib, lib.otedama_x11_begin(out.data_ptr(), k, s), what)
        for first, n in chunk_plan(lanes):
            _check(lib, chunk_call(lib, first, n, tables.data_ptr(),
                                   state.data_ptr(), stride), what)
        _check(lib, lib.otedama_x11_end(out.data_ptr(), k, s), what)


def x11_search(prefix76: bytes, base: int, last: int, limbs8, *, batch: int,
               k: int, device, cnt_order=None,
               stream: torch.cuda.Stream | None = None,
               out: torch.Tensor | None = None,
               state: torch.Tensor | None = None) -> torch.Tensor:
    """Search ``batch`` lanes from nonce word ``base`` (wrapping mod 2^32)
    in ONE launch of B6; lanes past offset ``last`` (-1: none) take no
    part. Returns the ``uint32[2k+3]`` winner buffer (lane offsets) as an
    int32 tensor on ``device``. ``cnt_order``: the shavite counter order
    (default: the active variant of the port's host tier).

    On a CUDA device the kernels run on ``stream`` (default: the device's
    current stream) into ``out`` (default: a new tensor), through
    ``state`` (``state_words(batch)`` int64 words; default: allocated for
    this call), and nothing waits for them. On the CPU the plain version
    computes the same buffer."""
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
    _launch("x11_search", device, stream, out, k, lanes, state,
            lambda lib, first, n, tables, st, stride:
            lib.otedama_x11_search_chunk(
                job.ctypes.data, first, n, k, out.data_ptr(), tables, st,
                stride, stream.cuda_stream))
    search_launches.add()
    return out


def x11_verify(words20: torch.Tensor, limbs: torch.Tensor, count: int, *,
               k: int, cnt_order=None,
               stream: torch.cuda.Stream | None = None,
               out: torch.Tensor | None = None,
               state: torch.Tensor | None = None) -> torch.Tensor:
    """Validate the first ``count`` shares in ONE launch of B6's verify
    kernels: ``words20`` int32 ``[B, 20]`` (each header's big-endian
    words), ``limbs`` int32 ``[B, 8]`` (each share's target limbs,
    most-significant-first). Returns the ``uint32[2k+3]`` failure buffer
    (failing lane offsets in lane order, their top limbs, the true failure
    count — past ``k`` an overflow — and the min top limb) as an int32
    tensor on the inputs' device.

    Given CPU tensors it runs the plain version. Given CUDA tensors
    (contiguous int32) it launches on ``stream`` (default: the current
    stream) into ``out`` (default: a new tensor) through ``state`` (as for
    ``x11_search``) without synchronizing, or raises."""
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
    packed = pack_cnt_order(order)
    _launch("x11_verify", device, stream, out, k, count, state,
            lambda lib, first, n, tables, st, stride:
            lib.otedama_x11_verify_chunk(
                words20.data_ptr(), limbs.data_ptr(), first, n, k,
                out.data_ptr(), packed, tables, st, stride,
                stream.cuda_stream))
    verify_launches.add()
    return out


# -- the stages one by one: times and resources -----------------------------------

# the chain's stages in the order of csrc/x11.cu (stage S = 1..11; the
# counting build's X11_COUNT = S; 0 is the frame alone)
STAGES = ("blake512", "bmw512", "groestl512", "skein512", "jh512",
          "keccak512", "luffa512", "cubehash512", "shavite512", "simd512",
          "echo512")
# the kernels by stage number (csrc/x11.cu stage_fn): 12 and 13 are the
# verify's first and last
KERNELS = ("blake_search_kernel", "stage_kernel<2> (bmw)", "groestl_kernel",
           "stage_kernel<4> (skein)", "stage_kernel<5> (jh)",
           "stage_kernel<6> (keccak)", "stage_kernel<7> (luffa)",
           "stage_kernel<8> (cubehash)", "shavite_kernel", "simd_kernel",
           "echo_kernel<false>", "blake_verify_kernel", "echo_kernel<true>")


def kernel_info(device) -> list[dict]:
    """Each B6 kernel's resources on ``device``, from the CUDA runtime:
    threads a block, registers a thread, local memory a thread (stack
    and spills; 0 for none), shared memory a block, resident blocks and
    warps an SM."""
    lib = load_library()
    out = []
    with torch.cuda.device(device):
        for stage, name in enumerate(KERNELS, 1):
            v = [ctypes.c_int() for _ in range(5)]
            _check(lib, lib.otedama_x11_kernel_info(
                stage, *(ctypes.byref(x) for x in v)), name)
            threads, regs, local, smem, blocks = (x.value for x in v)
            out.append({"kernel": name, "threads": threads,
                        "registers": regs, "local_bytes": local,
                        "smem_bytes": smem, "blocks_per_sm": blocks,
                        "warps_per_sm": blocks * threads // 32})
    return out


def stage_times(device, lanes: int, reps: int = 3, rounds: int = 3,
                stream: torch.cuda.Stream | None = None) -> dict[str, list[float]]:
    """Each stage's kernel alone over the chunks of a ``lanes``-lane
    search (as the chain runs it: the chunk's values in a state buffer),
    in ms a launch of ``lanes`` lanes: ``rounds`` medians-to-be
    of ``reps`` launches each (CUDA events), after a warm-up. The values
    are whatever the stages make of the buffer; the times do not depend
    on them."""
    device = torch.device(device)
    if stream is None:
        stream = torch.cuda.current_stream(device)
    lib = load_library()
    tables = device_tables(device)
    state = _state_for(None, lanes, device, stream)
    stride = state.numel() // 8
    out = torch.zeros(winner_buffer_words(16), dtype=torch.int32,
                      device=device)
    job = pack_job(bytes(76), 0, [0] * 8, x11_torch.cnt_variant_order())
    plan = chunk_plan(lanes)
    times = {}
    with torch.cuda.device(device):
        _check(lib, lib.otedama_x11_stage(1, job.ctypes.data, None, None,
                                          plan[0][1], 16, out.data_ptr(),
                                          tables.data_ptr(), state.data_ptr(),
                                          stride, stream.cuda_stream), "stage 1")
        for stage, name in enumerate(STAGES, 1):
            def once():
                for _, n in plan:
                    _check(lib, lib.otedama_x11_stage(
                        stage, job.ctypes.data, None, None, n, 16,
                        out.data_ptr(), tables.data_ptr(), state.data_ptr(),
                        stride, stream.cuda_stream), name)
            once()
            per = []
            for _ in range(rounds):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record(stream)
                for _ in range(reps):
                    once()
                e1.record(stream)
                e1.synchronize()
                per.append(e0.elapsed_time(e1) / reps)
            times[name] = per
    return times


# -- the bound ------------------------------------------------------------------

# 32-bit integer instructions an SM runs a clock, thread by thread: the
# ALU pipe (IADD3, LOP3, SHF, PRMT, ...) and the FMA pipe (IMAD in all its
# forms) take 64 each, 128 together
ALU_LANES_PER_SM = 64
INT_LANES_PER_SM = 128
# shared-memory words an SM reads a clock: 32 banks of 4 bytes
SMEM_WORDS_PER_SM = 32

# the instructions a lane of the first B6 (the whole chain one kernel)
# executed, from the SASS of its counting build (chip_smoke.py phase 33
# on an NVIDIA H100 80GB HBM3): the bound takes the smaller of this and
# the current design's count (``bound_chain``), so that a design can
# lower the bound but never raise it
ONE_KERNEL_CHAIN = {"total": 135688, "alu": 97208, "fma": 21344,
              "smem_words": 17521}


def _lds_words(op: str) -> int:
    """32-bit words one lane reads in a shared-memory load (LDS, LDS.64,
    LDS.128, LDS.U8, ...)."""
    return 4 if ".128" in op else 2 if ".64" in op else 1


# the stages whose round loop the counting build may leave rolled (LLVM
# does not unroll a loop whose unrolled body passes its size threshold,
# even under a pragma; it may unroll it partly): the rounds and the
# shared-memory words a round reads, so that the loop's body, a whole
# number of rounds, is counted once for each time it runs
ROLLED_ROUNDS = {11: (10, 512)}     # echo512: 10 rounds of 512 lookups


def _counts(code) -> dict:
    counts = cuda_build.pipe_counts(code)
    counts["smem_words"] = sum(_lds_words(op) for _, op, _ in code
                               if op.startswith("LDS"))
    return counts


def _stage_counts(stage: int) -> dict:
    info = cuda_build.cubin(SOURCE, HEADERS, (f"X11_COUNT={stage}",))
    code = cuda_build.sass_functions(info["library"], "x11_count_kernel")
    (fn, code), = code.items()
    loop = cuda_build.hot_loop(code)
    trips = 1
    if loop and stage in ROLLED_ROUNDS:
        rounds, words = ROLLED_ROUNDS[stage]
        per_trip, odd = divmod(_counts(loop)["smem_words"], words)
        if per_trip < 1 or odd or rounds % per_trip:
            raise RuntimeError(f"stage {stage}'s rolled loop reads "
                               f"{_counts(loop)['smem_words']} shared words, "
                               f"not a whole number of its rounds")
        trips = rounds // per_trip
    rest = [c for c in code if c not in loop]
    left = cuda_build.hot_loop(rest) if trips > 1 else loop
    if left:
        raise RuntimeError(
            f"the counting build of stage {stage} still has a loop of "
            f"{len(left)} instructions at {left[0][0]:#x} (its SASS is not "
            f"what a lane executes): {[op for _, op, _ in left[:24]]}")
    counts = _counts(code)
    if trips > 1:
        body = _counts(loop)
        counts = {k: counts[k] + (trips - 1) * body[k] for k in counts}
    counts["seconds"] = info.get("seconds", 0.0)
    return counts


def chain_instructions() -> dict[str, dict]:
    """The instructions one lane of B6 executes in each stage of the chain,
    from the SASS of ``csrc/x11.cu``'s counting build (``-DX11_COUNT=S``:
    stage S alone, every round loop unrolled but those of
    ``ROLLED_ROUNDS``, whose body counts once a trip; the twelve builds
    run at once): by pipe (``alu``, ``fma``), in all (``total``), and the
    shared-memory words its table lookups read (``smem_words``), each
    less the frame's (stage 0: the load and store around the stage; simd's
    count is one thread's of its group of ``SIMD_GROUP``, times the
    group), and its build's ``seconds``. ``"chain"`` holds the sums (its
    ``seconds``: the frame's build). Needs ``nvcc`` and ``cuobjdump``, not
    a card."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(len(STAGES) + 1) as pool:
        counts = list(pool.map(_stage_counts, range(len(STAGES) + 1)))
    frame, keys = counts[0], ("total", "alu", "fma", "smem_words")
    out = {name: {k: (c[k] - frame[k]) * (SIMD_GROUP if name == "simd512"
                                          else 1) for k in keys}
           for name, c in zip(STAGES, counts[1:])}
    out["chain"] = {k: sum(out[name][k] for name in STAGES) for k in keys}
    for name, c in zip(("frame", *STAGES), counts):
        out.get(name, out["chain"])["seconds"] = c["seconds"]
    return out


def bound_chain(chain: dict) -> tuple[dict, str]:
    """The instruction counts the bound takes: the smaller (ALU and FMA
    pipes together) of ``chain`` (``chain_instructions()["chain"]``) and
    ``ONE_KERNEL_CHAIN``, and which it was."""
    ops = chain["alu"] + chain["fma"]
    if ops <= ONE_KERNEL_CHAIN["alu"] + ONE_KERNEL_CHAIN["fma"]:
        return chain, "this design's counting build"
    return ONE_KERNEL_CHAIN, "the one-kernel design's counting build (smaller than this design's)"


def bound_ms(lanes: int, sms: int, clock_mhz: float, chain: dict,
             verify: bool = False,
             hbm_bytes_per_s: float = 3.35e12) -> dict[str, float]:
    """The least times the card could take for ``lanes`` lanes of B6, in
    ms, by what could bound it, given ``chain`` (``bound_chain(...)[0]``):
    the integer instructions over both integer pipes (``"operations"``,
    as the bounds of B1 to B5 count them: the compiler's split between
    the pipes is not the work's); the table reads over the shared-memory
    banks (``"shared-memory reads"``); the bytes read once over the
    memory's rate (``"bytes"``: a verify row's 80 header and 32 limb
    bytes; a search reads none a lane). Beside them, not a bound: the ALU
    pipe alone at the compiler's split (``"ALU pipe as compiled"``)."""
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
