"""Kernels B7a-B7c, ethash on the card: build, binding and wrappers.

``csrc/ethash.cu`` replaces the device tier that the JAX package runs
through XLA (``otedama_tpu/kernels/ethash.py``; there is no Pallas kernel
for ethash): B7a ``build_dag`` for ``build_dataset_device``, B7b
``ethash_search`` (full and light) for ``hashimoto_winners_device``, B7c
``ethash_verify`` for ``hashimoto_verify_device``. It is built at first
use by ``cuda_build`` (nvcc for ``sm_90a``, a shared library with plain C
entry points loaded through ``ctypes``) and shares the winner-buffer code
of ``sha256_device.cuh`` with B1, B2 and B6.

The epoch's state lives on the card as int32 tensors: the cache ``[rows,
16]`` (uploaded from the host generator's numpy array by
``cache_tensor``) and the DAG's pages ``[n_pages, 32]`` (built there by
B7a; item-major ``[n_items, 16]`` is the same memory). ``epoch_tensors``
carries a numpy epoch (the reference's ``[rows, 16]`` cache and ``[n_items,
16]`` DAG, uint32) onto a device, as the tests do with the reference's
native-built cache.

B7a, B7b light and B7c share one item core (a quad of threads derives
four items; B7b light and B7c hash with two threads a nonce or share);
their run-time moduli ``% rows`` and ``% n_pages`` are a multiply-high by
a magic number that the C entry points make. ``l2_probe`` times the L2's
rate for the rows that core reads, ``chase_probe`` the latency of one
dependent row read, B7c's step (measurements, on no path).

Each wrapper launches on a CUDA stream without synchronizing and returns
its device result (the search and verify: the ``uint32[2k+3]`` buffer as
an int32 tensor, lane offsets in its first k words; the DAG build: the
pages). Given the CPU they run the plain versions (``ethash_torch``);
given CUDA they launch the kernels or raise — they never fall back. Each
call of a wrapper on the card is one launch in its counter.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from otedama_tpu_torch.kernels import LaunchCounter, cuda_build
from otedama_tpu_torch.kernels import ethash as eth
from otedama_tpu_torch.kernels import ethash_torch
from otedama_tpu_torch.kernels.sha256_cuda import winner_buffer_words

M32 = 0xFFFFFFFF

SOURCE = "ethash.cu"
HEADERS = ("sha256_device.cuh",)
THREADS = 128           # csrc/ethash.cu kThreads, every kernel
JOB_WORDS = 17          # the header hash's 8 words, the base, 8 limbs

# B7 launches through the wrappers (not the plain versions' calls)
dag_launches = LaunchCounter()           # B7a
search_full_launches = LaunchCounter()   # B7b, full tier
search_light_launches = LaunchCounter()  # B7b, light tier
verify_launches = LaunchCounter()        # B7c

# the kernels by number (csrc/ethash.cu kernel_fn), then the L2 probe
KERNELS = ("dag_kernel", "search_full_kernel", "search_light_kernel",
           "verify_kernel")
PROBE_KERNEL = "l2_probe_kernel"

_lib = None
_lib_lock = threading.Lock()
build_info: dict = {}

_P, _U, _ULL, _I = ctypes.c_void_p, ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_int
_SIGNATURES = {
    "otedama_ethash_dag": [_P, _U, _ULL, _ULL, _P, _P],
    "otedama_ethash_search": [_P, _I, _P, _U, _U, _ULL, _I, _P, _P],
    "otedama_ethash_verify": [_P, _P, _P, _ULL, _P, _U, _U, _I, _P, _P],
    "otedama_ethash_l2_probe": [_P, _U, _U, _U, _P, _P],
    "otedama_ethash_chase_probe": [_P, _U, _U, _P, _P],
    "otedama_ethash_kernel_info": [_I] + [ctypes.POINTER(ctypes.c_int)] * 4,
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
        lib.otedama_ethash_error_string.argtypes = [ctypes.c_int]
        lib.otedama_ethash_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.otedama_ethash_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# -- the epoch's state on a device ------------------------------------------------

def _as_int32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.require(a, np.uint32, ["C", "W"])
                            .view(np.int32))


def cache_tensor(cache: np.ndarray, device) -> torch.Tensor:
    """The epoch cache ``[rows, 16]`` (uint32) as an int32 tensor on
    ``device``: the card's layout (16-byte rows, as B7 reads them)."""
    return _as_int32(cache).to(torch.device(device))


def epoch_tensors(cache: np.ndarray, device, dag: np.ndarray | None = None):
    """A numpy epoch on ``device``: the cache ``[rows, 16]`` and, when
    given, the DAG ``[n_items, 16]`` (uint32) as its pages ``[n_pages,
    32]`` — int32 tensors, the layouts the kernels and the plain versions
    take. Returns (cache, pages or None)."""
    pages = None if dag is None else _as_int32(dag).reshape(-1, 32).to(
        torch.device(device))
    return cache_tensor(cache, device), pages


def _check_source(name: str, t: torch.Tensor, words: int, device) -> None:
    if (t.device != device or t.dtype != torch.int32 or not t.is_contiguous()
            or t.dim() != 2 or t.shape[1] != words or t.data_ptr() % 16):
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"int32 [N, {words}] tensor on {device} (got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device})")


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the ethash kernels run on cuda or cpu, not {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


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


# -- B7a: the DAG -------------------------------------------------------------------

def build_dag(cache: torch.Tensor, full_size: int, *,
              stream: torch.cuda.Stream | None = None,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """The epoch's DAG from its cache: ``[n_pages, 32]`` (int32 on the
    card; page p is items 2p and 2p + 1). On a CUDA device ONE launch of
    B7a (a quad of threads four items) on ``stream`` (default: the
    current stream) into ``out`` (default: a new tensor, allocated on that
    stream), not waited for. On the CPU the plain version (int64 words)."""
    n_items = full_size // eth.HASH_BYTES
    if cache.device.type == "cpu":
        return ethash_torch.build_dataset(cache, full_size).reshape(-1, 32)
    device = _card(cache.device)
    _check_source("cache", cache, 16, device)
    if stream is None:
        stream = torch.cuda.current_stream(device)
    if out is None:
        with torch.cuda.stream(stream):
            out = torch.empty(n_items // 2, 32, dtype=torch.int32,
                              device=device)
    _check_source("out", out, 32, device)
    if out.numel() != n_items * 16:
        raise ValueError(f"out holds {out.numel()} words, the DAG {n_items * 16}")
    lib = load_library()
    with torch.cuda.device(device):
        _check(lib, lib.otedama_ethash_dag(
            cache.data_ptr(), cache.shape[0], 0, n_items, out.data_ptr(),
            stream.cuda_stream), "ethash_dag")
    dag_launches.add()
    return out


# -- B7b: the search ------------------------------------------------------------------

def pack_job(header_hash: bytes, base: int, limbs8) -> np.ndarray:
    if len(header_hash) != 32:
        raise ValueError(f"need a 32-byte header hash, got {len(header_hash)}")
    out = np.zeros((JOB_WORDS,), dtype=np.uint32)
    out[:8] = np.frombuffer(header_hash, dtype="<u4")
    out[8] = base & M32
    out[9:17] = np.asarray(limbs8, dtype=np.uint64).astype(np.uint32)
    return out


def ethash_search(full_size: int, source: torch.Tensor, header_hash: bytes,
                  base: int, last: int, limbs8, *, batch: int, k: int,
                  full: bool, stream: torch.cuda.Stream | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Search ``batch`` lanes from nonce ``base`` (mod 2^32) in ONE launch
    of B7b: ``full`` reads pages from the DAG ``source`` (``[n_pages,
    32]``), else derives them from the cache ``source`` (``[rows, 16]``;
    two threads a lane, a quad two lanes);
    lanes past offset ``last`` (-1: none) take no part. Returns the
    ``uint32[2k+3]`` winner buffer (lane offsets) as an int32 tensor.

    On a CUDA device the kernels run on ``stream`` (default: the current
    stream) into ``out`` (default: a new tensor), not waited for. On the
    CPU the plain version computes the same buffer."""
    if not 0 <= batch < 1 << 32:
        raise ValueError(f"batch {batch} outside [0, 2^32)")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    lanes = max(0, min(batch, last + 1))
    if source.device.type == "cpu":
        return ethash_torch.winner_step(full_size, source, header_hash, base,
                                        lanes, limbs8, lanes, k, full=full)
    device = _card(source.device)
    _check_source("the DAG" if full else "cache", source, 32 if full else 16,
                  device)
    n_pages = full_size // eth.MIX_BYTES
    if full and source.shape[0] != n_pages:
        raise ValueError(f"the DAG has {source.shape[0]} pages, the epoch "
                         f"{n_pages}")
    if stream is None:
        stream = torch.cuda.current_stream(device)
    out = _out_for(k, device, stream, out)
    job = pack_job(header_hash, base, limbs8)
    rows = 0 if full else source.shape[0]
    lib = load_library()
    with torch.cuda.device(device):
        _check(lib, lib.otedama_ethash_search(
            job.ctypes.data, int(full), source.data_ptr(), rows, n_pages,
            lanes, k, out.data_ptr(), stream.cuda_stream), "ethash_search")
    (search_full_launches if full else search_light_launches).add()
    return out


# -- B7c: share validation -----------------------------------------------------------

def share_rows(header_hashes: np.ndarray, nonces) -> tuple[np.ndarray, np.ndarray]:
    """``[N, 32]`` uint8 header hashes and N nonces as the verify's rows:
    ``[N, 8]`` little-endian hash words and ``[N, 2]`` nonce words (the
    64-bit LE nonce), uint32."""
    hh = np.ascontiguousarray(header_hashes, dtype=np.uint8).reshape(-1, 32)
    nn = np.asarray(nonces, dtype=np.uint64).reshape(-1).astype("<u8")
    return (hh.view("<u4").astype(np.uint32),
            nn.view("<u4").reshape(-1, 2).astype(np.uint32))


def ethash_verify(full_size: int, cache: torch.Tensor, hh: torch.Tensor,
                  nonces: torch.Tensor, limbs: torch.Tensor, count: int, *,
                  k: int, stream: torch.cuda.Stream | None = None,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Validate the first ``count`` shares in ONE launch of B7c (two
    threads a share): ``hh`` int32 ``[N, 8]`` (header-hash words),
    ``nonces`` int32 ``[N, 2]`` (``share_rows``: the 64-bit nonce),
    ``limbs`` int32 ``[N, 8]`` (each share's target, most-significant
    first), against the epoch ``cache``; no row past ``count`` is read. Returns the
    ``uint32[2k+3]`` failure buffer (row offsets, their top limbs, the
    count — past ``k`` an overflow — and the min top limb over the
    ``count`` rows) as an int32 tensor.

    Given CPU tensors it runs the plain version. Given CUDA tensors it
    launches on ``stream`` (default: the current stream) into ``out``
    without synchronizing, or raises."""
    n = hh.shape[0]
    if not 0 <= count <= n or nonces.shape != (n, 2) or limbs.shape != (n, 8):
        raise ValueError(f"count {count} of {n} rows; nonces "
                         f"{tuple(nonces.shape)}, limbs {tuple(limbs.shape)}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if cache.device.type == "cpu":
        nw = nonces.to(torch.int64) & M32
        buf = ethash_torch.verify_step(full_size, cache, hh, nw[:, 0]
                                       | (nw[:, 1] << 32), limbs, count, k)
        return buf if out is None else out.copy_(buf)
    device = _card(cache.device)
    _check_source("cache", cache, 16, device)
    for name, x in (("hh", hh), ("nonces", nonces), ("limbs", limbs)):
        if (x.device != device or x.dtype != torch.int32
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor on "
                             f"{device}")
    if stream is None:
        stream = torch.cuda.current_stream(device)
    out = _out_for(k, device, stream, out)
    lib = load_library()
    with torch.cuda.device(device):
        _check(lib, lib.otedama_ethash_verify(
            hh.data_ptr(), nonces.data_ptr(), limbs.data_ptr(), count,
            cache.data_ptr(), cache.shape[0], full_size // eth.MIX_BYTES, k,
            out.data_ptr(), stream.cuda_stream), "ethash_verify")
    verify_launches.add()
    return out


# -- the L2 probe --------------------------------------------------------------------

PROBE_ROW_BITS = 18     # the probe's buffer: 2^18 rows of 64 bytes, 16 MiB


def l2_probe(buf: torch.Tensor, blocks: int, steps: int, *,
             stream: torch.cuda.Stream | None = None,
             sink: torch.Tensor | None = None) -> int:
    """One launch of the L2 probe (``csrc/ethash.cu`` ``l2_probe_kernel``,
    on no path: a measurement) on ``stream``, not waited for: ``blocks``
    blocks of 128 threads, each quad reading 4 x ``steps`` random 64-byte
    rows of ``buf`` (int32 ``[2^PROBE_ROW_BITS, 16]`` on the card) a
    quarter a thread, as B7a's and B7b light's item core reads the cache.
    Returns the bytes it reads."""
    device = _card(buf.device)
    _check_source("buf", buf, 16, device)
    if buf.shape[0] != 1 << PROBE_ROW_BITS:
        raise ValueError(f"the probe reads 2^{PROBE_ROW_BITS} rows, not "
                         f"{buf.shape[0]}")
    if stream is None:
        stream = torch.cuda.current_stream(device)
    if sink is None or sink.numel() < blocks * THREADS:
        with torch.cuda.stream(stream):
            sink = torch.empty(blocks * THREADS, dtype=torch.int32,
                               device=device)
    lib = load_library()
    with torch.cuda.device(device):
        _check(lib, lib.otedama_ethash_l2_probe(
            buf.data_ptr(), PROBE_ROW_BITS, blocks, steps, sink.data_ptr(),
            stream.cuda_stream), "ethash_l2_probe")
    return probe_bytes(blocks, steps)


CHASE_STEPS = 16_384    # a share's dependent row reads: 64 accesses x 256


def chase_probe(cache: torch.Tensor, steps: int = CHASE_STEPS, *,
                stream: torch.cuda.Stream | None = None,
                sink: torch.Tensor | None = None) -> None:
    """One launch of the chase probe (``csrc/ethash.cu``
    ``chase_probe_kernel``, on no path: a measurement) on ``stream``, not
    waited for: one warp whose quads each walk ``steps`` (a multiple of
    16) dependent rows of the epoch ``cache`` (int32 ``[rows, 16]`` on the
    card), each row picked by fastmod of a word of the row before, as
    B7c's item core steps. Its time over ``steps`` is a dependent row
    read's."""
    device = _card(cache.device)
    _check_source("cache", cache, 16, device)
    if steps % 16 or cache.shape[0] < 8:
        raise ValueError(f"steps {steps} must be a multiple of 16, the "
                         f"cache at least 8 rows (got {cache.shape[0]})")
    if stream is None:
        stream = torch.cuda.current_stream(device)
    if sink is None:
        with torch.cuda.stream(stream):
            sink = torch.empty(32, dtype=torch.int32, device=device)
    lib = load_library()
    with torch.cuda.device(device):
        _check(lib, lib.otedama_ethash_chase_probe(
            cache.data_ptr(), cache.shape[0], steps, sink.data_ptr(),
            stream.cuda_stream), "ethash_chase_probe")


def probe_bytes(blocks: int, steps: int) -> int:
    """The bytes one launch of ``blocks`` probe blocks of ``steps`` steps
    reads."""
    return blocks * THREADS // 4 * 4 * steps * eth.HASH_BYTES


def row_bytes(kind: str, lanes: int) -> int:
    """The cache-row bytes that ``lanes`` lanes of ``kind`` read through
    L2, whatever the roofline counts: 256 rows of 64 bytes an item, an
    item a lane of ``dag``, 128 items a hash of ``light`` (2 MiB)."""
    items = {"dag": 1, "light": 2 * eth.ACCESSES}[kind] * lanes
    return items * eth.DATASET_PARENTS * eth.HASH_BYTES


# -- resources, instructions, bounds ----------------------------------------------------

def kernel_info(device, kernels=KERNELS) -> list[dict]:
    """Each of ``kernels`` (by name: the B7 kernels, or ``PROBE_KERNEL``)
    on ``device``, from the CUDA runtime: threads a block, registers a
    thread, local memory a thread (stack and spills; 0 for none), resident
    blocks and warps an SM."""
    lib = load_library()
    out = []
    with torch.cuda.device(device):
        for name in kernels:
            v = [ctypes.c_int() for _ in range(4)]
            _check(lib, lib.otedama_ethash_kernel_info(
                (KERNELS + (PROBE_KERNEL,)).index(name) + 1,
                *(ctypes.byref(x) for x in v)), name)
            threads, regs, local, blocks = (x.value for x in v)
            out.append({"kernel": name, "threads": threads, "registers": regs,
                        "local_bytes": local, "blocks_per_sm": blocks,
                        "warps_per_sm": blocks * threads // 32})
    return out


# the counting build's kernels: (key, kernel)
COUNTED = (("item", "dag_kernel"), ("full", "search_full_kernel"),
           ("light1", "light1_count_kernel"), ("light2", "light2_count_kernel"))

# the integer instructions (ALU and FMA pipes) an item of the first B7
# design's one-thread item core executed (a thread an item, `%` by a
# run-time divisor), from the SASS of its counting build on an NVIDIA H100
# 80GB HBM3: the bounds of B7a, B7b light and B7c take the smaller of this
# and the quad core's count (``lane_ops``), as B6's take
# ``x11_cuda.ONE_KERNEL_CHAIN``, so that a design can lower a bound but
# never raise it
ONE_THREAD_ITEM = 19_809


def instruction_counts() -> dict[str, dict]:
    """The instructions a thread executes, by pipe, from the SASS of
    ``csrc/ethash.cu``'s counting build (``-DETHASH_COUNT``: every loop
    unrolled, each kernel straight-line code, frame included): ``"item"``
    a thread of B7a (an item: a quad derives four), ``"full"`` a thread of
    the full search (a hash), ``"light1"`` and ``"light2"`` a thread of
    B7b light and B7c (half a hash) with one and with two accesses; and
    the build's ``seconds``.
    Needs ``nvcc`` and ``cuobjdump``, not a card. Raises if a loop is
    left."""
    info = cuda_build.cubin(SOURCE, HEADERS, ("ETHASH_COUNT",))
    out = {"seconds": info.get("seconds", 0.0)}
    for key, kernel in COUNTED:
        (fn, code), = cuda_build.sass_functions(info["library"], kernel).items()
        loop = cuda_build.hot_loop(code)
        if loop:
            raise RuntimeError(f"the counting build's {fn} still has a loop of "
                               f"{len(loop)} instructions")
        out[key] = cuda_build.pipe_counts(code)
    return out


# integer instructions an SM runs a clock, thread by thread (the ALU and
# FMA pipes, 64 each), as the bounds of B1-B6 count them
INT_LANES_PER_SM = 128


def lane_ops(counts: dict, kind: str) -> tuple[int, str]:
    """Integer instructions (ALU and FMA pipes) a lane of ``kind`` runs,
    and whose count it is: ``full`` a hash of the full tier; ``dag`` an
    item; ``light`` and ``verify`` a light hash (B7b light and B7c run one
    core). ``dag`` and the light hash take the smaller of the quad core's
    count (``item``; two threads' ``light1`` and 63 more accesses, the
    difference of ``light2`` and ``light1``) and the one-thread core's
    (``ONE_THREAD_ITEM`` an item; a light hash the full tier's hash, its
    access loop, seed and seal, plus 128 items), as B6's bound takes the
    smaller of its two designs' (``x11_cuda.bound_chain``)."""
    ops = {key: c["alu"] + c["fma"] for key, c in counts.items()
           if isinstance(c, dict)}
    if kind == "full":
        return ops["full"], "the full tier's counting build"
    kind = "light" if kind == "verify" else kind
    one = {"dag": ONE_THREAD_ITEM,
           "light": ops["full"] + 2 * eth.ACCESSES * ONE_THREAD_ITEM}[kind]
    access = ops["light2"] - ops["light1"]
    quad = {"dag": ops["item"],
            "light": 2 * (ops["light1"] + (eth.ACCESSES - 1) * access)}[kind]
    if quad <= one:
        return quad, "the quad core's counting build"
    return one, ("the one-thread core's count (ONE_THREAD_ITEM, smaller "
                 "than the quad core's)")


def bound_ms(kind: str, lanes: int, counts: dict, *, sms: int,
             clock_mhz: float, rows: int, full_size: int,
             hbm_bytes_per_s: float = 3.35e12) -> dict[str, float]:
    """The least times the card could take for ``lanes`` lanes of
    ``kind`` (``dag``: items), in ms: ``operations`` (``lane_ops`` over
    the SMs' integer pipes at ``clock_mhz``) and ``bytes`` over the device
    memory's rate: the cache read once and the DAG written once (``dag``);
    8,192 bytes a hash (``full``: the 1 GiB DAG does not fit the card's
    50 MB L2, so each of a hash's 64 pages comes from device memory); the
    cache read once (``light``), and each share's 72 bytes (``verify``)."""
    ops = lanes * lane_ops(counts, kind)[0]
    cache_bytes = rows * eth.HASH_BYTES
    nbytes = {"dag": cache_bytes + full_size,
              "full": lanes * eth.ACCESSES * eth.MIX_BYTES,
              "light": cache_bytes,
              "verify": cache_bytes + 72 * lanes}[kind]
    return {"operations": ops / (sms * INT_LANES_PER_SM * clock_mhz * 1e6) * 1e3,
            "bytes": nbytes / hbm_bytes_per_s * 1e3}
